"""User-facing oscillator graph (port of ``synthesizer_tpu.oscillators``).

Every oscillator/filter is an object whose ``blocks()`` method yields
fixed-size blocks of float samples, and modulators/filters wrap other
oscillators, so a patch is a DAG.  These classes are thin declarative
shells: constructing one just builds a ``models.spec`` node, and
``blocks()`` / ``render()`` lower the whole patch DAG (``models.graph``)
and render it block by block on the device: the card unless the caller
passes ``device="cpu"``.

The ``Fast*`` variants exist in the reference because its modulatable path
was slow; here the no-modulation case automatically uses closed-form phase,
so they are exact aliases kept for API compatibility.

Blocks are numpy float32 arrays (the reference yielded Python lists; arrays
are a strict superset for every documented use).
"""

from __future__ import annotations

from typing import Iterator, Optional, Sequence, Tuple

import numpy as np

from . import params
from .models import graph as G
from .models import spec as S

__all__ = [
    "Oscillator", "Sine", "Triangle", "Square", "SquareH", "Sawtooth",
    "SawtoothH", "Pulse", "Harmonics", "WhiteNoise", "Linear", "Semicircle",
    "Pointy", "BandlimitedSawtooth", "BandlimitedSquare", "Wavetable",
    "Pluck", "UserOscillator",
    "FastSine", "FastTriangle", "FastSquare", "FastSawtooth",
    "FastPulse", "FastSemicircle", "FastPointy", "EnvelopeFilter",
    "MixingFilter", "AmpModulationFilter", "DelayFilter", "EchoFilter",
    "ClipFilter", "AbsFilter", "NullFilter",
    "LowpassFilter", "HighpassFilter", "BandpassFilter",
]


class Oscillator:
    """Base: a declarative patch node bound to a samplerate."""

    def __init__(self, spec_node: S.Node, samplerate: int):
        self.spec = spec_node
        self.samplerate = int(samplerate)

    def blocks(self, blocksize: Optional[int] = None,
               device="cuda") -> Iterator[np.ndarray]:
        """Yield successive float32 blocks of samples (endless)."""
        bs = blocksize or params.norm_osc_blocksize
        yield from G.block_stream(self.spec, self.samplerate, bs,
                                  device=device)

    def render(self, nsamples: int, blocksize: int = 8192, device="cuda"):
        """Render the first ``nsamples`` on ``device`` -> f32 tensor."""
        return G.render_patch(self.spec, nsamples, self.samplerate, blocksize,
                              device)

    # Sample.modulate_amp / Sample.pan(lfo=...) hook
    def gains(self, nsamples: int, device="cuda"):
        return self.render(nsamples, device=device)

    @property
    def duration(self) -> Optional[float]:
        """Finite length in seconds if the patch self-terminates, else None."""
        end = _end_time(self.spec)
        return end

    def __iter__(self):
        return self.blocks()


def _end_time(node: S.Node) -> Optional[float]:
    if isinstance(node, S.Envelope):
        if node.stop_at_end:
            return node.end_time
        return _end_time(node.source)
    for attr in ("source",):
        if hasattr(node, attr):
            return _end_time(getattr(node, attr))
    if isinstance(node, S.Mix):
        ends = [_end_time(s) for s in node.sources]
        ends = [e for e in ends if e is not None]
        return max(ends) if ends else None
    return None


def _sr(samplerate: Optional[int]) -> int:
    return samplerate or params.norm_samplerate


def _child(osc) -> Optional[S.Node]:
    if osc is None:
        return None
    if isinstance(osc, Oscillator):
        return osc.spec
    return osc  # already a spec node


# ---------------------------------------------------------------------------
# Waveform oscillators
# ---------------------------------------------------------------------------

class Sine(Oscillator):
    def __init__(self, frequency: float, amplitude: float = 1.0, phase: float = 0.0,
                 bias: float = 0.0, fm_lfo: Optional[Oscillator] = None,
                 samplerate: Optional[int] = None):
        super().__init__(S.Osc("sine", frequency, amplitude, phase, bias,
                               fm_lfo=_child(fm_lfo)), _sr(samplerate))


class Triangle(Oscillator):
    def __init__(self, frequency: float, amplitude: float = 1.0, phase: float = 0.0,
                 bias: float = 0.0, fm_lfo: Optional[Oscillator] = None,
                 samplerate: Optional[int] = None):
        super().__init__(S.Osc("triangle", frequency, amplitude, phase, bias,
                               fm_lfo=_child(fm_lfo)), _sr(samplerate))


class Square(Oscillator):
    def __init__(self, frequency: float, amplitude: float = 1.0, phase: float = 0.0,
                 bias: float = 0.0, fm_lfo: Optional[Oscillator] = None,
                 samplerate: Optional[int] = None):
        super().__init__(S.Osc("square", frequency, amplitude, phase, bias,
                               fm_lfo=_child(fm_lfo)), _sr(samplerate))


class Sawtooth(Oscillator):
    def __init__(self, frequency: float, amplitude: float = 1.0, phase: float = 0.0,
                 bias: float = 0.0, fm_lfo: Optional[Oscillator] = None,
                 samplerate: Optional[int] = None):
        super().__init__(S.Osc("sawtooth", frequency, amplitude, phase, bias,
                               fm_lfo=_child(fm_lfo)), _sr(samplerate))


class SquareH(Oscillator):
    """Square from odd-harmonic additive synthesis (bandlimited-ish)."""
    def __init__(self, frequency: float, num_harmonics: int = 16,
                 amplitude: float = 1.0, phase: float = 0.0, bias: float = 0.0,
                 fm_lfo: Optional[Oscillator] = None,
                 samplerate: Optional[int] = None):
        super().__init__(S.Osc("square_h", frequency, amplitude, phase, bias,
                               fm_lfo=_child(fm_lfo), num_harmonics=num_harmonics),
                         _sr(samplerate))


class SawtoothH(Oscillator):
    """Sawtooth from harmonic additive synthesis."""
    def __init__(self, frequency: float, num_harmonics: int = 16,
                 amplitude: float = 1.0, phase: float = 0.0, bias: float = 0.0,
                 fm_lfo: Optional[Oscillator] = None,
                 samplerate: Optional[int] = None):
        super().__init__(S.Osc("sawtooth_h", frequency, amplitude, phase, bias,
                               fm_lfo=_child(fm_lfo), num_harmonics=num_harmonics),
                         _sr(samplerate))


class Pulse(Oscillator):
    """Pulse/PWM oscillator; ``pwm_lfo`` values (0..1) drive the duty cycle."""
    def __init__(self, frequency: float, amplitude: float = 1.0, phase: float = 0.0,
                 bias: float = 0.0, pulse_width: float = 0.1,
                 fm_lfo: Optional[Oscillator] = None,
                 pwm_lfo: Optional[Oscillator] = None,
                 samplerate: Optional[int] = None):
        super().__init__(S.Osc("pulse", frequency, amplitude, phase, bias,
                               fm_lfo=_child(fm_lfo), pwm_lfo=_child(pwm_lfo),
                               pulse_width=pulse_width), _sr(samplerate))


class Harmonics(Oscillator):
    """Arbitrary partial list: harmonics = [(ratio, amplitude), ...]."""
    def __init__(self, frequency: float,
                 harmonics: Sequence[Tuple[float, float]],
                 amplitude: float = 1.0, phase: float = 0.0, bias: float = 0.0,
                 fm_lfo: Optional[Oscillator] = None,
                 samplerate: Optional[int] = None):
        super().__init__(S.Osc("harmonics", frequency, amplitude, phase, bias,
                               fm_lfo=_child(fm_lfo),
                               harmonics=tuple((float(r), float(a)) for r, a in harmonics)),
                         _sr(samplerate))


class WhiteNoise(Oscillator):
    """Sample-and-hold white noise; a new random value ``frequency`` times/s."""
    def __init__(self, frequency: float = 0.0, amplitude: float = 1.0,
                 bias: float = 0.0, seed: int = 0,
                 samplerate: Optional[int] = None):
        sr = _sr(samplerate)
        super().__init__(S.Osc("white_noise", frequency or sr, amplitude,
                               0.0, bias, seed=seed), sr)


class Semicircle(Oscillator):
    def __init__(self, frequency: float, amplitude: float = 1.0, phase: float = 0.0,
                 bias: float = 0.0, fm_lfo: Optional[Oscillator] = None,
                 samplerate: Optional[int] = None):
        super().__init__(S.Osc("semicircle", frequency, amplitude, phase, bias,
                               fm_lfo=_child(fm_lfo)), _sr(samplerate))


class Pointy(Oscillator):
    """Cubed-triangle 'pointy' wave."""
    def __init__(self, frequency: float, amplitude: float = 1.0, phase: float = 0.0,
                 bias: float = 0.0, fm_lfo: Optional[Oscillator] = None,
                 samplerate: Optional[int] = None):
        super().__init__(S.Osc("pointy", frequency, amplitude, phase, bias,
                               fm_lfo=_child(fm_lfo)), _sr(samplerate))


class BandlimitedSawtooth(Oscillator):
    """polyBLEP-bandlimited sawtooth (aliasing-suppressed; no FM)."""
    def __init__(self, frequency: float, amplitude: float = 1.0, phase: float = 0.0,
                 bias: float = 0.0, samplerate: Optional[int] = None):
        super().__init__(S.Osc("sawtooth_bl", frequency, amplitude, phase, bias),
                         _sr(samplerate))


class BandlimitedSquare(Oscillator):
    """polyBLEP-bandlimited square (aliasing-suppressed; no FM)."""
    def __init__(self, frequency: float, amplitude: float = 1.0, phase: float = 0.0,
                 bias: float = 0.0, samplerate: Optional[int] = None):
        super().__init__(S.Osc("square_bl", frequency, amplitude, phase, bias),
                         _sr(samplerate))


class Wavetable(Oscillator):
    """Single-cycle wavetable oscillator (beyond-reference): the table is
    read at the DDS phase with linear interpolation + wraparound (a
    gather).  FM composes like any other waveform."""
    def __init__(self, frequency: float, table, amplitude: float = 1.0,
                 phase: float = 0.0, bias: float = 0.0,
                 fm_lfo: Optional[Oscillator] = None,
                 samplerate: Optional[int] = None):
        super().__init__(S.Osc("wavetable", frequency, amplitude, phase, bias,
                               fm_lfo=_child(fm_lfo),
                               table=tuple(float(v) for v in table)),
                         _sr(samplerate))


class Pluck(Oscillator):
    """Karplus-Strong plucked string, spectral form (beyond-reference):
    a seeded random excitation whose harmonics each decay at the KS
    averaging-loop rate cos(pi*k*f/sr) per period — the recirculating
    delay line evaluated closed-form, batched over harmonics instead of
    sequentially over samples (spec: goldref/spec.py docstring).
    ``damping`` scales the loop loss (>1 = more muted, <1 = longer ring);
    ``num_harmonics`` is the excitation's partial budget."""
    def __init__(self, frequency: float, amplitude: float = 1.0,
                 phase: float = 0.0, bias: float = 0.0,
                 num_harmonics: int = 24, seed: int = 0,
                 damping: float = 1.0,
                 samplerate: Optional[int] = None):
        super().__init__(S.Osc("pluck", frequency, amplitude, phase, bias,
                               num_harmonics=num_harmonics, seed=seed,
                               damping=damping),
                         _sr(samplerate))


class Linear(Oscillator):
    """Ramp LFO: start + n*increase, clipped to [min_value, max_value]."""
    def __init__(self, start: float, increase: float = 0.0,
                 min_value: float = -1.0e6, max_value: float = 1.0e6,
                 samplerate: Optional[int] = None):
        super().__init__(S.Linear(start, increase, min_value, max_value),
                         _sr(samplerate))


def _seq_pull(make_iter, replayable: bool):
    """Adapter: a block iterator -> pull(n0, nframes).  Sequential only
    (the classic generator contract); a fresh stream restarts via
    ``make_iter`` when the source is replayable (has .blocks())."""
    state = {"it": None, "pos": 0, "buf": np.zeros(0, np.float32),
             "done": False, "used": False}

    def pull(n0, nframes):
        if state["it"] is None:
            if state["used"] and not replayable:
                raise RuntimeError(
                    "iterator source already consumed — pass an object "
                    "with blocks() or a callable (n0, nframes) for "
                    "replayable/seekable user oscillators")
            state["it"] = make_iter()
            state["used"] = True
        if n0 != state["pos"]:
            if not replayable:
                raise RuntimeError(
                    "sequential user oscillator cannot seek (wanted frame "
                    f"{n0}, stream is at {state['pos']}) — pass a callable "
                    "(n0, nframes) for random access")
            # restart and skip forward (replayable source)
            state["it"] = make_iter()
            state["pos"] = 0
            state["buf"] = np.zeros(0, np.float32)
            state["done"] = False
            while state["pos"] < n0:
                skip = pull(state["pos"], min(nframes, n0 - state["pos"]))
                if skip is None or len(skip) < min(nframes, n0 - state["pos"]):
                    return None
        buf = state["buf"]
        while len(buf) < nframes and not state["done"]:
            try:
                blk = np.asarray(next(state["it"]), np.float32).reshape(-1)
            except StopIteration:
                state["done"] = True
                break
            buf = np.concatenate([buf, blk]) if len(buf) else blk
        out, state["buf"] = buf[:nframes], buf[nframes:]
        state["pos"] = n0 + len(out)
        if len(out) == 0 and state["done"]:
            return None
        return out

    return pull


class UserOscillator(Oscillator):
    """Wrap ANY user oscillator of the original's style as a graph source
    node — the open extension point (in the original, any object with
    ``blocks()`` composes into a patch).  Accepts:

    * an object with ``blocks()`` yielding float blocks/lists (the
      reference's contract — replayable: each stream calls blocks()
      afresh, which also makes seeking work by skip-forward),
    * an iterator/iterable of float blocks (single pass, no seek),
    * a callable ``f(n0, nframes) -> array`` (random access — the
      stateless ideal: seek/replay are exact and free).

    The wrapped source composes with EnvelopeFilter / EchoFilter /
    MixingFilter / the biquad filters / ``Sample.modulate_amp`` — the
    downstream patch runs on the device per block while the user source's
    block is staged host->device each step (the documented hybrid
    boundary: one copy per block).  A finite source ends the stream (short
    final block zero-padded).
    """

    def __init__(self, source, samplerate: Optional[int] = None):
        import weakref

        key = G.new_host_key()
        if hasattr(source, "blocks"):
            factory = lambda: _seq_pull(source.blocks, replayable=True)
        elif hasattr(source, "__next__"):
            it = source
            consumed = [False]

            def factory():
                if consumed[0]:
                    raise RuntimeError(
                        "iterator source already consumed — pass an object "
                        "with blocks() or a callable (n0, nframes) for "
                        "replayable user oscillators")
                consumed[0] = True
                return _seq_pull(lambda: it, replayable=False)
        elif callable(source):
            def factory():
                def pull(n0, nframes):
                    blk = source(n0, nframes)
                    if blk is None:
                        return None
                    return np.asarray(blk, np.float32).reshape(-1)
                return pull
        elif hasattr(source, "__iter__"):
            it2 = iter(source)
            consumed2 = [False]

            def factory():
                if consumed2[0]:
                    raise RuntimeError(
                        "iterable source already consumed — pass an object "
                        "with blocks() or a callable (n0, nframes) for "
                        "replayable user oscillators")
                consumed2[0] = True
                return _seq_pull(lambda: it2, replayable=False)
        else:
            raise TypeError(
                "UserOscillator needs an object with blocks(), an "
                "iterator/iterable of blocks, or a callable (n0, nframes)")
        G.register_host_source(key, factory)
        node = S.HostSource(key)
        # the registry entry lives as long as the NODE (not this wrapper):
        # `MixingFilter(UserOscillator(gen), ...)` drops the wrapper
        # immediately but the patch keeps the node alive
        self._finalizer = weakref.finalize(node, G.unregister_host_source,
                                           key)
        super().__init__(node, _sr(samplerate))


def from_blocks(source, samplerate: Optional[int] = None) -> UserOscillator:
    """``Oscillator.from_blocks``: alias constructor for UserOscillator."""
    return UserOscillator(source, samplerate)


Oscillator.from_blocks = staticmethod(from_blocks)


# Fast* variants: in the reference these are the non-modulatable fast paths;
# here the engine picks closed-form phase automatically, so they are aliases.
FastSine = Sine
FastTriangle = Triangle
FastSquare = Square
FastSawtooth = Sawtooth
FastPulse = Pulse
FastSemicircle = Semicircle
FastPointy = Pointy


# ---------------------------------------------------------------------------
# Filter / wrapper oscillators
# ---------------------------------------------------------------------------

class EnvelopeFilter(Oscillator):
    """ADSR envelope around a source (sustain is a duration; with
    ``stop_at_end`` the block stream terminates after the release)."""
    def __init__(self, source: Oscillator, attack: float, decay: float,
                 sustain: float, sustain_level: float, release: float,
                 stop_at_end: bool = False):
        super().__init__(S.Envelope(source.spec, attack, decay, sustain,
                                    sustain_level, release, stop_at_end),
                         source.samplerate)

    def blocks(self, blocksize: Optional[int] = None,
               device="cuda") -> Iterator[np.ndarray]:
        bs = blocksize or params.norm_osc_blocksize
        node = self.spec
        stream = G.block_stream(node, self.samplerate, bs, device=device)
        if not node.stop_at_end:
            yield from stream
            return
        total = int(node.end_time * self.samplerate) + 1
        for i, block in enumerate(stream):
            if i * bs >= total:
                return
            yield block


class MixingFilter(Oscillator):
    """Sum any number of sources."""
    def __init__(self, *sources: Oscillator):
        if not sources:
            raise ValueError("MixingFilter needs at least one source")
        super().__init__(S.Mix(tuple(s.spec for s in sources)),
                         sources[0].samplerate)


class AmpModulationFilter(Oscillator):
    """Ring/amplitude modulation: source * modulator."""
    def __init__(self, source: Oscillator, modulator: Oscillator):
        super().__init__(S.AmpMod(source.spec, modulator.spec), source.samplerate)


class DelayFilter(Oscillator):
    """Time-shift the source later by ``seconds`` (zeros before)."""
    def __init__(self, source: Oscillator, seconds: float):
        super().__init__(S.Delay(source.spec, seconds), source.samplerate)


class EchoFilter(Oscillator):
    """Feed-forward echos: ``amount`` copies, first after ``after`` seconds,
    then every ``delay`` seconds, each attenuated by ``decay``."""
    def __init__(self, source: Oscillator, after: float, amount: int,
                 delay: float, decay: float):
        super().__init__(S.Echo(source.spec, after, amount, delay, decay),
                         source.samplerate)


class LowpassFilter(Oscillator):
    """Resonant 2nd-order lowpass (RBJ biquad) — beyond-reference: the
    device runs the IIR as a parallel affine scan (log-depth);
    agreement with the sequential f64 oracle is within a few LSB.
    ``cutoff_lfo`` sweeps the cutoff in octaves: fc_n = cutoff*2**lfo_n."""
    def __init__(self, source: Oscillator, cutoff: float, q: float = 0.7071,
                 cutoff_lfo: Optional[Oscillator] = None):
        super().__init__(S.Biquad(source.spec, "lowpass", cutoff, q,
                                  cutoff_lfo=_child(cutoff_lfo)),
                         source.samplerate)


class HighpassFilter(Oscillator):
    """Resonant 2nd-order highpass (RBJ biquad; sweepable cutoff)."""
    def __init__(self, source: Oscillator, cutoff: float, q: float = 0.7071,
                 cutoff_lfo: Optional[Oscillator] = None):
        super().__init__(S.Biquad(source.spec, "highpass", cutoff, q,
                                  cutoff_lfo=_child(cutoff_lfo)),
                         source.samplerate)


class BandpassFilter(Oscillator):
    """2nd-order bandpass (RBJ biquad, constant 0 dB peak; sweepable)."""
    def __init__(self, source: Oscillator, cutoff: float, q: float = 1.0,
                 cutoff_lfo: Optional[Oscillator] = None):
        super().__init__(S.Biquad(source.spec, "bandpass", cutoff, q,
                                  cutoff_lfo=_child(cutoff_lfo)),
                         source.samplerate)


class ClipFilter(Oscillator):
    def __init__(self, source: Oscillator, minimum: float = -1.0,
                 maximum: float = 1.0):
        super().__init__(S.Clip(source.spec, minimum, maximum), source.samplerate)


class AbsFilter(Oscillator):
    def __init__(self, source: Oscillator):
        super().__init__(S.Abs(source.spec), source.samplerate)


class NullFilter(Oscillator):
    def __init__(self, source: Oscillator):
        super().__init__(S.Null(source.spec), source.samplerate)
