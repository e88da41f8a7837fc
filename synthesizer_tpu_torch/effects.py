"""The ``[fx]`` rack: streaming chunk processors, the chain and the song
file's effect spec (port of ``synthesizer_tpu.effects``).

A song may declare a master chain in its ``.ini`` (entries apply in file
order) and a chain per track:

    [fx]
    chorus   = rate=1.5 depth=0.003
    compress = threshold_db=-15 ratio=4 makeup_db=3
    reverb   = roomsize=0.8 wet=0.3 tail=1.5
    convolve = ir=hall_ir.wav wet=0.4 dry=0.8

Two paths share the formulas of :mod:`goldref.effects`:

* **offline** (``Song.mix``, ``apply_fx_sample``): each entry runs the
  matching ``Sample`` op on the whole signal, or, where the entry is
  automated, the streaming processor over the whole signal at once;
* **streaming** (``Song.mix_generator``, ``FxChain``): the processors here
  carry their recurrence state across chunks on their device (reverb ring
  buffers, compressor envelope, chorus input history, convolution overlap
  tail), so a streamed song equals the offline render within the
  per-effect budgets (``ops.effects.BUDGETS``; the f32 scans regroup at
  chunk boundaries).

Each processor's ``process`` is ONE device program
(``utils.program.Program``) per (effect configuration, chunk shape), as the
reference caches one compiled program per (chunk shape, effect
configuration): knob values are device scalars, so processors that differ
only in their knobs share a program, and the carried state rides in one
flat buffer.  Every processor takes ``device=`` (the card unless the
caller passes ``device="cpu"``) and keeps its state there.  Automation
curves that enter an effect elementwise are evaluated on the device with
``ops.wave.interp`` (``jnp.interp`` bit for bit); those inside a recurrence
are host grids from ``ops.coeffs`` at absolute frames, as in the reference.
"""

from __future__ import annotations

import math
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch
from torch.utils import _pytree as pytree

from .ops import coeffs as C
from .ops import effects as dfx
from .ops import pcm as dpcm
from .ops.wave import div, interp, scalar
from .utils import profiling
from .utils.device import resolve
from .utils.program import Flat, program

__all__ = ["StreamingCompressor", "StreamingReverb", "StreamingChorus",
           "StreamingConvolver", "StreamingBiquad", "StreamingGate",
           "StreamingFeedbackEcho", "StreamingWidth", "StreamingLimiter",
           "StreamingPhaser", "StreamingTremolo", "StreamingAutopan",
           "FxChain", "parse_fx_items", "validate_fx_params", "FX_PARAMS"]

#: default reverb decay tail (seconds) — the single source for the
#: streaming processor default AND the chain tail accounting
DEFAULT_REVERB_TAIL = 1.5


def _grid(a, device) -> torch.Tensor:
    """A host grid as an f32 tensor on ``device``."""
    return torch.from_numpy(np.ascontiguousarray(a, np.float32)).to(device)


def _curve(points):
    """A breakpoint list as (ticks, values) f32 arrays for ``interp``."""
    return (np.asarray([t for t, _ in points], np.float32),
            np.asarray([v for _, v in points], np.float32))


def _curve_t(points, device):
    """A breakpoint list as (ticks, values) f32 tensors on ``device``: a
    program's inputs (programs are shared between processors)."""
    return tuple(_grid(a, device) for a in _curve(points))


def _ticks(n0, n: int, tickf, device) -> torch.Tensor:
    """f32(n0 + k) / f32(tickf) for k in [0, n): the curve time of each
    frame, as the reference computes it (``n0`` and ``tickf`` may be device
    scalars)."""
    k = n0 + torch.arange(n, dtype=torch.int64, device=device)
    return div(k.to(torch.float32), tickf)


def _lfo_seek_carry(rate_curve, start_frame: int, tickf: float,
                    samplerate: int) -> int:
    """The cumulative u32 LFO phase at ``start_frame`` under a rate curve,
    summed over [0, start_frame) in bounded slabs (a deep seek would
    otherwise hold O(start_frame) f64 intermediates at once)."""
    carry = 0
    slab = 1 << 20
    for s0 in range(0, int(start_frame), slab):
        n = min(slab, int(start_frame) - s0)
        inc = C.chorus_inc_grid(C.curve_grid(rate_curve, s0, n, tickf),
                                samplerate)
        carry = (carry + int(inc.astype(np.uint64).sum())) & 0xFFFFFFFF
    return carry


def _program(name: str, static: tuple, template, body, device):
    """(Flat, Program) of a processor configuration, cached by (effect,
    static configuration, the carried state's layout, device): processors
    of one configuration share a program whatever their knob values, as
    the reference's ``_fn_cache``.  ``body(x, state, *extra, f, i) -> (y,
    new state)`` is built from ``static`` alone; the program carries the
    state as ONE flat buffer (``utils.program.Flat``), so a chunk costs one
    copy in and one copy out beside the replay."""
    leaves, spec = pytree.tree_flatten(template)

    def build():
        flat = Flat(template, device)

        def pbody(carry, x, *extra, f, i):
            y, state = body(x, flat.unpack(carry), *extra, f=f, i=i)
            return y, flat.pack(state)
        return pbody, flat

    prog = program(name, (static, spec, tuple((tuple(t.shape), t.dtype)
                                              for t in leaves)),
                   build, device)
    return prog.aux, prog


class _Processor:
    """A streaming processor whose ``process`` is one device program: the
    subclass builds ``self._flat``, ``self._prog`` and ``self._carry``
    (its initial state) with :func:`_program`."""

    def _run(self, x: torch.Tensor, *extra, f=(), i=()) -> torch.Tensor:
        y, self._carry = self._prog(self._carry, x, *extra, f=f, i=i)
        return y


# ---------------------------------------------------------------------------
# Streaming processors.  Each has .process(int_chunk [n, ch]) -> int tensor
# (same shape, except the holdback limiter) and carries its state between
# calls on its device; feeding zeros drains reverb/convolution tails.  The
# host part of a chunk (coefficient grids from curves, the LFO phase carry)
# runs before its program; knobs, frame counters and tickf are the
# program's device scalars.
# ---------------------------------------------------------------------------

def _compressor_body(which: tuple, has_grids: bool, has_key: bool,
                     has_knee: bool):
    def body(x, state, key_arr, grids, cvs, f, i):
        env, zdev = state
        dev = x.device
        thr, slope, alpha, decay, makeup = (f[k] for k in range(5))
        knee = f[5] if has_knee else None
        if has_grids:
            alpha, decay = grids
        if which:
            t = _ticks(i[0], int(x.shape[0]), f[6], dev)
            vals = {k: interp(t, *c) for k, c in zip(which, cvs)}
            if "makeup" in vals:
                makeup = torch.exp2(div(vals["makeup"], 6.0206))
            if "thr" in vals:
                thr = vals["thr"]
            if "ratio" in vals:
                slope = 1.0 - scalar(1.0, dev) / torch.clamp_min(
                    vals["ratio"], 1.0)
            if "knee" in vals:
                # strictly positive: the soft form divides by the width
                knee = torch.clamp_min(vals["knee"], float(np.float32(1e-3)))
        if has_key:
            a = torch.amax(torch.abs(dfx._norm(key_arr)), dim=1)
            gains, env, zdev = dfx.compressor_gains_from_level(
                a, thr, slope, alpha, decay, e0=env, z0=zdev,
                with_state=True, knee=knee)
        else:
            gains, env, zdev = dfx.compressor_gains_from_coeffs(
                x, thr, slope, alpha, decay, e0=env, z0=zdev,
                with_state=True, knee=knee)
        return dpcm.gain_apply(x, (gains * makeup)[:, None]), (env, zdev)
    return body


class StreamingCompressor(_Processor):
    """Chunked twin of ``Sample.compress``: the decaying-max envelope and
    the attack smoother carry their last values across chunks (the same
    associative scans with a carried init).

    Automation curves (fx.compress.*): ``makeup_curve`` (post-gain dB),
    ``threshold_curve`` (dB), ``ratio_curve`` and ``knee_curve`` enter the
    gain computation elementwise, per frame; ``attack_curve`` /
    ``release_curve`` (seconds) automate inside the recurrences as
    per-frame (alpha, decay) grids derived on the host at absolute frames
    (``ops.coeffs.compressor_coeff_grids``).  ``key_fn`` (sidechain
    ducking): ``(n0, n) -> int16 [n, ch]`` on the processor's device, the
    KEY the detector listens to while the gain applies to the processed
    audio; stateless in the absolute frame, so streaming == offline at any
    chunk size or seek."""

    def __init__(self, samplerate: int, threshold_db: float = -20.0,
                 ratio: float = 4.0, attack: float = 0.005,
                 release: float = 0.1, makeup_db: float = 0.0,
                 knee_db: float = 0.0,
                 makeup_curve=None, threshold_curve=None, ratio_curve=None,
                 attack_curve=None, release_curve=None, knee_curve=None,
                 key_fn=None, tickf: float = 0.0, start_frame: int = 0,
                 device="cuda"):
        self.device = resolve(device)
        alpha, decay = C.compressor_coeffs(samplerate, attack, release)
        slope = 1.0 if math.isinf(ratio) else 1.0 - 1.0 / ratio
        if not 0.0 <= knee_db <= 24.0:
            raise ValueError("compress knee_db must be in [0, 24]")
        #: static soft-knee flag (the hard-knee arithmetic is untouched
        #: when off); the knee value stays a knob
        self._has_knee = knee_db > 0.0 or knee_curve is not None
        self._knobs = [float(v) for v in np.asarray(
            [threshold_db, slope, alpha, decay,
             float(np.exp2(np.float32(makeup_db) / np.float32(6.0206))),
             knee_db], np.float32)]
        self._sr = samplerate
        self.tail_frames = 0
        _require_tickf(tickf, makeup_curve, threshold_curve, ratio_curve,
                       attack_curve, release_curve, knee_curve)
        curves = {name: c for name, c in (
            ("makeup", makeup_curve), ("thr", threshold_curve),
            ("ratio", ratio_curve), ("knee", knee_curve)) if c is not None}
        self._which = tuple(sorted(curves))
        self._cvs = tuple(_curve_t(curves[k], self.device)
                          for k in self._which)
        #: host-evaluated coefficient-grid curves (attack/release seconds)
        self._grid_curves = {k: c for k, c in (("attack", attack_curve),
                                               ("release", release_curve))
                             if c is not None}
        self._static_attack = float(attack)
        self._static_release = float(release)
        self._key_fn = key_fn
        self._key_n0 = int(start_frame)
        self._tickf = float(tickf)
        self._n0 = int(start_frame)
        z = scalar(0.0, self.device)
        flags = (self._which, bool(self._grid_curves), key_fn is not None,
                 self._has_knee)
        self._flat, self._prog = _program(
            "compress", flags, (z, z), _compressor_body(*flags),
            self.device)
        self._carry = self._flat.pack((z, z))   # (e_{-1}, z_{-1} = 1 - y)

    def _coeff_grids(self, n: int):
        """Per-frame (alpha, decay) f32 grids for [n0, n0+n)."""
        ac = self._grid_curves.get("attack")
        rc = self._grid_curves.get("release")
        att = (C.curve_grid(ac, self._n0, n, self._tickf) if ac is not None
               else np.full(n, self._static_attack))
        rel = (C.curve_grid(rc, self._n0, n, self._tickf) if rc is not None
               else np.full(n, self._static_release))
        return C.compressor_coeff_grids(att, rel, self._sr)

    def process(self, x: torch.Tensor) -> torch.Tensor:
        n = int(x.shape[0])
        grids = ()
        if self._grid_curves:
            grids = tuple(_grid(g, self.device) for g in self._coeff_grids(n))
        key = ()
        if self._key_fn is not None:
            key = self._key_fn(self._key_n0, n)
            self._key_n0 += n
        y = self._run(x, key, grids, self._cvs,
                      f=self._knobs + [self._tickf], i=(self._n0,))
        if self._which or self._grid_curves:
            self._n0 += n
        return y


def _zero_state(nch: int, ff: bool, device):
    z = torch.zeros(nch, dtype=torch.float32, device=device)
    return (z,) * (6 if ff else 4)


def _biquad_chunk(x: torch.Tensor, state, ff: bool, coefs):
    """One biquad over an int chunk: the plain companion scan on f32
    coefficients, or the float-float scan on (hi, lo) pairs -> (y, state)."""
    width = dpcm.width_of(x)
    s = dfx._norm(x)
    if ff:
        y, state = dfx.biquad_apply_ff(s, coefs, state)
    else:
        y, state = dfx.biquad_apply(s, coefs, state)
    return dfx.to_int_samples(y, width), state


def _biquads_body(bands: tuple):
    """Biquads in series, each with the int PCM round trip: a band is
    (swept, ff); a swept band's coefficients are grid inputs, a static
    band's f32 scalars (five, or five (hi, lo) pairs) in ``f``."""
    def body(x, states, grids, f, i):
        off, new = 0, []
        for (swept, ff), st, g in zip(bands, states, grids):
            if swept:
                coefs = g
            elif ff:
                coefs = tuple((f[off + 2 * k], f[off + 2 * k + 1])
                              for k in range(5))
                off += 10
            else:
                coefs = tuple(f[off + k] for k in range(5))
                off += 5
            x, st = _biquad_chunk(x, st, ff, coefs)
            new.append(st)
        return x, tuple(new)
    return body


class _Biquads(_Processor):
    """The biquad processors' shared ``process``: their bands (objects with
    ``_ff``, ``_swept`` and ``_band_inputs(n) -> (grids, scalars)``) in
    series as ONE program."""

    def _init_bands(self, bands, nchannels: int, device) -> None:
        self._bands = list(bands)
        states = tuple(_zero_state(nchannels, b._ff, device) for b in bands)
        flags = tuple((b._swept, b._ff) for b in bands)
        self._flat, self._prog = _program("biquads", flags, states,
                                          _biquads_body(flags), device)
        self._carry = self._flat.pack(states)

    @profiling.spanned("effects.biquad")
    def process(self, x: torch.Tensor) -> torch.Tensor:
        if not self._bands:
            return x
        grids, scalars = [], []
        for b in self._bands:
            g, s = b._band_inputs(int(x.shape[0]))
            grids.append(g)
            scalars.extend(s)
        return self._run(x, tuple(grids), f=scalars)


class StreamingBiquad(_Biquads):
    """Chunked twin of ``Sample.filter``: the (x1, x2, y1, y2) biquad state
    carries across chunks (``ops.effects.biquad_apply``)."""

    _swept = False

    def __init__(self, samplerate: int, nchannels: int, kind: str,
                 cutoff: float, q: float = 0.7071, gain_db: float = 0.0,
                 device="cuda"):
        self.device = resolve(device)
        if kind in ("lowshelf", "highshelf", "peaking"):
            knobs = C.eq_band_coeffs(kind, cutoff, gain_db, q, samplerate)
        else:
            knobs = C.biquad_coeffs(kind, cutoff, q, samplerate)
        # the routing decision of Sample._biquad, from the same f64
        # coefficients, so the streaming and offline paths agree
        self._ff = C.wants_ff_scan(knobs)
        if self._ff:
            self._coefs = [float(np.float32(v)) for c in knobs
                           for v in C.ff_split(c)]
        else:
            self._coefs = [float(np.float32(c)) for c in knobs]
        self.tail_frames = 0
        self._init_bands([self], nchannels, self.device)

    def _band_inputs(self, n: int):
        return (), self._coefs


def _swept_biquad_body(kind: str, samplerate: int):
    def body(x, state, xs, vs, f, i):
        dev = x.device
        width = dpcm.width_of(x)
        s = dfx._norm(x)
        t = _ticks(i[0], int(x.shape[0]), f[1], dev)
        fc = torch.clamp(interp(t, xs, vs), 10.0,
                         float(np.float32(0.49 * samplerate)))
        w0 = float(np.float32(2.0 * math.pi / samplerate)) * fc
        alpha = torch.sin(w0) / (2.0 * f[0])
        cw = torch.cos(w0)
        one = scalar(1.0, dev)
        if kind == "lowpass":
            b0 = (one - cw) * 0.5
            b1 = one - cw
            b2 = b0
        elif kind == "highpass":
            b0 = (one + cw) * 0.5
            b1 = -(one + cw)
            b2 = b0
        else:                                    # bandpass
            b0 = alpha
            b1 = torch.zeros_like(alpha)
            b2 = -alpha
        a0r = one / (one + alpha)
        coeffs = (b0 * a0r, b1 * a0r, b2 * a0r, (-2.0 * cw) * a0r,
                  (one - alpha) * a0r)
        y, state = dfx.biquad_apply(s, coeffs, state, torch.float64)
        return dfx.to_int_samples(y, width), state
    return body


class SweptEQBand(_Biquads):
    """One parametric-EQ band with a per-frame gain curve
    (``fx.eq.*_db`` automation): coefficient grids derived on the host in
    f64 at absolute frames (``ops.coeffs.eq_coeff_grids``), applied through
    the companion scan with carried state.  Spec: goldref.effects.eq_swept.
    A band of :class:`StreamingEQ`, or a processor of its own."""

    _swept = True

    def __init__(self, samplerate: int, nchannels: int, kind: str,
                 freq: float, q: float, curve, tickf: float,
                 start_frame: int = 0, device="cuda"):
        _require_tickf(tickf, curve)
        self.device = resolve(device)
        self.kind, self.freq, self.q = kind, float(freq), float(q)
        self.curve = curve
        self.tickf = float(tickf)
        self.samplerate = samplerate
        # the static bands' conditioning rule at every breakpoint gain
        self._ff = any(
            C.wants_ff_scan(C.eq_band_coeffs(kind, freq, g, q, samplerate))
            for _, g in curve)
        self._n0 = int(start_frame)
        self.tail_frames = 0
        self._init_bands([self], nchannels, self.device)

    def _band_inputs(self, n: int):
        g = C.curve_grid(self.curve, self._n0, n, self.tickf)
        grids = C.eq_coeff_grids(self.kind, self.freq, g, self.q,
                                 self.samplerate,
                                 dtype=np.float64 if self._ff
                                 else np.float32)
        self._n0 += n
        return _grid_coefs(grids, self._ff, self.device), []


class SweptGainKindBiquad(_Biquads):
    """``fx.filter.cutoff`` automation for the gain kinds (lowshelf,
    highshelf, peaking): the per-frame corner-frequency grid derives the
    five RBJ coefficients on the host in f64
    (``ops.coeffs.eq_freqs_coeff_grids``), and badly conditioned corners
    run the float-float scan.  Spec: goldref.effects.filter_swept_freq."""

    _swept = True

    def __init__(self, samplerate: int, nchannels: int, kind: str,
                 q: float, gain_db: float, curve, tickf: float,
                 start_frame: int = 0, device="cuda"):
        _require_tickf(tickf, curve)
        self.device = resolve(device)
        self.kind, self.q = kind, float(q)
        self.gain_db = float(gain_db)
        self.curve = curve
        self.tickf = float(tickf)
        self.samplerate = samplerate
        self._ff = any(
            C.wants_ff_scan(C.eq_band_coeffs(
                kind, float(np.clip(f, 10.0, samplerate * 0.49)),
                gain_db, q, samplerate))
            for _, f in curve)
        self._n0 = int(start_frame)
        self.tail_frames = 0
        self._init_bands([self], nchannels, self.device)

    def _band_inputs(self, n: int):
        f = np.clip(C.curve_grid(self.curve, self._n0, n, self.tickf),
                    10.0, self.samplerate * 0.49)
        grids = C.eq_freqs_coeff_grids(self.kind, f, self.gain_db, self.q,
                                       self.samplerate,
                                       dtype=np.float64 if self._ff
                                       else np.float32)
        self._n0 += n
        return _grid_coefs(grids, self._ff, self.device), []


def _grid_coefs(grids, ff: bool, device):
    """Host coefficient grids as tensors: f32 grids, or (hi, lo) pairs of
    f64 grids for the float-float scan."""
    if ff:
        return tuple(tuple(_grid(part, device) for part in C.ff_split(g))
                     for g in grids)
    return tuple(_grid(g, device) for g in grids)


class StreamingEQ(_Biquads):
    """Chunked twin of ``Sample.eq``: one carried biquad state per active
    band, bands in low/mid/high order with the int PCM round trip between
    them (``Sample.eq``'s semantics, so streaming == offline bit for bit
    given the same chunk contents), all bands one program.  A band with a
    ``*_curve`` runs as a :class:`SweptEQBand` (its static gain is
    ignored); without one, bands of zero gain are skipped, as ``Sample.eq``
    skips them."""

    def __init__(self, samplerate: int, nchannels: int,
                 low_db: float = 0.0, mid_db: float = 0.0,
                 high_db: float = 0.0, low_freq: float = 120.0,
                 mid_freq: float = 1000.0, mid_q: float = 1.0,
                 high_freq: float = 8000.0,
                 low_curve=None, mid_curve=None, high_curve=None,
                 tickf: float = 0.0, start_frame: int = 0, device="cuda"):
        self.device = resolve(device)
        bands = []
        for kind, f, g, q, curve in (
                ("lowshelf", low_freq, low_db, 0.7071, low_curve),
                ("peaking", mid_freq, mid_db, mid_q, mid_curve),
                ("highshelf", high_freq, high_db, 0.7071, high_curve)):
            if curve is not None:
                bands.append(SweptEQBand(samplerate, nchannels, kind, f, q,
                                         curve, tickf, start_frame,
                                         device=device))
            elif g != 0.0:
                bands.append(StreamingBiquad(samplerate, nchannels, kind, f,
                                             q, gain_db=g, device=device))
        self.tail_frames = 0
        self._init_bands(bands, nchannels, self.device)


def swept_biquad_chunk(x: torch.Tensor, n0: int, kind: str, q: float,
                       xs, vs, tickf: float, samplerate: int, state=None):
    """Cutoff-automated biquad (the ``fx.filter.cutoff`` curve): per-frame
    cutoff from the breakpoint curve (``interp`` over ticks, ends held,
    clipped to [10, 0.49*sr] Hz), per-frame RBJ coefficients in f32 (the
    graph engine's LFO-swept Biquad formulas), applied through the
    companion scan with carried (x1, x2, y1, y2) state.  Stateless in the
    absolute frame ``n0`` apart from the filter state.  Returns (y_int,
    new_state): the body of :class:`SweptStreamingBiquad`'s program, run
    eagerly.

    The scan runs in f64 on the f32 coefficients and input, rounded back
    to f32.  In f32, without the fused multiply-adds that XLA's 2x2
    products get on the CPU, a sweep that ends at a low, resonant cutoff
    (300 Hz, Q 2, over one second) drifted 10 LSB from the sequential f64
    recurrence (the JAX package: 4), past the 8 LSB the reference allows
    between streaming and offline; the f64 scan stays within 1 LSB."""
    _check_sweep_kind(kind)
    dev = x.device
    if state is None:
        state = _zero_state(x.shape[1], False, dev)
    f = torch.from_numpy(np.asarray([q, tickf], np.float32)).to(dev)
    i = torch.full((1,), int(n0), dtype=torch.int64, device=dev)
    return _swept_biquad_body(kind, samplerate)(
        x, state, *(a if isinstance(a, torch.Tensor) else _grid(a, dev)
                    for a in (xs, vs)), f=f, i=i)


def _check_sweep_kind(kind: str) -> None:
    if kind not in ("lowpass", "highpass", "bandpass"):
        raise ValueError("fx.filter.cutoff automation supports "
                         "lowpass/highpass/bandpass only (shelving kinds "
                         "have a gain coefficient the sweep does not "
                         "carry)")


class SweptStreamingBiquad(_Processor):
    """Streaming twin of the cutoff-automation path
    (:func:`swept_biquad_chunk` as one program a chunk): tracks the
    absolute frame across chunks so that the curve stays aligned (a seek
    passes its ``start_frame``; the filter state starts cold, like every
    seek with fx)."""

    def __init__(self, samplerate: int, nchannels: int, kind: str,
                 q: float, curve, tickf: float, start_frame: int = 0,
                 device="cuda"):
        _require_tickf(tickf, curve)
        _check_sweep_kind(kind)
        self.device = resolve(device)
        self.kind = kind
        self.q = float(q)
        self._xs, self._vs = _curve_t(curve, self.device)
        self.tickf = float(tickf)
        self.samplerate = samplerate
        self._n0 = int(start_frame)
        self.tail_frames = 0
        state = _zero_state(nchannels, False, self.device)
        self._flat, self._prog = _program(
            "swept_biquad", (kind, samplerate), state,
            _swept_biquad_body(kind, samplerate), self.device)
        self._carry = self._flat.pack(state)

    @profiling.spanned("effects.biquad")
    def process(self, x: torch.Tensor) -> torch.Tensor:
        y = self._run(x, self._xs, self._vs, f=(self.q, self.tickf),
                      i=(self._n0,))
        self._n0 += int(x.shape[0])
        return y


def _gate_body(has_curve: bool):
    def body(x, state, cvs, f, i):
        env, z = state
        thr = f[0]
        if has_curve:
            thr = interp(_ticks(i[0], int(x.shape[0]), f[4], x.device),
                         *cvs)
        g, env, z = dfx.gate_gains_from_coeffs(
            x, thr, f[1], f[2], f[3], e0=env, z0=z, with_state=True)
        return dpcm.gain_apply(x, g[:, None]), (env, z)
    return body


class StreamingGate(_Processor):
    """Chunked twin of ``Sample.gate``: detector envelope and smoother
    carry across chunks (a stream starts closed).  ``threshold_curve``
    (fx.gate.threshold_db) enters the open/closed comparison per frame."""

    def __init__(self, samplerate: int, threshold_db: float = -50.0,
                 range_db: float = 80.0, attack: float = 0.001,
                 release: float = 0.05, threshold_curve=None,
                 tickf: float = 0.0, start_frame: int = 0, device="cuda"):
        self.device = resolve(device)
        alpha, decay, floor_gain = C.gate_coeffs(samplerate, attack, release,
                                                 range_db)
        self._knobs = [float(v) for v in np.asarray(
            [threshold_db, floor_gain, alpha, decay], np.float32)]
        self.tail_frames = 0
        _require_tickf(tickf, threshold_curve)
        self._cvs = (_curve_t(threshold_curve, self.device)
                     if threshold_curve is not None else ())
        self._tickf = float(tickf)
        self._n0 = int(start_frame)
        state = (scalar(0.0, self.device), scalar(floor_gain, self.device))
        has_curve = threshold_curve is not None
        self._flat, self._prog = _program("gate", (has_curve,), state,
                                          _gate_body(has_curve), self.device)
        self._carry = self._flat.pack(state)

    def process(self, x: torch.Tensor) -> torch.Tensor:
        y = self._run(x, self._cvs, f=self._knobs + [self._tickf],
                      i=(self._n0,))
        if self._cvs:
            self._n0 += int(x.shape[0])
        return y


def _reverb_body(nets: tuple, nch: int, room: bool, swept: bool):
    def body(x, states, fb_grid, cvs, f, i):
        dev = x.device
        n = int(x.shape[0])
        width = dpcm.width_of(x)
        feedback, damp, wet1, wet2, dry = (f[k] for k in range(5))
        if room:
            feedback = fb_grid
        if swept:
            t = _ticks(i[0], n, f[5], dev)
            wet_n = interp(t, *cvs[0])
            dry = interp(t, *cvs[1])
            wet1 = wet_n * f[6]
            wet2 = wet_n * f[7]
        s = dfx._norm(x)
        mono_in = torch.sum(s, dim=1) * float(np.float32(C.FIXED_GAIN))
        states, revs = dfx.reverb_networks_apply(states, mono_in, nets,
                                                 feedback, damp)
        if nch == 1:
            out = (dry * s[:, 0] + (wet1 + wet2) * revs[0])[:, None]
        else:
            out = torch.stack(
                [dry * s[:, 0] + wet1 * revs[0] + wet2 * revs[1],
                 dry * s[:, 1] + wet1 * revs[1] + wet2 * revs[0]], dim=1)
        return dfx.to_int_samples(out, width), tuple(states)
    return body


class StreamingReverb(_Processor):
    """Chunked twin of ``Sample.reverb``: the comb/allpass ring buffers and
    write position carry across chunks (``ops.effects.
    reverb_networks_apply``, inlined into this processor's program; a
    chunk of more than ``ops.effects.SLAB_STEPS`` comb blocks runs in
    pieces of as many blocks).
    ``tail_frames`` is how much silence to feed after the programme to
    drain the decay tail.

    ``wet_curve``/``dry_curve`` (fx.reverb.wet/.dry) replace the static
    wet/dry with per-frame gains on the output stage; ``roomsize_curve``
    (fx.reverb.roomsize) automates inside the comb recurrences as a
    per-frame feedback grid fb_n = 0.7 + 0.28*roomsize_n from the host
    (``ops.coeffs.reverb_feedback_grid``), at absolute frames."""

    def __init__(self, samplerate: int, nchannels: int,
                 roomsize: float = 0.7, damping: float = 0.5,
                 wet: float = 0.33, dry: float = 0.7, width: float = 1.0,
                 tail: float = DEFAULT_REVERB_TAIL,
                 wet_curve=None, dry_curve=None, roomsize_curve=None,
                 tickf: float = 0.0, start_frame: int = 0, device="cuda"):
        self.device = resolve(device)
        feedback, damp, wet1, wet2 = C.reverb_params(roomsize, damping, wet,
                                                     width)
        self._knobs = [float(v) for v in np.asarray(
            [feedback, damp, wet1, wet2, dry], np.float32)]
        self._sr = samplerate
        nets = tuple((tuple(c), tuple(a)) for c, a in (
            C.reverb_delays(samplerate, ch)
            for ch in range(1 if nchannels == 1 else 2)))
        state = tuple(dfx.reverb_zero_state(c, a, self.device)
                      for c, a in nets)
        self.tail_frames = int(tail * samplerate)
        _require_tickf(tickf, wet_curve, dry_curve, roomsize_curve)
        self._room_curve = roomsize_curve
        self._swept = wet_curve is not None or dry_curve is not None
        self._cvs = ()
        if self._swept:
            # a one-point curve interpolates to its constant, so the knob
            # that is not automated becomes [(0, value)]
            self._cvs = (
                _curve_t(wet_curve if wet_curve is not None
                         else [(0.0, wet)], self.device),
                _curve_t(dry_curve if dry_curve is not None
                         else [(0.0, dry)], self.device))
            # wet splits into the Freeverb stereo pair by the width law
            self._knobs += [0.0, float(np.float32(width / 2.0 + 0.5)),
                            float(np.float32((1.0 - width) / 2.0))]
        self._tickf = float(tickf)
        self._n0 = int(start_frame)
        # a chunk's comb loop unrolls into the program: a longer chunk (a
        # whole song offline) runs in pieces of SLAB_STEPS comb blocks,
        # whose blocks are the whole chunk's
        self._piece = dfx.SLAB_STEPS * min(D for c, _ in nets for D in c)
        flags = (nets, nchannels, roomsize_curve is not None, self._swept)
        self._flat, self._prog = _program("reverb", flags, state,
                                          _reverb_body(*flags), self.device)
        self._carry = self._flat.pack(state)

    def process(self, x: torch.Tensor) -> torch.Tensor:
        n = int(x.shape[0])
        fb = ()
        if self._room_curve is not None:
            fb = _grid(C.reverb_feedback_grid(C.curve_grid(
                self._room_curve, self._n0, n, self._tickf)), self.device)
        f = list(self._knobs)
        if self._swept:
            f[5] = self._tickf
        ys = []
        for p0 in range(0, max(n, 1), self._piece):
            ys.append(self._run(
                x[p0:p0 + self._piece], fb[p0:p0 + self._piece]
                if self._room_curve is not None else (), self._cvs, f=f,
                i=(self._n0 + p0,)))
        if self._swept or self._room_curve is not None:
            self._n0 += n
        return ys[0] if len(ys) == 1 else torch.cat(ys)


def _chorus_body(sr: int, rate: float, voices: int, has_P: bool,
                 has_depth: bool, swept: bool):
    def body(x, hist, P, depth_grid, cvs, f, i):
        depth, delay, wet, dry = (f[k] for k in range(4))
        if has_depth:
            depth = depth_grid
        if swept:
            t = _ticks(i[1], int(x.shape[0]), f[4], x.device)
            wet = interp(t, *cvs[0])
            dry = interp(t, *cvs[1])
        s = dfx._norm(x)
        out = dfx.chorus_core(s, i[0], hist, sr, rate, depth, delay, voices,
                              wet, dry, P=P if has_P else None)
        H = hist.shape[0]
        return (dfx.to_int_samples(out, dpcm.width_of(x)),
                torch.cat([hist, s])[-H:])
    return body


class StreamingChorus(_Processor):
    """Chunked twin of ``Sample.chorus``: carries the input history the
    modulated delays read from and the frame count for the integer-DDS LFO
    phase.  The gathers are exact, so chunked output matches the
    whole-signal op.

    ``wet_curve``/``dry_curve`` (fx.chorus.wet/.dry): per-frame output
    gains.  ``rate_curve`` becomes per-frame u32 DDS increments whose
    cumulative phase is kept exactly on the host
    (``ops.coeffs.chorus_inc_grid``/``chorus_phase_grid``: integer mod 2^32,
    so offline == streaming bit for bit); ``depth_curve`` is a per-frame
    f32 grid in the delay formula.  The history holds the curve's largest
    depth."""

    def __init__(self, samplerate: int, nchannels: int, rate: float = 0.5,
                 depth: float = 0.002, delay: float = 0.02, voices: int = 3,
                 wet: float = 0.4, dry: float = 1.0,
                 wet_curve=None, dry_curve=None, rate_curve=None,
                 depth_curve=None, tickf: float = 0.0,
                 start_frame: int = 0, device="cuda"):
        self.device = resolve(device)
        self._sr = samplerate
        self._rate = float(rate)
        self._voices = int(voices)
        self._knobs = [float(v) for v in np.asarray([depth, delay, wet, dry],
                                                    np.float32)]
        _require_tickf(tickf, wet_curve, dry_curve, rate_curve, depth_curve)
        self._rate_curve = rate_curve
        self._depth_curve = depth_curve
        max_depth = (max(v for _, v in depth_curve)
                     if depth_curve is not None else depth)
        hist = int(math.ceil((delay + max_depth) * samplerate)) + 2
        hist0 = torch.zeros((hist, nchannels), dtype=torch.float32,
                            device=self.device)
        #: frames processed: the static LFO's phase index (from 0, also
        #: after a seek, as in the reference)
        self._n0 = 0
        self._p_carry = 0
        self.tail_frames = 0
        swept = wet_curve is not None or dry_curve is not None
        self._cvs = ()
        if swept:
            self._cvs = (
                _curve_t(wet_curve if wet_curve is not None
                         else [(0.0, wet)], self.device),
                _curve_t(dry_curve if dry_curve is not None
                         else [(0.0, dry)], self.device))
        self._tickf = float(tickf)
        #: absolute frame of the curves (wet/dry on the device, rate and
        #: depth on the host)
        self._curve_n0 = int(start_frame)
        if rate_curve is not None and start_frame:
            self._p_carry = _lfo_seek_carry(rate_curve, start_frame, tickf,
                                            samplerate)
        flags = (samplerate, self._rate, self._voices,
                 rate_curve is not None, depth_curve is not None, swept)
        self._flat, self._prog = _program("chorus", flags, hist0,
                                          _chorus_body(*flags), self.device)
        self._carry = self._flat.pack(hist0)

    def process(self, x: torch.Tensor) -> torch.Tensor:
        dev = self.device
        n = int(x.shape[0])
        P = depth = ()
        if self._rate_curve is not None:
            inc = C.chorus_inc_grid(C.curve_grid(
                self._rate_curve, self._curve_n0, n, self._tickf), self._sr)
            Pn, self._p_carry = C.chorus_phase_grid(inc, self._p_carry)
            P = torch.from_numpy(Pn.astype(np.int64)).to(dev)
        if self._depth_curve is not None:
            depth = _grid(C.curve_grid(self._depth_curve, self._curve_n0, n,
                                       self._tickf), dev)
        y = self._run(x, P, depth, self._cvs, f=self._knobs + [self._tickf],
                      i=(self._n0, self._curve_n0))
        self._curve_n0 += n
        self._n0 += n
        return y


def _convolver_body(x, tail, ir, f, i):
    return dfx.convolve_chunk(x, ir, f[0], f[1], tail)


class StreamingConvolver(_Processor):
    """Chunked twin of ``Sample.convolve``: FFT convolution per chunk with
    the (len(ir)-1)-frame overlap tail carried across chunks.  Feeding
    ``tail_frames`` of silence flushes the final tail."""

    def __init__(self, ir_norm: np.ndarray, wet: float = 1.0,
                 dry: float = 0.0, device="cuda"):
        self.device = resolve(device)
        ir = np.asarray(ir_norm, np.float32)
        if ir.ndim == 1:
            ir = ir[:, None]
        self._ir = torch.from_numpy(np.ascontiguousarray(ir)).to(self.device)
        self._wet, self._dry = (float(v) for v in np.asarray([wet, dry],
                                                              np.float32))
        self._carry = None          # the [m-1, ch] pending output, flat
        self.tail_frames = int(ir.shape[0]) - 1

    def process(self, x: torch.Tensor) -> torch.Tensor:
        if self._carry is None:
            tail = torch.zeros((max(int(self._ir.shape[0]) - 1, 0),
                                x.shape[1]), dtype=torch.float32,
                               device=self.device)
            self._flat, self._prog = _program("convolve", (), tail,
                                              _convolver_body, self.device)
            self._carry = self._flat.pack(tail)
        return self._run(x, self._ir, f=(self._wet, self._dry))


def _echo_body(D: int, swept: bool):
    def body(x, hist, grids, f, i):
        s = dfx._norm(x)
        if swept:
            fb, wet, dry = grids[0], grids[1][:, None], grids[2][:, None]
        else:
            fb, wet, dry = f[0], f[1], f[2]
        e, hist = dfx.feedback_echo_core(s, D, fb, hist)
        return dfx.to_int_samples(dry * s + wet * e, dpcm.width_of(x)), hist
    return body


class StreamingFeedbackEcho(_Processor):
    """Chunked twin of ``Sample.feedback_echo``: the delay line's history
    (the last D frames of the recurrence) carries across chunks, so
    streaming == offline bit for bit at any chunk size.  Curves
    (fx.echo.feedback/.wet/.dry) are host grids at absolute frames
    (``ops.coeffs.curve_grid``).  Spec: goldref.effects.feedback_echo."""

    def __init__(self, samplerate: int, nchannels: int, delay: float = None,
                 feedback: float = 0.4, wet: float = 0.5, dry: float = 1.0,
                 tail: float = None, feedback_curve=None, wet_curve=None,
                 dry_curve=None, tickf: float = 0.0, start_frame: int = 0,
                 device="cuda"):
        self.device = resolve(device)
        if delay is None:
            raise ValueError("[fx] echo needs delay= seconds (or beats= "
                             "inside a song)")
        if not 0.0 <= feedback <= 0.95:
            raise ValueError("echo feedback must be in [0, 0.95]")
        self._D = max(1, int(delay * samplerate))
        self.tail_frames = C.echo_tail_frames(samplerate, delay, feedback,
                                              wet, tail)
        hist = torch.zeros((self._D, nchannels), dtype=torch.float32,
                           device=self.device)
        self._knobs = [float(v) for v in np.asarray([feedback, wet, dry],
                                                    np.float32)]
        _require_tickf(tickf, feedback_curve, wet_curve, dry_curve)
        self._curves = (feedback_curve, wet_curve, dry_curve)
        self._swept = any(c is not None for c in self._curves)
        self._tickf = float(tickf)
        self._n0 = int(start_frame)
        self._flat, self._prog = _program(
            "echo", (self._D, self._swept), hist,
            _echo_body(self._D, self._swept), self.device)
        self._carry = self._flat.pack(hist)

    def process(self, x: torch.Tensor) -> torch.Tensor:
        n = int(x.shape[0])
        grids = ()
        if self._swept:
            grids = tuple(
                _grid(C.curve_grid(c, self._n0, n, self._tickf)
                      if c is not None else np.full(n, k, np.float64),
                      self.device) for c, k in zip(self._curves, self._knobs))
            self._n0 += n
        return self._run(x, grids, f=self._knobs)


def _width_body(swept: bool):
    def body(x, state, grid, f, i):
        return dfx.stereo_width(x, grid if swept else f[0]), state
    return body


class StreamingWidth(_Processor):
    """Chunked twin of ``Sample.stereo_width``: stateless mid/side width;
    ``amount_curve`` (fx.width.amount) is a host grid at absolute
    frames."""

    def __init__(self, samplerate: int, nchannels: int,
                 amount: float = None, amount_curve=None,
                 tickf: float = 0.0, start_frame: int = 0, device="cuda"):
        self.device = resolve(device)
        if nchannels != 2:
            raise ValueError("[fx] width needs a stereo song")
        if amount is None and amount_curve is None:
            raise ValueError("[fx] width needs amount=")
        if amount is not None and not 0.0 <= amount <= 4.0:
            raise ValueError("width amount must be in [0, 4]")
        self._amount = float(amount if amount is not None else 1.0)
        _require_tickf(tickf, amount_curve)
        self._curve = amount_curve
        self._tickf = float(tickf)
        self._n0 = int(start_frame)
        self.tail_frames = 0
        swept = amount_curve is not None
        self._flat, self._prog = _program("width", (swept,), (),
                                          _width_body(swept), self.device)
        self._carry = self._flat.pack(())

    def process(self, x: torch.Tensor) -> torch.Tensor:
        grid = ()
        if self._curve is not None:
            n = int(x.shape[0])
            grid = _grid(C.curve_grid(self._curve, self._n0, n, self._tickf),
                         self.device)
            self._n0 += n
        return self._run(x, grid, f=(self._amount,))


def _limiter_body(L: int, has_curve: bool, has_rel: bool):
    def body(buf, state, ceil_db, c, decay, f, i):
        r, gpad = state
        emit = int(buf.shape[0]) - L
        if not has_curve:
            ceil_db = f[0]
        if not has_rel:
            decay = f[1]
        a = torch.amax(torch.abs(dfx._norm(buf)), dim=1)
        gs, r, gpad = dfx.limiter_gains_core(a, ceil_db, decay, L, r, gpad)
        y = dpcm.gain_apply(buf[:emit], gs[:, None])
        if has_curve:
            y = torch.maximum(torch.minimum(y.to(torch.int64), c), -c) \
                .to(buf.dtype)
        else:
            y = torch.maximum(torch.minimum(y, i[0]), -i[0]).to(buf.dtype)
        return (y, buf[emit:]), (r, gpad)
    return body


class StreamingLimiter(_Processor):
    """Chunked twin of ``Sample.limit`` -- a holdback processor: it
    withholds the lookahead window (L frames) of input until the future it
    needs has arrived, so ``process`` may return fewer frames than it was
    fed (the first chunk is L short; ``flush_frames`` more input at the end
    pushes the rest out).  Master-chain only: a fixed-size track bus cannot
    ride a holdback (``Song.add_track_fx`` rejects it).  State: the pending
    input, the release level and the trailing gains of the box attack ramp;
    streaming == offline exactly (the offline path pads by
    ``flush_frames`` and truncates back).  Spec: goldref.effects.
    limiter_gains."""

    def __init__(self, samplerate: int, nchannels: int,
                 ceiling_db: float = -1.0, release: float = 0.05,
                 lookahead: float = 0.005, ceiling_curve=None,
                 release_curve=None, tickf: float = 0.0,
                 start_frame: int = 0, device="cuda"):
        self.device = resolve(device)
        if not -60.0 <= ceiling_db <= 0.0:
            raise ValueError("limiter ceiling_db must be in [-60, 0]")
        self._sr = samplerate
        self._L = max(1, int(lookahead * samplerate))
        self._decay = float(np.float32(C.compressor_coeffs(samplerate, 0.0,
                                                           release)[1]))
        self._ceil = float(ceiling_db)
        self.tail_frames = 0
        self.flush_frames = self._L
        self._pend = None                       # [k <= L, ch] int
        state = (scalar(0.0, self.device),
                 torch.ones(self._L, dtype=torch.float32,
                            device=self.device))
        _require_tickf(tickf, ceiling_curve, release_curve)
        self._curve = ceiling_curve
        #: fx.limiter.release: a per-frame decay grid at the emitted
        #: positions (the release recurrence's absolute frames)
        self._rel_curve = release_curve
        self._n0 = int(start_frame)
        self._tickf = float(tickf)
        flags = (self._L, ceiling_curve is not None,
                 release_curve is not None)
        self._flat, self._prog = _program("limiter", flags, state,
                                          _limiter_body(*flags), self.device)
        self._carry = self._flat.pack(state)

    def process(self, x: torch.Tensor) -> torch.Tensor:
        dev = self.device
        L = self._L
        buf = x if self._pend is None or self._pend.shape[0] == 0 \
            else torch.cat([self._pend, x])
        m = int(buf.shape[0])
        if m <= L:
            self._pend = buf
            return x[:0]
        emit = m - L
        width = dpcm.width_of(x)
        ceil_db = c = decay = ()
        if self._curve is not None:
            g = C.curve_grid(self._curve, self._n0, m, self._tickf)
            ceil_db = _grid(g, dev)
            cexp = np.exp2(g[:emit].astype(np.float32)
                           * np.float32(1.0 / 6.0206)).astype(np.float64)
            c = torch.from_numpy(np.rint(cexp * dpcm.MAXVAL[width])
                                 .astype(np.int64)).to(dev)[:, None]
        if self._rel_curve is not None:
            rg = C.curve_grid(self._rel_curve, self._n0, emit, self._tickf)
            decay = _grid(C.compressor_coeff_grids(np.zeros(emit), rg,
                                                   self._sr)[1], dev)
        y, self._pend = self._run(
            buf, ceil_db, c, decay, f=(self._ceil, self._decay),
            i=(C.limiter_ceiling(self._ceil, width),))
        self._n0 += emit
        return y


def _phaser_body(stages: int, ff: bool, swept: bool):
    def body(x, states, coefs, wd, f, i):
        if swept:
            wet, dry = wd[0][:, None], wd[1][:, None]
        else:
            wet, dry = f[0], f[1]
        s = dfx._norm(x)
        y, states = dfx.phaser_apply(s, coefs, states, ff)
        return dfx.to_int_samples(dry * s + wet * y, dpcm.width_of(x)), \
            states
    return body


class StreamingPhaser(_Processor):
    """Chunked twin of ``Sample.phaser``: per-stage biquad states carry
    across chunks; the coefficient grids come from the same host
    absolute-frame derivation (``ops.coeffs.phaser_coeff_grids``), so the
    sweep stays aligned at any chunk size or seek.  Sweep floors below
    ~120 Hz run the float-float scan (``ops.coeffs.phaser_wants_ff``).
    ``wet_curve``/``dry_curve`` are host grids on the output stage;
    ``rate_curve`` becomes a host-kept cumulative u32 phase (the chorus
    rule) and ``depth_curve`` a per-frame f64 grid in the sweep position.
    Spec: goldref.effects.phaser."""

    def __init__(self, samplerate: int, nchannels: int, rate: float = 0.5,
                 depth: float = 1.0, min_freq: float = 300.0,
                 max_freq: float = 3000.0, stages: int = 4,
                 q: float = 0.7071, wet: float = 0.5, dry: float = 1.0,
                 wet_curve=None, dry_curve=None, rate_curve=None,
                 depth_curve=None, tickf: float = 0.0,
                 start_frame: int = 0, device="cuda"):
        self.device = resolve(device)
        if not 1 <= int(stages) <= 12:
            raise ValueError("phaser stages must be in [1, 12]")
        if min_freq < 30.0 or max_freq <= min_freq:
            raise ValueError("phaser needs 30 <= min_freq < max_freq")
        self._sr = samplerate
        self._params = (float(rate), float(depth), float(min_freq),
                        float(max_freq), float(q))
        self._ff = C.phaser_wants_ff(min_freq)
        states = tuple(_zero_state(nchannels, self._ff, self.device)
                       for _ in range(int(stages)))
        self._wet, self._dry = float(wet), float(dry)
        _require_tickf(tickf, wet_curve, dry_curve, rate_curve,
                       depth_curve)
        self._curves = (wet_curve, dry_curve)
        self._swept = any(c is not None for c in self._curves)
        self._rate_curve = rate_curve
        self._depth_curve = depth_curve
        self._n0 = int(start_frame)
        self._tickf = float(tickf)
        self._p_carry = 0
        if rate_curve is not None and start_frame:
            self._p_carry = _lfo_seek_carry(rate_curve, start_frame, tickf,
                                            samplerate)
        self.tail_frames = 0
        flags = (int(stages), self._ff, self._swept)
        self._flat, self._prog = _program("phaser", flags, states,
                                          _phaser_body(*flags), self.device)
        self._carry = self._flat.pack(states)

    def process(self, x: torch.Tensor) -> torch.Tensor:
        dev = self.device
        ff = self._ff
        n = int(x.shape[0])
        rate, depth, fmin, fmax, q = self._params
        gd = np.float64 if ff else np.float32
        if self._rate_curve is not None or self._depth_curve is not None:
            if self._rate_curve is not None:
                inc = C.chorus_inc_grid(C.curve_grid(
                    self._rate_curve, self._n0, n, self._tickf), self._sr)
                P, self._p_carry = C.chorus_phase_grid(inc, self._p_carry)
            else:
                P = C.static_phase(self._n0, n, self._sr, rate)
            dgrid = (C.curve_grid(self._depth_curve, self._n0, n,
                                  self._tickf)
                     if self._depth_curve is not None
                     else np.full(n, depth, np.float64))
            grids = C.phaser_coeff_grids_swept(P, dgrid, fmin, fmax, q,
                                               self._sr, dtype=gd)
        else:
            grids = C.phaser_coeff_grids(self._n0, n, self._sr, rate, depth,
                                         fmin, fmax, q, dtype=gd)
        coefs = _grid_coefs(grids, ff, dev)
        wd = ()
        if self._swept:
            wc, dc = self._curves
            wd = (_grid(C.curve_grid(wc, self._n0, n, self._tickf)
                        if wc is not None else np.full(n, self._wet), dev),
                  _grid(C.curve_grid(dc, self._n0, n, self._tickf)
                        if dc is not None else np.full(n, self._dry), dev))
        self._n0 += n
        return self._run(x, coefs, wd, f=(self._wet, self._dry))


def _lfo_gain_body(apply):
    def body(x, state, grid, f, i):
        return apply(x, grid), state
    return body


class _StreamingLFOGain(_Processor):
    """Shared chunked twin of the host-grid LFO gain effects (tremolo,
    autopan): the grid derives at absolute frames (static rate: stateless,
    seek-exact) or from a host-kept cumulative u32 phase (rate automation:
    the chorus rule, with the seek replayed in slabs); depth curves are
    per-frame grids.  Subclasses pick the grid function and the applier."""

    @staticmethod
    def _grid(P, depth):
        raise NotImplementedError

    @staticmethod
    def _apply(x, grid):
        raise NotImplementedError

    def __init__(self, samplerate: int, nchannels: int, rate: float,
                 depth: float, rate_curve=None, depth_curve=None,
                 tickf: float = 0.0, start_frame: int = 0, device="cuda"):
        self.device = resolve(device)
        if not 0.0 <= depth <= 1.0:
            raise ValueError("depth must be in [0, 1]")
        if not 0.0 < rate <= 20.0:
            raise ValueError("rate must be in (0, 20] Hz")
        self._sr = samplerate
        self._rate, self._depth = float(rate), float(depth)
        _require_tickf(tickf, rate_curve, depth_curve)
        self._rate_curve = rate_curve
        self._depth_curve = depth_curve
        self._tickf = float(tickf)
        self._n0 = int(start_frame)
        self._p_carry = 0
        self.tail_frames = 0
        if rate_curve is not None and start_frame:
            self._p_carry = _lfo_seek_carry(rate_curve, start_frame, tickf,
                                            samplerate)
        self._flat, self._prog = _program(
            type(self).__name__, (), (), _lfo_gain_body(self._apply),
            self.device)
        self._carry = self._flat.pack(())

    def process(self, x: torch.Tensor) -> torch.Tensor:
        n = int(x.shape[0])
        if self._rate_curve is not None:
            inc = C.chorus_inc_grid(
                C.curve_grid(self._rate_curve, self._n0, n, self._tickf),
                self._sr)
            P, self._p_carry = C.chorus_phase_grid(inc, self._p_carry)
        else:
            P = C.static_phase(self._n0, n, self._sr, self._rate)
        depth = (C.curve_grid(self._depth_curve, self._n0, n, self._tickf)
                 .astype(np.float32)
                 if self._depth_curve is not None else self._depth)
        grid = _grid(self._grid(P, depth), self.device)
        self._n0 += n
        return self._run(x, grid)


class StreamingTremolo(_StreamingLFOGain):
    """Chunked twin of ``Sample.tremolo`` (fx.tremolo.rate/.depth
    automation; spec goldref.effects.tremolo)."""

    _grid = staticmethod(C.tremolo_gain_grid)
    _apply = staticmethod(dfx.tremolo)

    def __init__(self, samplerate: int, nchannels: int, rate: float = 5.0,
                 depth: float = 0.5, **kw):
        super().__init__(samplerate, nchannels, rate, depth, **kw)


class StreamingAutopan(_StreamingLFOGain):
    """Chunked twin of ``Sample.autopan`` (fx.autopan.rate/.depth
    automation; spec goldref.effects.autopan)."""

    _grid = staticmethod(C.autopan_pan_grid)
    _apply = staticmethod(dfx.autopan)

    def __init__(self, samplerate: int, nchannels: int, rate: float = 0.5,
                 depth: float = 1.0, **kw):
        if nchannels != 2:
            raise ValueError("[fx] autopan needs a stereo song")
        super().__init__(samplerate, nchannels, rate, depth, **kw)


# ---------------------------------------------------------------------------
# The chain and the .ini spec
# ---------------------------------------------------------------------------

#: effect name -> (allowed params, params that are not plain floats)
FX_PARAMS: Dict[str, Tuple[Tuple[str, ...], Dict[str, type]]] = {
    "compress": (("threshold_db", "ratio", "attack", "release", "makeup_db",
                  "knee_db", "sidechain"),
                 {"sidechain": str}),
    "reverb": (("roomsize", "damping", "wet", "dry", "width", "tail"), {}),
    "chorus": (("rate", "rate_beats", "depth", "delay", "voices", "wet",
                "dry"),
               {"voices": int}),
    "convolve": (("ir", "wet", "dry"), {"ir": str}),
    "filter": (("kind", "cutoff", "q", "gain_db"), {"kind": str}),
    "eq": (("low_db", "mid_db", "high_db", "low_freq", "mid_freq",
            "mid_q", "high_freq"), {}),
    "gate": (("threshold_db", "range_db", "attack", "release"), {}),
    "echo": (("delay", "beats", "feedback", "wet", "dry", "tail"), {}),
    "width": (("amount",), {}),
    "limiter": (("ceiling_db", "release", "lookahead"), {}),
    "phaser": (("rate", "rate_beats", "depth", "min_freq", "max_freq",
                "stages", "q", "wet", "dry"), {"stages": int}),
    "tremolo": (("rate", "rate_beats", "depth"), {}),
    "autopan": (("rate", "rate_beats", "depth"), {}),
}

#: effects whose streaming twin withholds lookahead frames (variable-length
#: process() output) -- master-chain only, rejected on fixed-size track buses
HOLDBACK_FX = ("limiter",)

FILTER_KINDS = ("lowpass", "highpass", "bandpass",
                "lowshelf", "highshelf", "peaking")


def validate_fx_params(name: str, params: dict) -> dict:
    """Validate one effect's parameter dict against FX_PARAMS (keys and
    value types); returns the coerced dict.  Shared by the ini parser and
    the programmatic ``Song.add_fx``."""
    if name not in FX_PARAMS:
        raise ValueError(f"unknown effect {name!r} in [fx] "
                         f"(have: {', '.join(sorted(FX_PARAMS))})")
    allowed, types = FX_PARAMS[name]
    out: dict = {}
    for k, v in params.items():
        if k not in allowed:
            raise ValueError(f"[fx] {name}: unknown parameter {k!r} "
                             f"(have: {', '.join(allowed)})")
        t = types.get(k, float)
        out[k] = v if t is str else t(v)
    if name == "convolve" and "ir" not in out:
        raise ValueError("[fx] convolve needs ir=<wav file>")
    if name == "filter":
        if not {"kind", "cutoff"} <= set(out):
            raise ValueError("[fx] filter needs kind= and cutoff=")
        if out["kind"] not in FILTER_KINDS:
            raise ValueError(f"[fx] filter: unknown kind {out['kind']!r}")
    if name == "echo":
        if ("delay" in out) == ("beats" in out):
            raise ValueError("[fx] echo needs exactly one of delay= "
                             "(seconds) or beats= (tempo-synced)")
    if name == "width" and "amount" not in out:
        raise ValueError("[fx] width needs amount=")
    if name in ("chorus", "phaser", "tremolo", "autopan") \
            and "rate" in out and "rate_beats" in out:
        raise ValueError(f"[fx] {name}: give rate= Hz or rate_beats= "
                         f"(tempo-synced), not both")
    return out


def parse_fx_items(items: Sequence[Tuple[str, str]]) -> List[Tuple[str, dict]]:
    """Parse ``[fx]`` section items: each value is whitespace-separated
    ``key=value`` pairs.  Pure parsing: ``ir`` stays a filename string, so
    that callers control path resolution."""
    out: List[Tuple[str, dict]] = []
    for name, valstr in items:
        params: dict = {}
        for tok in valstr.split():
            if "=" not in tok:
                raise ValueError(f"[fx] {name}: expected key=value, "
                                 f"got {tok!r}")
            k, v = tok.split("=", 1)
            params[k] = v
        out.append((name, validate_fx_params(name, params)))
    return out


def _fx_curves(automation):
    """The automation curves the fx machinery understands, parsed once --
    shared by FxChain (streaming) and run_fx_chain_ops (offline) so the two
    paths cannot drift apart when a key is added."""
    auto = automation or {}
    return dict(
        cutoff_curve=auto.get("fx.filter.cutoff"),
        rev_wet=auto.get("fx.reverb.wet"),
        rev_dry=auto.get("fx.reverb.dry"),
        rev_room=auto.get("fx.reverb.roomsize"),
        cho_wet=auto.get("fx.chorus.wet"),
        cho_dry=auto.get("fx.chorus.dry"),
        cho_rate=auto.get("fx.chorus.rate"),
        cho_depth=auto.get("fx.chorus.depth"),
        comp_curves=dict(
            makeup_curve=auto.get("fx.compress.makeup_db"),
            threshold_curve=auto.get("fx.compress.threshold_db"),
            ratio_curve=auto.get("fx.compress.ratio"),
            attack_curve=auto.get("fx.compress.attack"),
            release_curve=auto.get("fx.compress.release"),
            knee_curve=auto.get("fx.compress.knee_db")),
        gate_thr=auto.get("fx.gate.threshold_db"),
        eq_low=auto.get("fx.eq.low_db"),
        eq_mid=auto.get("fx.eq.mid_db"),
        eq_high=auto.get("fx.eq.high_db"),
        echo_fb=auto.get("fx.echo.feedback"),
        echo_wet=auto.get("fx.echo.wet"),
        echo_dry=auto.get("fx.echo.dry"),
        width_amt=auto.get("fx.width.amount"),
        lim_ceil=auto.get("fx.limiter.ceiling_db"),
        lim_rel=auto.get("fx.limiter.release"),
        pha_wet=auto.get("fx.phaser.wet"),
        pha_dry=auto.get("fx.phaser.dry"),
        pha_rate=auto.get("fx.phaser.rate"),
        pha_depth=auto.get("fx.phaser.depth"),
        trem_rate=auto.get("fx.tremolo.rate"),
        trem_depth=auto.get("fx.tremolo.depth"),
        ap_rate=auto.get("fx.autopan.rate"),
        ap_depth=auto.get("fx.autopan.depth"),
    )


def _require_tickf(tickf: float, *curves):
    """Guard the curve time base: a curve with the default tickf=0 would
    silently freeze at its last breakpoint (n/0 = inf in the interp)."""
    if any(c is not None for c in curves) and not tickf > 0.0:
        raise ValueError("automation curves need tickf > 0 (the frames "
                         "per tick that curve ticks are measured in)")


def _automated_processor(name: str, p: dict, cv: dict, samplerate: int,
                         nchannels: int, tickf: float, start_frame: int,
                         device, key_fn=None):
    """The processor of entry (name, p) when automation reaches it (or, for
    the compressor, a sidechain key), else None: one place builds the
    automated processors for the streaming chain and the offline ops."""
    kw = dict(tickf=tickf, start_frame=start_frame, device=device)
    if name == "compress":
        curves = cv["comp_curves"]
        swept = any(v is not None for v in curves.values())
        if key_fn is not None and swept:
            # the offline sidechain op takes no curves: keep the two
            # paths' capabilities identical
            raise ValueError("sidechain compression cannot be combined "
                             "with fx.compress.* automation curves (pick "
                             "one)")
        if swept or key_fn is not None:
            return StreamingCompressor(samplerate, key_fn=key_fn, **curves,
                                       **p, **kw)
    elif name == "filter" and cv["cutoff_curve"] is not None:
        # the curve replaces the entry's static cutoff; the gain kinds
        # ride host-derived frequency grids (they carry gain_db)
        if p["kind"] in ("lowshelf", "highshelf", "peaking"):
            return SweptGainKindBiquad(samplerate, nchannels, p["kind"],
                                       p.get("q", 0.7071),
                                       p.get("gain_db", 0.0),
                                       cv["cutoff_curve"], **kw)
        return SweptStreamingBiquad(samplerate, nchannels, p["kind"],
                                    p.get("q", 0.7071), cv["cutoff_curve"],
                                    **kw)
    elif name == "eq":
        ec = (cv["eq_low"], cv["eq_mid"], cv["eq_high"])
        if any(c is not None for c in ec):
            return StreamingEQ(samplerate, nchannels, low_curve=ec[0],
                               mid_curve=ec[1], high_curve=ec[2], **p, **kw)
    elif name == "gate" and cv["gate_thr"] is not None:
        return StreamingGate(samplerate, threshold_curve=cv["gate_thr"], **p,
                             **kw)
    elif name == "reverb":
        rc = (cv["rev_wet"], cv["rev_dry"], cv["rev_room"])
        if any(c is not None for c in rc):
            return StreamingReverb(samplerate, nchannels, wet_curve=rc[0],
                                   dry_curve=rc[1], roomsize_curve=rc[2],
                                   **p, **kw)
    elif name == "chorus":
        cc = (cv["cho_wet"], cv["cho_dry"], cv["cho_rate"], cv["cho_depth"])
        if any(c is not None for c in cc):
            return StreamingChorus(samplerate, nchannels, wet_curve=cc[0],
                                   dry_curve=cc[1], rate_curve=cc[2],
                                   depth_curve=cc[3], **p, **kw)
    elif name == "echo":
        ec = (cv["echo_fb"], cv["echo_wet"], cv["echo_dry"])
        if any(c is not None for c in ec):
            return StreamingFeedbackEcho(samplerate, nchannels,
                                         feedback_curve=ec[0],
                                         wet_curve=ec[1], dry_curve=ec[2],
                                         **p, **kw)
    elif name == "width" and cv["width_amt"] is not None:
        return StreamingWidth(samplerate, nchannels,
                              amount_curve=cv["width_amt"], **p, **kw)
    elif name == "limiter":
        if cv["lim_ceil"] is not None or cv["lim_rel"] is not None:
            return StreamingLimiter(samplerate, nchannels,
                                    ceiling_curve=cv["lim_ceil"],
                                    release_curve=cv["lim_rel"], **p, **kw)
    elif name == "phaser":
        pc = (cv["pha_wet"], cv["pha_dry"], cv["pha_rate"], cv["pha_depth"])
        if any(c is not None for c in pc):
            return StreamingPhaser(samplerate, nchannels, wet_curve=pc[0],
                                   dry_curve=pc[1], rate_curve=pc[2],
                                   depth_curve=pc[3], **p, **kw)
    elif name in ("tremolo", "autopan"):
        rc = cv["trem_rate" if name == "tremolo" else "ap_rate"]
        dc = cv["trem_depth" if name == "tremolo" else "ap_depth"]
        if rc is not None or dc is not None:
            cls = StreamingTremolo if name == "tremolo" else StreamingAutopan
            return cls(samplerate, nchannels, rate_curve=rc, depth_curve=dc,
                       **p, **kw)
    return None


class FxChain:
    """An ordered effects chain for the streaming path, built from the
    parsed ``[fx]`` spec plus resolved IR samples; processes int chunks in
    order, carrying each effect's state on ``device``.  ``tail_frames`` is
    the silence to feed after the programme so that reverb and convolution
    tails drain (each effect's tail also rings through the effects after
    it); ``flush_frames`` the extra silence the holdback limiter needs.

    ``sidechain_keys``: name -> ``key_fn(n0, n) -> int16 [n, ch]``
    providers, consumed by ``compress`` entries with ``sidechain=name``
    (the song layer passes each drum instrument's own hits bus)."""

    def __init__(self, fx: Sequence[Tuple[str, dict]], samplerate: int,
                 nchannels: int,
                 ir_samples: Optional[Dict[str, "object"]] = None,
                 automation: Optional[Dict[str, list]] = None,
                 tickf: float = 0.0, start_frame: int = 0,
                 sidechain_keys: Optional[Dict[str, "object"]] = None,
                 device="cuda"):
        self.device = resolve(device)
        dev = self.device
        cv = _fx_curves(automation)
        self.processors = []
        for name, p in fx:
            q = dict(p)
            key_fn = None
            if name == "compress":
                sc = q.pop("sidechain", None)
                if sc is not None:
                    key_fn = (sidechain_keys or {}).get(sc)
                    if key_fn is None:
                        raise ValueError(
                            f"compress sidechain={sc!r}: no key provider "
                            f"(the song layer supplies drum-instrument "
                            f"buses)")
            proc = _automated_processor(name, q, cv, samplerate, nchannels,
                                        tickf, start_frame, dev, key_fn)
            if proc is None:
                proc = self._static(name, q, samplerate, nchannels,
                                    ir_samples, start_frame, dev)
            self.processors.append(proc)
        # the one tail/flush authority, shared with apply_fx_sample
        self.tail_frames = chain_tail_frames(fx, samplerate, ir_samples)
        self.flush_frames = chain_flush_frames(fx, samplerate)
        self.samplerate = samplerate
        self.nchannels = nchannels

    @staticmethod
    def _static(name: str, q: dict, samplerate: int, nchannels: int,
                ir_samples, start_frame: int, dev):
        """The processor of an entry that no automation reaches."""
        if name == "compress":
            return StreamingCompressor(samplerate, device=dev, **q)
        if name == "filter":
            return StreamingBiquad(samplerate, nchannels, device=dev, **q)
        if name == "convolve":
            ir = (ir_samples or {})[q.pop("ir")]
            # the contract Sample.convolve enforces: a Song renders on both
            # paths or fails on both
            if ir.samplerate != samplerate:
                raise ValueError("impulse response samplerate mismatch")
            if ir.nchannels not in (1, nchannels):
                raise ValueError("impulse response channel mismatch")
            irn = (ir.get_frame_array().astype(np.float32)
                   / np.float32(dpcm.MAXVAL[ir.samplewidth]))
            return StreamingConvolver(irn, device=dev, **q)
        if name in ("tremolo", "autopan"):
            cls = StreamingTremolo if name == "tremolo" else StreamingAutopan
            return cls(samplerate, nchannels, start_frame=start_frame,
                       device=dev, **q)
        cls = {"eq": StreamingEQ, "reverb": StreamingReverb,
               "chorus": StreamingChorus, "echo": StreamingFeedbackEcho,
               "width": StreamingWidth, "limiter": StreamingLimiter,
               "phaser": StreamingPhaser}.get(name)
        if cls is not None:
            return cls(samplerate, nchannels, device=dev, **q)
        if name == "gate":
            return StreamingGate(samplerate, device=dev, **q)
        raise ValueError(name)                      # pragma: no cover

    @profiling.spanned("effects.fx_stream")
    def process(self, x: torch.Tensor) -> torch.Tensor:
        for p in self.processors:
            x = p.process(x)
        return x


def chain_tail_frames(fx: Sequence[Tuple[str, dict]], samplerate: int,
                      ir_samples: Optional[Dict[str, "object"]] = None) -> int:
    """Total decay tail of the chain: reverb tails + echo trains +
    convolution IR tails."""
    total = 0
    for name, p in fx:
        if name == "reverb":
            total += int(p.get("tail", DEFAULT_REVERB_TAIL) * samplerate)
        elif name == "echo":
            if "delay" not in p:
                raise ValueError("[fx] echo beats= needs a song tempo to "
                                 "resolve -- use delay= seconds here")
            total += C.echo_tail_frames(samplerate, p["delay"],
                                        p.get("feedback", 0.4),
                                        p.get("wet", 0.5), p.get("tail"))
        elif name == "convolve":
            total += (ir_samples or {})[p["ir"]].nframes - 1
    return total


def chain_flush_frames(fx: Sequence[Tuple[str, dict]],
                       samplerate: int) -> int:
    """Total lookahead holdback of the chain (HOLDBACK_FX entries): the
    extra silence to feed past the decay tail so that holdback processors
    emit their final frames; the offline path pads by the same amount and
    truncates back, so streaming == offline exactly."""
    total = 0
    for name, p in fx:
        if name == "limiter":
            total += max(1, int(p.get("lookahead", 0.005) * samplerate))
    return total


def apply_fx_sample(sample, fx: Sequence[Tuple[str, dict]],
                    ir_samples: Optional[Dict[str, "object"]] = None,
                    automation: Optional[Dict[str, list]] = None,
                    tickf: float = 0.0, sidechain_keys=None):
    """Apply the chain offline to ``sample`` (on its device) and return it.

    Chain semantics, matching the streaming FxChain and its silence feed:
    the programme is first extended by the chain's total tail, then every
    effect runs over the full extended length, so an early effect's decay
    rings through the effects after it, as a streamed signal would.
    Length-extending ops therefore run tail-less here (reverb with tail=0,
    convolve truncated back), the shared pad having reserved their decay
    room.  HOLDBACK_FX entries (the limiter) get ``chain_flush_frames`` of
    extra pad so that their lookahead reads the same upstream decay the
    stream feeds them, and truncate it back."""
    tail = chain_tail_frames(fx, sample.samplerate, ir_samples)
    flush = chain_flush_frames(fx, sample.samplerate)
    sample.pad_frames(tail + flush)
    return run_fx_chain_ops(sample, fx, ir_samples, automation=automation,
                            tickf=tickf, sidechain_keys=sidechain_keys)


@profiling.spanned("effects.fx_offline")
def run_fx_chain_ops(sample, fx: Sequence[Tuple[str, dict]],
                     ir_samples: Optional[Dict[str, "object"]] = None,
                     automation: Optional[Dict[str, list]] = None,
                     tickf: float = 0.0, sidechain_keys=None):
    """The op loop of ``apply_fx_sample`` without the tail pad, for callers
    that already reserved the chain's decay room in ``sample`` (a song's
    per-track bus, rendered to the padded song length).  Length is kept.

    Automated entries run the streaming processor over the whole signal
    (n0 = 0), the same code the streaming path runs; everything else runs
    the ``Sample`` op.  ``sidechain_keys`` maps an instrument name to a
    whole-length key ``Sample``."""
    cv = _fx_curves(automation)
    sr, nch, dev = sample.samplerate, sample.nchannels, sample.device
    for name, p in fx:
        q = dict(p)
        if name == "compress" and q.get("sidechain"):
            # ducking: the key is a whole-length Sample of the named
            # instrument's own hits bus
            sc = q.pop("sidechain")
            key = (sidechain_keys or {}).get(sc)
            if key is None:
                raise ValueError(
                    f"compress sidechain={sc!r}: no key provider")
            if any(v is not None for v in cv["comp_curves"].values()):
                raise ValueError(
                    "sidechain compression cannot be combined with "
                    "fx.compress.* automation curves (pick one)")
            sample.compress(sidechain=key, **q)
            continue
        if name == "reverb":
            q["tail"] = 0.0
        proc = _automated_processor(name, q, cv, sr, nch, tickf, 0, dev)
        if name == "limiter" and proc is None:
            # the streaming holdback processor over the whole signal
            # (apply_fx_sample padded the flush room): it emits len - L
            # frames, which truncates the pad back, as the stream does
            proc = StreamingLimiter(sr, nch, device=dev, **q)
        if proc is not None:
            sample._replace_frames(proc.process(sample.torch_frames))
        elif name == "convolve":
            ir = (ir_samples or {})[q.pop("ir")]
            n = sample.nframes
            sample.convolve(ir, **q).truncate_frames(n)
        elif name == "echo":
            q.pop("tail", None)
            # the shared pad already reserved the echo's decay room
            sample.feedback_echo(q.pop("delay"), tail=0.0, **q)
        elif name == "width":
            sample.stereo_width(q["amount"])
        else:
            getattr(sample, name)(**q)
    return sample
