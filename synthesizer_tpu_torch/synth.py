"""WaveSynth — the eager waveform renderer (port of
``synthesizer_tpu.synth``).

One method per waveform returning a finished
:class:`~synthesizer_tpu_torch.sample.Sample`, plus ``*_gen``
chunk-generator variants for realtime use, and the note/key -> frequency
helpers.  Every method lowers the patch, renders it block after block on
the device, quantizes to ints there and wraps the tensor as a
device-resident Sample.  The device is the card unless the caller passes
``device="cpu"``.
"""

from __future__ import annotations

from typing import Iterator, Optional, Sequence, Tuple

from . import params
from .models import graph as G
from .models import spec as S
from .oscillators import Oscillator
from .sample import Sample
from .utils.device import resolve as _device

__all__ = ["WaveSynth", "key_freq", "note_freq"]

_NOTES = {"C": 0, "C#": 1, "DB": 1, "D": 2, "D#": 3, "EB": 3, "E": 4,
          "F": 5, "F#": 6, "GB": 6, "G": 7, "G#": 8, "AB": 8, "A": 9,
          "A#": 10, "BB": 10, "B": 11}


def key_freq(key_number: int, a4: float = 440.0) -> float:
    """Piano key number (A4 = key 49) -> frequency in Hz."""
    return float(2.0 ** ((key_number - 49) / 12.0) * a4)


def note_freq(note: str, octave: Optional[int] = None, a4: float = 440.0) -> float:
    """Note name -> frequency: note_freq("A", 4), note_freq("C#5")."""
    original = note
    note = note.strip().upper()
    try:
        if octave is None:
            idx = 1
            while idx < len(note) and not note[idx].isdigit() and note[idx] != "-":
                idx += 1
            octave = int(note[idx:])
            note = note[:idx]
        semitone = _NOTES[note]
    except (KeyError, ValueError, IndexError):
        raise ValueError(
            f"invalid note name {original!r} (expected e.g. 'C4', 'F#3', 'Eb2')"
        ) from None
    # key 49 == A4 == semitone 9 of octave 4; keys count from A0 == key 1
    key = (octave - 4) * 12 + (semitone - 9) + 49
    return key_freq(key, a4)


class WaveSynth:
    """Eager waveform renderer producing mono Samples at a fixed format.

    The ``fm_lfo`` / ``pwm_lfo`` arguments accept an Oscillator or a raw
    spec node.  ``*_gen`` variants yield endless chunked Samples for the
    realtime mixer (on the card chunk k+1 renders while k plays: launches
    are asynchronous).
    """

    def __init__(self, samplerate: int = 0, samplewidth: int = 0,
                 device="cuda"):
        self.samplerate = samplerate or params.norm_samplerate
        self.samplewidth = samplewidth or params.norm_samplewidth
        self.device = _device(device)

    # -- internal ----------------------------------------------------------

    def _render(self, node: S.Node, duration: float, name: str) -> Sample:
        n = int(duration * self.samplerate)
        return Sample.from_patch(node, n, self.samplerate, self.samplewidth,
                                 name, device=self.device)

    def _gen(self, node: S.Node, blocksize: int = 0) -> Iterator[Sample]:
        bs = blocksize or params.norm_osc_blocksize
        # the chunks stay on the device: no trip through the host
        for block in G.device_block_stream(node, self.samplerate, bs,
                                           self.samplewidth, self.device):
            yield Sample.from_torch(block[:, None], self.samplerate,
                                    self.samplewidth, "gen")

    @staticmethod
    def _spec(osc) -> Optional[S.Node]:
        if osc is None:
            return None
        return osc.spec if isinstance(osc, Oscillator) else osc

    def _osc(self, kind: str, frequency: float, amplitude: float, phase: float,
             bias: float, fm_lfo=None, pwm_lfo=None, **kw) -> S.Node:
        return S.Osc(kind, frequency, amplitude, phase, bias,
                     fm_lfo=self._spec(fm_lfo), pwm_lfo=self._spec(pwm_lfo), **kw)

    # -- waveforms -----------------------------------------------------------

    def sine(self, frequency: float, duration: float, amplitude: float = 0.9999,
             phase: float = 0.0, bias: float = 0.0, fm_lfo=None) -> Sample:
        return self._render(self._osc("sine", frequency, amplitude, phase, bias,
                                      fm_lfo), duration, "sine")

    def sine_gen(self, frequency: float, amplitude: float = 0.9999,
                 phase: float = 0.0, bias: float = 0.0, fm_lfo=None) -> Iterator[Sample]:
        return self._gen(self._osc("sine", frequency, amplitude, phase, bias, fm_lfo))

    def square(self, frequency: float, duration: float, amplitude: float = 0.75,
               phase: float = 0.0, bias: float = 0.0, fm_lfo=None) -> Sample:
        return self._render(self._osc("square", frequency, amplitude, phase, bias,
                                      fm_lfo), duration, "square")

    def square_gen(self, frequency: float, amplitude: float = 0.75,
                   phase: float = 0.0, bias: float = 0.0, fm_lfo=None) -> Iterator[Sample]:
        return self._gen(self._osc("square", frequency, amplitude, phase, bias, fm_lfo))

    def square_h(self, frequency: float, duration: float, num_harmonics: int = 16,
                 amplitude: float = 0.9999, phase: float = 0.0, bias: float = 0.0,
                 fm_lfo=None) -> Sample:
        return self._render(self._osc("square_h", frequency, amplitude, phase, bias,
                                      fm_lfo, num_harmonics=num_harmonics),
                            duration, "square_h")

    def square_h_gen(self, frequency: float, num_harmonics: int = 16,
                     amplitude: float = 0.9999, phase: float = 0.0,
                     bias: float = 0.0, fm_lfo=None) -> Iterator[Sample]:
        return self._gen(self._osc("square_h", frequency, amplitude, phase, bias,
                                   fm_lfo, num_harmonics=num_harmonics))

    def triangle(self, frequency: float, duration: float, amplitude: float = 0.9999,
                 phase: float = 0.0, bias: float = 0.0, fm_lfo=None) -> Sample:
        return self._render(self._osc("triangle", frequency, amplitude, phase, bias,
                                      fm_lfo), duration, "triangle")

    def triangle_gen(self, frequency: float, amplitude: float = 0.9999,
                     phase: float = 0.0, bias: float = 0.0, fm_lfo=None) -> Iterator[Sample]:
        return self._gen(self._osc("triangle", frequency, amplitude, phase, bias, fm_lfo))

    def sawtooth(self, frequency: float, duration: float, amplitude: float = 0.75,
                 phase: float = 0.0, bias: float = 0.0, fm_lfo=None) -> Sample:
        return self._render(self._osc("sawtooth", frequency, amplitude, phase, bias,
                                      fm_lfo), duration, "sawtooth")

    def sawtooth_gen(self, frequency: float, amplitude: float = 0.75,
                     phase: float = 0.0, bias: float = 0.0, fm_lfo=None) -> Iterator[Sample]:
        return self._gen(self._osc("sawtooth", frequency, amplitude, phase, bias, fm_lfo))

    def sawtooth_h(self, frequency: float, duration: float, num_harmonics: int = 16,
                   amplitude: float = 0.5, phase: float = 0.0, bias: float = 0.0,
                   fm_lfo=None) -> Sample:
        return self._render(self._osc("sawtooth_h", frequency, amplitude, phase, bias,
                                      fm_lfo, num_harmonics=num_harmonics),
                            duration, "sawtooth_h")

    def sawtooth_h_gen(self, frequency: float, num_harmonics: int = 16,
                       amplitude: float = 0.5, phase: float = 0.0,
                       bias: float = 0.0, fm_lfo=None) -> Iterator[Sample]:
        return self._gen(self._osc("sawtooth_h", frequency, amplitude, phase, bias,
                                   fm_lfo, num_harmonics=num_harmonics))

    def sawtooth_bl(self, frequency: float, duration: float,
                    amplitude: float = 0.75, phase: float = 0.0,
                    bias: float = 0.0) -> Sample:
        """polyBLEP-bandlimited sawtooth (aliasing-suppressed)."""
        return self._render(self._osc("sawtooth_bl", frequency, amplitude,
                                      phase, bias), duration, "sawtooth_bl")

    def square_bl(self, frequency: float, duration: float,
                  amplitude: float = 0.75, phase: float = 0.0,
                  bias: float = 0.0) -> Sample:
        """polyBLEP-bandlimited square (aliasing-suppressed)."""
        return self._render(self._osc("square_bl", frequency, amplitude,
                                      phase, bias), duration, "square_bl")

    def pulse(self, frequency: float, duration: float, amplitude: float = 0.75,
              phase: float = 0.0, bias: float = 0.0, pulse_width: float = 0.1,
              fm_lfo=None, pwm_lfo=None) -> Sample:
        return self._render(self._osc("pulse", frequency, amplitude, phase, bias,
                                      fm_lfo, pwm_lfo, pulse_width=pulse_width),
                            duration, "pulse")

    def pulse_gen(self, frequency: float, amplitude: float = 0.75, phase: float = 0.0,
                  bias: float = 0.0, pulse_width: float = 0.1, fm_lfo=None,
                  pwm_lfo=None) -> Iterator[Sample]:
        return self._gen(self._osc("pulse", frequency, amplitude, phase, bias,
                                   fm_lfo, pwm_lfo, pulse_width=pulse_width))

    def harmonics(self, frequency: float, duration: float,
                  harmonics: Sequence[Tuple[float, float]],
                  amplitude: float = 0.5, phase: float = 0.0, bias: float = 0.0,
                  fm_lfo=None) -> Sample:
        node = self._osc("harmonics", frequency, amplitude, phase, bias, fm_lfo,
                         harmonics=tuple((float(r), float(a)) for r, a in harmonics))
        return self._render(node, duration, "harmonics")

    def harmonics_gen(self, frequency: float,
                      harmonics: Sequence[Tuple[float, float]],
                      amplitude: float = 0.5, phase: float = 0.0, bias: float = 0.0,
                      fm_lfo=None) -> Iterator[Sample]:
        node = self._osc("harmonics", frequency, amplitude, phase, bias, fm_lfo,
                         harmonics=tuple((float(r), float(a)) for r, a in harmonics))
        return self._gen(node)

    def wavetable(self, frequency: float, duration: float, table,
                  amplitude: float = 0.9999, phase: float = 0.0,
                  bias: float = 0.0, fm_lfo=None) -> Sample:
        """Single-cycle wavetable render (beyond-reference waveform)."""
        node = self._osc("wavetable", frequency, amplitude, phase, bias,
                         fm_lfo, table=tuple(float(v) for v in table))
        return self._render(node, duration, "wavetable")

    def wavetable_gen(self, frequency: float, table,
                      amplitude: float = 0.9999, phase: float = 0.0,
                      bias: float = 0.0, fm_lfo=None) -> Iterator[Sample]:
        node = self._osc("wavetable", frequency, amplitude, phase, bias,
                         fm_lfo, table=tuple(float(v) for v in table))
        return self._gen(node)

    def pluck(self, frequency: float, duration: float = 1.0,
              amplitude: float = 0.9999, phase: float = 0.0,
              bias: float = 0.0, num_harmonics: int = 24, seed: int = 0,
              damping: float = 1.0) -> Sample:
        """Karplus-Strong plucked string (beyond-reference; spectral KS —
        see oscillators.Pluck / goldref/spec.py for the numeric spec)."""
        node = S.Osc("pluck", frequency, amplitude, phase, bias,
                     num_harmonics=num_harmonics, seed=seed, damping=damping)
        return self._render(node, duration, "pluck")

    def pluck_gen(self, frequency: float, amplitude: float = 0.9999,
                  phase: float = 0.0, bias: float = 0.0,
                  num_harmonics: int = 24, seed: int = 0,
                  damping: float = 1.0) -> Iterator[Sample]:
        node = S.Osc("pluck", frequency, amplitude, phase, bias,
                     num_harmonics=num_harmonics, seed=seed, damping=damping)
        return self._gen(node)

    def white_noise(self, frequency: float = 0.0, duration: float = 1.0,
                    amplitude: float = 0.9999, bias: float = 0.0,
                    seed: int = 0) -> Sample:
        node = S.Osc("white_noise", frequency or self.samplerate, amplitude,
                     0.0, bias, seed=seed)
        return self._render(node, duration, "white_noise")

    def white_noise_gen(self, frequency: float = 0.0, amplitude: float = 0.9999,
                        bias: float = 0.0, seed: int = 0) -> Iterator[Sample]:
        node = S.Osc("white_noise", frequency or self.samplerate, amplitude,
                     0.0, bias, seed=seed)
        return self._gen(node)

    def semicircle(self, frequency: float, duration: float, amplitude: float = 0.9999,
                   phase: float = 0.0, bias: float = 0.0, fm_lfo=None) -> Sample:
        return self._render(self._osc("semicircle", frequency, amplitude, phase,
                                      bias, fm_lfo), duration, "semicircle")

    def semicircle_gen(self, frequency: float, amplitude: float = 0.9999,
                       phase: float = 0.0, bias: float = 0.0, fm_lfo=None) -> Iterator[Sample]:
        return self._gen(self._osc("semicircle", frequency, amplitude, phase, bias, fm_lfo))

    def pointy(self, frequency: float, duration: float, amplitude: float = 0.9999,
               phase: float = 0.0, bias: float = 0.0, fm_lfo=None) -> Sample:
        return self._render(self._osc("pointy", frequency, amplitude, phase, bias,
                                      fm_lfo), duration, "pointy")

    def pointy_gen(self, frequency: float, amplitude: float = 0.9999,
                   phase: float = 0.0, bias: float = 0.0, fm_lfo=None) -> Iterator[Sample]:
        return self._gen(self._osc("pointy", frequency, amplitude, phase, bias, fm_lfo))

    # -- generic patch rendering -------------------------------------------------

    def render_oscillator(self, oscillator: Oscillator, duration: float,
                          name: str = "patch") -> Sample:
        """Render any oscillator/filter patch to a Sample."""
        return self._render(oscillator.spec, duration, name)

    def oscillator_gen(self, oscillator: Oscillator,
                       blocksize: int = 0) -> Iterator[Sample]:
        return self._gen(oscillator.spec, blocksize)
