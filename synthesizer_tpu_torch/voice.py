"""Gate-driven realtime voices (port of ``synthesizer_tpu.voice``).

A keyboard synth holds a note while the key is down and triggers the
envelope *release* on key-up; the offline ``EnvelopeFilter`` uses a fixed
sustain duration instead.  A :class:`RealtimeVoice` streams an
un-enveloped patch block by block on the device and applies a gate ADSR
there:

* held:     g(t) = attack ramp -> decay -> sustain_level (indefinitely)
* released: g(t) = level_at_release * (1 - (t - t_release)/release)

Release is **sample-accurate**: ``release(at_frame=k)`` starts the ramp at
exactly frame ``k`` -- the block containing it renders piecewise (held
gains before ``k``, release ramp from ``k``) in one select.  A bare
``release()`` starts the ramp at the next superblock boundary, the honest
realtime default (earlier frames may already be queued at the audio
device).  The block stream ends once the release ramp (and the echo tail)
completes, which makes the playback mixer drop the voice and fire its
ended-callback.

**Launches.**  The JAX package runs one compiled program per superblock.
Here a superblock is eager PyTorch: each op of the patch's step, the gate
and the echo is a launch of its own, and the superblock's int16 block
crosses to the host once (``utils.device.to_host``, pinned).
"""

from __future__ import annotations

import threading
from typing import Iterator, Optional

import numpy as np
import torch

from . import params
from .models import graph as G
from .ops import wave as W
from .oscillators import Oscillator
from .utils.device import resolve as _device
from .utils.device import to_host

_HELD = 2**31 - 1   # release_start sentinel: never released
_EPS = float(np.float32(1e-30))


def _f32(x) -> float:
    return float(np.float32(x))


def _gate_gains(n0: int, n: int, samplerate: int, attack: float,
                decay: float, sustain_level: float, release_start: int,
                release_level: float, release: float,
                device) -> torch.Tensor:
    """Piecewise gate envelope for one block at absolute frame ``n0`` ->
    f32 [n].

    Frames (integer index) before ``release_start`` get the held A/D/S
    curve; frames at or after it get the release ramp from
    ``release_level``.  The held/released split is an exact int64 frame
    comparison -- an f32 time comparison would lose single-frame
    resolution past ~2^22 frames.  A held voice passes ``release_start =
    _HELD``."""
    idx = n0 + torch.arange(n, dtype=torch.int64, device=device)
    t = W.div(idx.to(torch.float32), samplerate)
    a, d, sl = _f32(attack), _f32(decay), _f32(sustain_level)
    ad = _f32(np.float32(a) + np.float32(d))
    g = torch.ones((n,), dtype=torch.float32, device=device)
    if a > 0:
        g = torch.minimum(g, W.div(t, max(a, _EPS)))
    in_decay = (t >= a) & (t < ad)
    ramp = 1.0 + W.div(_f32(np.float32(sl) - np.float32(1.0)) * (t - a),
                       max(d, _EPS))
    g = torch.where(in_decay, ramp, g)
    g = torch.where(t >= ad, W.scalar(sl, device), g)
    held = torch.clamp_min(g, 0.0)
    # ramp position in whole frames (exact), then seconds in f32
    dt_rel = W.div((idx - release_start).to(torch.float32), samplerate)
    rel = torch.clamp(_f32(release_level)
                      * (1.0 - W.div(dt_rel, max(_f32(release), _EPS))),
                      0.0, 1.0)
    return torch.where(idx < release_start, held, rel)


def _echo_step(gated: torch.Tensor, tail: torch.Tensor, offsets: tuple,
               tap_gains: tuple):
    """One streaming feed-forward echo block (the math of the offline
    ``spec.Echo`` lowering): ``out = gated + sum_k g_k * gated[n - d_k]``
    with the cross-block history carried in ``tail`` [dmax] on the
    device."""
    B = gated.shape[0]
    dmax = tail.shape[0]
    buf = torch.cat([tail, gated])
    out = gated
    for dk, gk in zip(offsets, tap_gains):
        out = out + _f32(gk) * buf[dmax - dk:dmax - dk + B]
    return out, buf[-dmax:]


#: lowered voice programs keyed by the full static config and the device:
#: re-pressing a key (same patch/ADSR/echo) reuses the lowered patch
_voice_program_cache: dict = {}


def _voice_program(spec, samplerate: int, rbs: int, attack: float,
                   decay: float, sustain_level: float, release_time: float,
                   echo_offsets: tuple, echo_gains: tuple, device):
    key = (spec, samplerate, rbs, attack, decay, sustain_level,
           release_time, echo_offsets, echo_gains, device)
    entry = _voice_program_cache.get(key)
    if entry is None:
        init_state, step = G.lower(spec, samplerate, rbs, device)

        def voice_step(state, tail, n0: int, rn: int, rlevel: float):
            vals, state = step(state, n0)
            gains = _gate_gains(n0, rbs, samplerate, attack, decay,
                                sustain_level, rn, rlevel, release_time,
                                device)
            gated = vals * gains
            if echo_offsets:
                gated, tail = _echo_step(gated, tail, echo_offsets,
                                         echo_gains)
            v = torch.clamp(torch.round(gated * 32767.0), -32768,
                            32767).to(torch.int16)
            return v, state, tail

        entry = (init_state, voice_step)
        _voice_program_cache[key] = entry
    return entry


class RealtimeVoice:
    """One sounding note: streaming patch render x gate ADSR -> int16
    chunks, rendered on ``device`` (the card unless the caller passes
    ``device="cpu"``)."""

    def __init__(self, patch: Oscillator, attack: float, decay: float,
                 sustain_level: float, release: float,
                 samplerate: int = 0, blocksize: int = 0, stereo: bool = True,
                 echo: Optional[tuple] = None, lookahead_blocks: int = 1,
                 device="cuda"):
        """``echo=(after, amount, delay, decay)`` applies a feed-forward
        echo AFTER the gate envelope -- the offline order (envelope, then
        echo); the tail keeps ringing for the echo span after the release
        ramp ends.

        ``lookahead_blocks``: render N mixer blocks per device round trip
        and slice on the host.  The engine is block-size invariant, so the
        audio is bit-identical; the cost is bare-``release()`` latency (it
        takes effect at the next superblock)."""
        self.device = _device(device)
        self.samplerate = samplerate or patch.samplerate
        self.blocksize = blocksize or params.norm_frames_per_chunk
        self.lookahead = max(1, int(lookahead_blocks))
        self._rbs = self.blocksize * self.lookahead
        self.attack = float(attack)
        self.decay = float(decay)
        self.sustain_level = float(sustain_level)
        self.release_time = max(float(release), 1e-4)
        self.stereo = stereo
        self._echo_offsets: tuple = ()
        self._echo_gains: tuple = ()
        self._echo_tail = None
        if echo is not None:
            after, amount, delay, decay_g = echo
            offs, gains, g = [], [], 1.0
            for k in range(1, int(amount) + 1):
                g *= float(decay_g)
                dk = int(round(after * self.samplerate)) \
                    + k * int(round(delay * self.samplerate))
                if dk > 0:
                    offs.append(dk)
                    gains.append(np.float32(g))
            if offs:
                self._echo_offsets = tuple(offs)
                self._echo_gains = tuple(gains)
                self._echo_tail = torch.zeros((max(offs),),
                                              dtype=torch.float32,
                                              device=self.device)
        self._released = threading.Event()
        self._release_at: Optional[int] = None
        self._release_n: Optional[int] = None
        self._release_level: Optional[float] = None
        self._voice_state, self._voice_step = _voice_program(
            patch.spec, self.samplerate, self._rbs, self.attack, self.decay,
            self.sustain_level, self.release_time, self._echo_offsets,
            self._echo_gains, self.device)

    def release(self, at_frame: Optional[int] = None) -> None:
        """Key-up.  ``at_frame`` pins the ramp start to that exact absolute
        frame (sample-accurate: the containing block renders piecewise
        around it; a future frame holds the note until then).  Without it
        the ramp starts at the next block boundary -- the realtime
        default, since earlier frames may already sit in the audio device
        queue."""
        self._release_at = int(at_frame) if at_frame is not None else None
        self._released.set()

    def _held_level_at(self, n: int) -> float:
        t = n / self.samplerate
        if self.attack > 0 and t < self.attack:
            return t / self.attack
        if t < self.attack + self.decay and self.decay > 0:
            return 1.0 + (self.sustain_level - 1.0) * (t - self.attack) / self.decay
        return self.sustain_level

    def chunks(self) -> Iterator[bytes]:
        """Yield interleaved int16 frame bytes; ends after the release ramp."""
        n0 = 0
        state = self._voice_state
        tail = self._echo_tail
        while True:
            if self._release_n is None and self._released.is_set():
                rn = n0 if self._release_at is None else self._release_at
                # frames before n0 are already rendered/queued: the ramp
                # starts no earlier than n0.  An absurd at_frame is clamped
                # to "held forever", as in the reference's int32 engine
                self._release_n = min(max(int(rn), n0), _HELD - 1)
                self._release_level = self._held_level_at(self._release_n)
            if self._release_n is None:
                rn_arg, level_arg = _HELD, 1.0
            else:
                rn_arg, level_arg = self._release_n, self._release_level
            out, state, tail = self._voice_step(state, tail, n0, rn_arg,
                                                level_arg)
            sup = to_host(out)            # ONE host sync per superblock
            if self.stereo:
                sup = np.repeat(sup[:, None], 2, axis=1)
            for j in range(self.lookahead):
                yield sup[j * self.blocksize:(j + 1) * self.blocksize].tobytes()
                n0 += self.blocksize
                if n0 >= _HELD - self._rbs:
                    # ~13.5 h at 44.1 kHz: the reference's int32 frame
                    # index would wrap here -- end the stream cleanly
                    return
                if self._release_n is not None and \
                        n0 >= self._release_n \
                        + int(self.release_time * self.samplerate) \
                        + (max(self._echo_offsets) if self._echo_offsets else 0) + 1:
                    return
