"""Device-resident ``Sample`` PCM buffer (port of
``synthesizer_tpu.sample``).

A PCM sample with immutable metadata and a rebindable buffer whose
chainable ops run on an int tensor [nframes, nchannels] held in device
memory.  The numeric contract for every op is defined by
``goldref.sample.Sample``.

**Eager ops.**  The JAX package stages each op into a small IR and compiles
a whole chain into one program; in PyTorch an op computes its result at
once and rebinds the buffer, and ``from_patch`` renders at construction.
There is no IR.

**Tensors are mutable, so no op writes in place.**  Every op builds a new
tensor and rebinds ``self``'s buffer to it; ``copy`` shares the buffer, and
slices may be views of it.  What another ``Sample`` holds is therefore
never changed by an op on this one.  A tensor handed to ``from_torch`` is
wrapped without a copy: the caller must not write into it afterwards.

**The host copy.**  ``get_frame_array`` is where a result crosses to the
host.  On a CUDA sample it copies into pinned host memory
(``utils.device.to_host``) and caches the read-only view until the buffer
is rebound; on a CPU sample it is a view of the tensor.

Not ported yet (each raises ``NotImplementedError`` naming the ROADMAP
queue item it waits for): the effects-backed ops and the loudness methods,
``LevelMeter``, the resampling methods, and the compressed-audio writers.
"""

from __future__ import annotations

import os
from typing import Iterator, Optional

import numpy as np
import torch

from . import params
from .ops import pcm as dpcm
from .ops import wave as W
from .utils import wavio
from .utils.device import resolve as _device
from .utils.device import to_host

_DTYPES = dpcm.DTYPES
_NPDT = {1: np.int8, 2: np.int16, 4: np.int32}
MAXVAL = dpcm.MAXVAL
MINVAL = dpcm.MINVAL

_WAITS_FOR = {
    8: "ops/resample.py",
    10: "the effects rack (ops/effects.py, effects.py, ops/loudness.py)",
    11: "the host codecs (utils/codecs.py, flac.py, libav.py)",
}


def _not_ported(name: str, item: int) -> NotImplementedError:
    return NotImplementedError(
        f"{name} is not ported yet: it comes with {_WAITS_FOR[item]} "
        f"(ROADMAP queue 1 item {item})")


def _waits(name: str, item: int):
    """A method of the reference's ``Sample`` that this port does not have
    yet: calling it raises and names the queue item it waits for."""
    def method(self, *args, **kwargs):
        raise _not_ported(f"Sample.{name}", item)
    method.__name__ = name
    method.__doc__ = (f"Not ported yet: waits for {_WAITS_FOR[item]} "
                      f"(ROADMAP queue 1 item {item}).")
    return method


def _pan_gains(amt: torch.Tensor) -> torch.Tensor:
    """Per-frame pan amounts [n] -> per-channel gains [n, 2]."""
    la = torch.clamp_max(1.0 - amt, 1.0)
    ra = torch.clamp_max(1.0 + amt, 1.0)
    return torch.stack([la, ra], dim=-1)


class Sample:
    """A device-resident PCM sample with chainable DSP ops.

    API-compatible with the original ``Sample``: ops mutate in place (they
    rebind this sample's buffer) and return ``self`` for chaining.  The
    constructors put the frames on the card unless the caller passes
    ``device="cpu"``; a sample made from another sample or from a tensor
    stays on that tensor's device.
    """

    def __init__(self, wave_file=None, name: str = "", device="cuda"):
        dev = _device(device)
        self.name = name
        self._host_cache: Optional[np.ndarray] = None
        self._host_base: Optional[torch.Tensor] = None
        if wave_file is not None:
            frames, rate, width, nch = wavio.read_wav(wave_file)
            self._frames = torch.from_numpy(
                np.ascontiguousarray(frames)).to(dev)
            self._samplerate = rate
            self._samplewidth = width
            if isinstance(wave_file, str) and not name:
                self.name = wave_file
        else:
            self._frames = torch.zeros(
                (0, params.norm_nchannels),
                dtype=_DTYPES[params.norm_samplewidth], device=dev)
            self._samplerate = params.norm_samplerate
            self._samplewidth = params.norm_samplewidth

    # -- constructors ------------------------------------------------------------

    @classmethod
    def from_torch(cls, data: torch.Tensor, samplerate: int, samplewidth: int,
                   name: str = "") -> "Sample":
        """Wrap an existing [n, ch] int tensor (no copy; the sample lives
        on the tensor's device)."""
        if data.ndim != 2 or data.dtype != _DTYPES[samplewidth]:
            raise ValueError(
                f"from_torch needs an [n, ch] {_DTYPES[samplewidth]} tensor, "
                f"got {tuple(data.shape)} {data.dtype}")
        s = cls.__new__(cls)
        s.name = name
        s._host_cache = s._host_base = None
        s._frames = data
        s._samplerate, s._samplewidth = int(samplerate), int(samplewidth)
        return s

    @classmethod
    def from_raw_frames(cls, frames: bytes, samplewidth: int, samplerate: int,
                        nchannels: int, name: str = "",
                        device="cuda") -> "Sample":
        a = np.frombuffer(frames, dtype=_NPDT[samplewidth]).reshape(
            -1, nchannels)
        data = torch.from_numpy(a.copy()).to(_device(device))
        return cls.from_torch(data, samplerate, samplewidth, name)

    @classmethod
    def from_array(cls, array, samplerate: int, nchannels: int,
                   name: str = "", device="cuda") -> "Sample":
        """From a sequence of ints (int16 range) or floats in [-1, 1]."""
        a = np.asarray(array)
        if a.dtype.kind == "f":
            a = np.clip(np.rint(a * 32767.0), -32768, 32767).astype(np.int16)
        elif a.dtype != np.int16:
            a = a.astype(np.int16)
        return cls.from_raw_frames(a.tobytes(), 2, samplerate, nchannels,
                                   name, device)

    @classmethod
    def from_patch(cls, node, nframes: int, samplerate: int,
                   samplewidth: int, name: str = "",
                   blocksize: int = 8192, device="cuda") -> "Sample":
        """A mono Sample rendered from an oscillator patch, at once: the
        patch runs block after block on ``device`` and is quantized
        there."""
        from .models import graph as G
        vals = G.patch_values(node, int(nframes), int(samplerate),
                              int(blocksize), device)
        return cls.from_torch(G.to_int_device(vals, int(samplewidth))[:, None],
                              samplerate, samplewidth, name)

    def _replace_frames(self, data: torch.Tensor) -> "Sample":
        """Swap in new frames of the same format, in place."""
        if data.ndim != 2 or data.dtype != _DTYPES[self._samplewidth]:
            raise ValueError("replacement frames must be [n, ch] of the "
                             "sample's own dtype")
        self._frames = data
        return self

    def copy(self) -> "Sample":
        # shares the buffer: no op ever writes into it (module docstring)
        return Sample.from_torch(self._frames, self._samplerate,
                                 self._samplewidth, self.name)

    dup = copy

    # -- introspection -----------------------------------------------------------

    @property
    def samplerate(self) -> int:
        return self._samplerate

    @samplerate.setter
    def samplerate(self, rate: int) -> None:
        """Change the rate metadata only (alters pitch/duration)."""
        if rate <= 0:
            raise ValueError("samplerate must be positive")
        self._samplerate = int(rate)

    @property
    def samplewidth(self) -> int:
        return self._samplewidth

    @property
    def nchannels(self) -> int:
        return int(self._frames.shape[1])

    @property
    def nframes(self) -> int:
        return int(self._frames.shape[0])

    @property
    def duration(self) -> float:
        return self.nframes / self._samplerate

    @property
    def maxvalue(self) -> int:
        return MAXVAL[self._samplewidth]

    @property
    def device(self) -> torch.device:
        return self._frames.device

    @property
    def torch_frames(self) -> torch.Tensor:
        """The [nframes, nchannels] int tensor on the sample's device.  Do
        not write into it."""
        return self._frames

    def __len__(self) -> int:
        return self.nframes

    def __repr__(self) -> str:
        return (f"<Sample '{self.name}' {self.duration:.3f}s "
                f"{self._samplerate}Hz {8 * self._samplewidth}bit "
                f"{self.nchannels}ch>")

    def __eq__(self, other) -> bool:
        if not isinstance(other, Sample):
            return NotImplemented
        return (self._samplerate, self._samplewidth, self.nchannels) == \
               (other._samplerate, other._samplewidth, other.nchannels) and \
               self.nframes == other.nframes and \
               bool(torch.equal(self._frames,
                                other._frames.to(self._frames.device)))

    def view_frame_data(self) -> bytes:
        """Raw interleaved little-endian frame bytes (device -> host copy)."""
        return self.get_frame_array().tobytes()

    def get_frame_array(self, out: Optional[torch.Tensor] = None
                        ) -> np.ndarray:
        """Frames as a read-only host numpy array [nframes, nchannels].

        On a CUDA sample the frames are copied into a pinned host buffer
        that this sample owns (``copy_(non_blocking=True)``, then the
        stream is synchronised), and the view of it is cached until an op
        rebinds the frames, so repeated calls copy nothing and the view
        never aliases a later render.  A caller that renders repeatedly
        can pass ``out=``, a pinned tensor of the frames' shape and dtype,
        to reuse one buffer; the view of a caller's buffer is not cached.
        On a CPU sample the array is a view of the tensor.  Copy before
        writing."""
        base = self._frames
        if out is None and self._host_cache is not None \
                and self._host_base is base:
            return self._host_cache
        a = to_host(base, out)
        a.setflags(write=False)
        if out is None:
            self._host_cache, self._host_base = a, base
        return a

    def _n(self, seconds: float) -> int:
        return int(seconds * self._samplerate)

    def _set(self, frames: torch.Tensor) -> "Sample":
        self._frames = frames
        return self

    # -- file output --------------------------------------------------------------

    def write_wav(self, file) -> "Sample":
        wavio.write_wav(file, self.get_frame_array(), self._samplerate,
                        self._samplewidth, self.nchannels)
        return self

    write_flac = _waits("write_flac", 11)
    write_mp3 = _waits("write_mp3", 11)
    write_ogg = _waits("write_ogg", 11)
    write_opus = _waits("write_opus", 11)
    write_m4a = _waits("write_m4a", 11)

    def write_audio(self, file) -> "Sample":
        """Write by the filename extension.  Only WAV is ported; the
        compressed formats raise."""
        name = os.fspath(file) if isinstance(file, (str, os.PathLike)) \
            else None
        if isinstance(name, str):
            lower = name.lower()
            for exts, writer in (((".flac",), self.write_flac),
                                 ((".mp3",), self.write_mp3),
                                 ((".ogg", ".oga"), self.write_ogg),
                                 ((".opus",), self.write_opus),
                                 ((".m4a", ".aac"), self.write_m4a)):
                if lower.endswith(exts):
                    return writer(name)
        return self.write_wav(name if name is not None else file)

    # -- scaling -----------------------------------------------------------------------

    def amplify(self, factor: float) -> "Sample":
        """floor(f32(v) * f32(factor)), clamp (audioop.mul, f32 spec)."""
        return self._set(dpcm.mul_floor(self._frames, factor))

    def amplify_max(self) -> "Sample":
        """Amplify to full scale; the f32 factor maxval/peak is computed on
        the device (no host copy)."""
        x = self._frames
        pk = dpcm.peak(x)
        full = W.scalar(MAXVAL[self._samplewidth], x.device)
        factor = torch.where(pk == 0, torch.ones_like(full),
                             full / pk.to(torch.float32))
        return self._set(dpcm.mul_floor(x, factor))

    def invert(self) -> "Sample":
        return self.amplify(-1.0)

    def bias(self, amount: int) -> "Sample":
        """Wrapping DC offset (audioop.bias)."""
        return self._set(dpcm.bias_wrap(self._frames, int(amount)))

    # -- arrangement ----------------------------------------------------------------------

    def _silence(self, n: int) -> torch.Tensor:
        x = self._frames
        return torch.zeros((n, x.shape[1]), dtype=x.dtype, device=x.device)

    def clip(self, start_seconds: float, end_seconds: float) -> "Sample":
        a = min(self._n(start_seconds), self.nframes)
        b = min(max(self._n(end_seconds), a), self.nframes)
        return self._set(self._frames[a:b])

    def cut(self, start_seconds: float, end_seconds: float) -> "Sample":
        a = min(self._n(start_seconds), self.nframes)
        b = min(max(self._n(end_seconds), a), self.nframes)
        x = self._frames
        return self._set(torch.cat([x[:a], x[b:]], dim=0))

    def split(self, seconds: float) -> "Sample":
        n = min(self._n(seconds), self.nframes)
        tail = self.copy()
        tail._frames = self._frames[n:]
        self._frames = self._frames[:n]
        return tail

    def add_silence(self, seconds: float, at_start: bool = False) -> "Sample":
        return self._pad(self._n(seconds), at_start)

    def _pad(self, n: int, at_start: bool) -> "Sample":
        z = self._silence(max(int(n), 0))
        x = self._frames
        return self._set(torch.cat([z, x] if at_start else [x, z], dim=0))

    def pad_frames(self, nframes: int, at_start: bool = False) -> "Sample":
        """Frame-precise silence padding (no seconds round-trip)."""
        if nframes > 0:
            self._pad(int(nframes), bool(at_start))
        return self

    def truncate_frames(self, nframes: int) -> "Sample":
        """Keep only the first ``nframes`` frames (frame-precise clip)."""
        n = min(int(nframes), self.nframes)
        return self._set(self._frames[:n])

    def join(self, other: "Sample") -> "Sample":
        self._check_format(other)
        return self._set(torch.cat([self._frames, self._of(other)], dim=0))

    def reverse(self) -> "Sample":
        return self._set(torch.flip(self._frames, [0]))

    def delay(self, seconds: float, keep_length: bool = False) -> "Sample":
        n = self._n(abs(seconds))
        if seconds >= 0:
            self.add_silence(abs(seconds), at_start=True)
            if keep_length and n > 0:
                end = max(self.nframes - n, 0)
                self._frames = self._frames[:end]
        else:
            n = min(n, self.nframes)
            self._frames = self._frames[n:]
            if keep_length:
                self.add_silence(abs(seconds))
        return self

    # -- fades & envelopes ---------------------------------------------------------------

    def _ramp(self, n: int) -> torch.Tensor:
        return torch.arange(n, dtype=torch.float32, device=self._frames.device)

    def fadein(self, seconds: float, start_volume: float = 0.0) -> "Sample":
        n = min(self._n(seconds), self.nframes)
        if n > 0:
            x = self._frames
            start = np.float32(start_volume)
            rise = float(np.float32(1.0) - start)
            g = float(start) + rise * W.div(self._ramp(n), n)
            head = dpcm.gain_apply(x[:n], g[:, None])
            self._frames = torch.cat([head, x[n:]], dim=0)
        return self

    def fadeout(self, seconds: float, target_volume: float = 0.0) -> "Sample":
        n = min(self._n(seconds), self.nframes)
        if n > 0:
            x = self._frames
            total = self.nframes
            target = np.float32(target_volume)
            g = float(target) + float(np.float32(1.0) - target) * W.div(
                float(np.float32(n) - np.float32(1.0)) - self._ramp(n), n)
            tail = dpcm.gain_apply(x[total - n:], g[:, None])
            self._frames = torch.cat([x[:total - n], tail], dim=0)
        return self

    def envelope(self, attack: float, decay: float, sustainlevel: float,
                 release: float) -> "Sample":
        """ADSR gain curve over the whole buffer (goldref.sample.adsr_gains)."""
        n, samplerate = self.nframes, self._samplerate
        a = max(np.float32(attack), np.float32(0.0))
        d = max(np.float32(decay), np.float32(0.0))
        sl = np.float32(sustainlevel)
        r = max(np.float32(release), np.float32(0.0))
        t = W.div(self._ramp(n), samplerate)
        dur = np.float32(n / samplerate)
        eps = np.float32(1e-30)
        g = torch.ones_like(t)
        if a > 0:
            g = torch.minimum(g, W.div(t, max(a, eps)))
        in_decay = (t >= float(a)) & (t < float(a + d))
        g = torch.where(
            in_decay,
            1.0 + W.div(float(sl - np.float32(1.0)) * (t - float(a)),
                        max(d, eps)),
            g)
        g = torch.where(t >= float(a + d), W.scalar(sl, t.device), g)
        if r > 0:
            rel_gain = W.div(g * (float(dur) - t), max(r, eps))
            g = torch.where(t >= float(dur - r), rel_gain, g)
        return self._set(dpcm.gain_apply(
            self._frames, torch.clamp_min(g, 0.0)[:, None]))

    def modulate_amp(self, modulator) -> "Sample":
        """Per-sample amplitude modulation by a Sample, f32 array or
        tensor, or an object exposing ``gains(n)`` (oscillators)."""
        n = self.nframes
        if hasattr(modulator, "spec") and not isinstance(modulator, Sample):
            from .models import graph as G
            g = G.render_patch(modulator.spec, n, modulator.samplerate,
                               device=self.device)
        else:
            g = _modulator_gains(modulator, n, self.device)
        return self._set(dpcm.gain_apply(self._frames, g[:, None]))

    # -- mixing -------------------------------------------------------------------------------

    def _of(self, other: "Sample") -> torch.Tensor:
        """Another sample's frames on this sample's device."""
        return other._frames.to(self._frames.device)

    def mix(self, other: "Sample", other_seconds: Optional[float] = None,
            pad_shortest: bool = True) -> "Sample":
        return self.mix_at(0.0, other, other_seconds, pad_shortest=pad_shortest)

    def mix_at(self, seconds: float, other: "Sample",
               other_seconds: Optional[float] = None,
               pad_shortest: bool = True) -> "Sample":
        """Saturating add of ``other`` at a frame offset (the trackmixer
        hot loop)."""
        self._check_format(other)
        if seconds < 0:
            raise ValueError("mix_at offset must be >= 0")
        m = other.nframes
        if other_seconds is not None:
            m = min(m, other._n(other_seconds))
        start = self._n(seconds)
        if start + m > self.nframes and not pad_shortest:
            m = max(0, self.nframes - start)
        if m == 0:
            return self
        out_len = max(self.nframes, start + m)
        x = self._frames
        if out_len > x.shape[0]:
            x = torch.cat([x, self._silence(out_len - x.shape[0])], dim=0)
        mixed = dpcm.sat_add(x[start:start + m], self._of(other)[:m])
        return self._set(torch.cat([x[:start], mixed, x[start + m:]], dim=0))

    def echo(self, length: float, amount: int, delay: float,
             decay: float) -> "Sample":
        """Feed-forward echo (spec: goldref.sample.Sample.echo).  Per-echo
        offsets are rounded from seconds individually (int(k*delay*sr)),
        matching the oracle's per-copy mix_at exactly."""
        total = self._n(length)
        offsets = tuple(self._n(k * delay) for k in range(1, int(amount) + 1))
        orig = x = self._frames
        cur = x.shape[0]
        if total > cur:
            x = torch.cat([x, self._silence(total - cur)], dim=0)
        else:
            x = x[:total]
        decay = np.float32(decay)
        gain = np.float32(1.0)
        for dk in offsets:
            gain = np.float32(gain * decay)
            if dk >= total:
                continue
            m = min(orig.shape[0], total - dk)
            copy_k = dpcm.mul_floor(orig[:m], gain)
            mixed = dpcm.sat_add(x[dk:dk + m], copy_k)
            x = torch.cat([x[:dk], mixed, x[dk + m:]], dim=0)
        return self._set(x)

    # -- effects rack: not ported yet ------------------------------------------------------------

    compress = _waits("compress", 10)
    reverb = _waits("reverb", 10)
    chorus = _waits("chorus", 10)
    filter = _waits("filter", 10)
    eq = _waits("eq", 10)
    loudness_lufs = _waits("loudness_lufs", 10)
    loudness_stats = _waits("loudness_stats", 10)
    true_peak_dbtp = _waits("true_peak_dbtp", 10)
    normalize_lufs = _waits("normalize_lufs", 10)
    gate = _waits("gate", 10)
    feedback_echo = _waits("feedback_echo", 10)
    tremolo = _waits("tremolo", 10)
    autopan = _waits("autopan", 10)
    stereo_width = _waits("stereo_width", 10)
    limit = _waits("limit", 10)
    phaser = _waits("phaser", 10)
    convolve = _waits("convolve", 10)
    granulate = _waits("granulate", 10)
    stretch = _waits("stretch", 10)
    pitch_shift = _waits("pitch_shift", 10)

    # -- format conversion -----------------------------------------------------------------------

    def make_32bit(self, scale_amplitude: bool = True) -> "Sample":
        if self._samplewidth == 4:
            return self
        x = self._frames
        self._frames = dpcm.lin2lin(x, 4) if scale_amplitude \
            else x.to(torch.int32)
        self._samplewidth = 4
        return self

    def make_16bit(self, maximize_amplitude: bool = True) -> "Sample":
        if maximize_amplitude:
            self.amplify_max()
        if self._samplewidth != 2:
            self._frames = dpcm.lin2lin(self._frames, 2)
            self._samplewidth = 2
        return self

    resample = _waits("resample", 8)
    speed = _waits("speed", 8)
    _ratecv = _waits("_ratecv", 8)
    _hq_resample = _waits("_hq_resample", 8)

    def mono(self, left_factor: float = 1.0, right_factor: float = 1.0) -> "Sample":
        if self.nchannels == 1:
            return self
        return self._set(dpcm.to_mono(self._frames, left_factor,
                                      right_factor))

    def stereo(self, left_factor: float = 1.0, right_factor: float = 1.0) -> "Sample":
        if self.nchannels == 2:
            return self
        return self._set(dpcm.to_stereo(self._frames, left_factor,
                                        right_factor))

    def stereo_mix(self, other: "Sample", other_channel: str,
                   other_mix_factor: float = 1.0) -> "Sample":
        if other_channel not in ("L", "R") or other.nchannels != 1:
            raise ValueError("stereo_mix needs a mono sample and channel "
                             "'L' or 'R'")
        if self.nchannels == 1:
            self.stereo()
        ch = 0 if other_channel == "L" else 1
        m = min(self.nframes, other.nframes)
        x = self._frames
        scaled = dpcm.mul_floor(self._of(other)[:m, 0], other_mix_factor)
        mixed = dpcm.sat_add(x[:m, ch], scaled)
        # the write goes into a fresh tensor that nobody else holds
        y = x.clone()
        y[:m, ch] = mixed
        return self._set(y)

    def pan(self, amount: float = 0.0, lfo=None) -> "Sample":
        if self.nchannels == 1:
            self.stereo()
        x = self._frames
        n = self.nframes
        if lfo is None:
            amount = np.float32(amount)
            la = min(np.float32(1.0), np.float32(1.0) - amount)
            ra = min(np.float32(1.0), np.float32(1.0) + amount)
            gains = torch.stack([W.scalar(la, x.device),
                                 W.scalar(ra, x.device)])[None, :]
        elif isinstance(lfo, Sample):
            gains = _pan_gains(_modulator_gains(lfo, n, x.device))
        elif hasattr(lfo, "spec"):       # Oscillator: render the patch
            from .models import graph as G
            gains = _pan_gains(G.patch_values(lfo.spec, n, lfo.samplerate,
                                              device=x.device))
        else:
            gains = _pan_gains(_modulator_gains(lfo, n, x.device))
        return self._set(dpcm.gain_apply(x, gains))

    # -- chunking -------------------------------------------------------------------------------------

    def chunked_frame_data(self, chunksize_frames: int,
                           repeat: bool = False) -> Iterator[bytes]:
        """Yield raw frame bytes chunk by chunk (host copies of device data)."""
        host = self.get_frame_array()
        n = len(host)
        npdt = _NPDT[self._samplewidth]
        if repeat:
            if n == 0:
                raise ValueError("cannot repeat an empty sample")
            i = 0
            while True:
                idx = np.arange(i, i + chunksize_frames) % n
                yield host[idx].astype(npdt).tobytes()
                i = (i + chunksize_frames) % n
        else:
            for i in range(0, n, chunksize_frames):
                yield host[i:i + chunksize_frames].astype(npdt).tobytes()

    # -- misc ------------------------------------------------------------------------------------------

    def normalize(self) -> "Sample":
        """Convert to the global normalization targets (params module).  A
        sample at another rate than ``params.norm_samplerate`` needs
        ``resample``, which is not ported yet."""
        if self._samplerate != params.norm_samplerate:
            self.resample(params.norm_samplerate)
        if self._samplewidth != params.norm_samplewidth:
            if params.norm_samplewidth == 2:
                self.make_16bit(maximize_amplitude=False)
            else:
                self._frames = dpcm.lin2lin(self._frames,
                                            params.norm_samplewidth)
                self._samplewidth = params.norm_samplewidth
        if self.nchannels == 1 and params.norm_nchannels == 2:
            self.stereo()
        elif self.nchannels == 2 and params.norm_nchannels == 1:
            self.mono()
        return self

    def _check_format(self, other: "Sample") -> None:
        if (other._samplerate, other._samplewidth, other.nchannels) != \
                (self._samplerate, self._samplewidth, self.nchannels):
            raise ValueError(
                f"sample format mismatch: {other!r} vs {self!r}")


def _modulator_gains(modulator, n: int, device) -> torch.Tensor:
    """Gains [n] f32 on ``device`` from a Sample (first channel over its
    full scale), an object with ``gains(n)``, or an array; a short
    modulator is continued with ones."""
    if isinstance(modulator, Sample):
        g = W.div(modulator.torch_frames[:, 0].to(device=device,
                                                  dtype=torch.float32),
                  MAXVAL[modulator.samplewidth])
    else:
        if hasattr(modulator, "gains"):
            modulator = modulator.gains(n)
        if not isinstance(modulator, torch.Tensor):
            modulator = torch.from_numpy(
                np.array(modulator, dtype=np.float32))
        g = modulator.to(device=device, dtype=torch.float32)
    if g.shape[0] < n:
        g = torch.cat([g, torch.ones(n - g.shape[0], dtype=torch.float32,
                                     device=device)])
    return g[:n]


class LevelMeter:
    """Peak / RMS level meter.  Not ported yet: it comes with the effects
    slice (its loudness readout needs ``ops/loudness.py``).  The reductions
    it runs per chunk, ``ops.pcm.vu_levels``, are ported."""

    def __init__(self, *args, **kwargs):
        raise _not_ported("LevelMeter", 10)
