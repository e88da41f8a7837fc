"""Device-resident ``Sample`` PCM buffer and ``LevelMeter`` (port of
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

**Effects and resampling.**  The effects rack (``ops/effects.py``), the
loudness meters (``ops/loudness.py``) and both resamplers
(``ops/resample.py``) run on the sample's device.  A key, impulse-response
or modulator ``Sample`` is used as it stands: there is no sub-program to
fuse.

**File output.**  WAV goes through ``utils.wavio``, FLAC through the
port's own encoder (``utils.flac``), MP3, Ogg Vorbis, Opus and AAC through
the system codec libraries (``utils.codecs``, ``utils.libav``), which
raise where a library is missing.
"""

from __future__ import annotations

import math
import os
from typing import Iterator, Optional

import numpy as np
import torch

from . import params
from .ops import coeffs as C
from .ops import effects as dfx
from .ops import loudness as dl
from .ops import pcm as dpcm
from .ops import resample as dresample
from .ops import wave as W
from .utils import wavio
from .utils.device import resolve as _device
from .utils.device import to_host

_DTYPES = dpcm.DTYPES
_NPDT = {1: np.int8, 2: np.int16, 4: np.int32}
MAXVAL = dpcm.MAXVAL
MINVAL = dpcm.MINVAL

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
                np.require(frames, requirements=("C", "W"))).to(dev)
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

    def write_flac(self, file) -> "Sample":
        """Write the sample losslessly as FLAC (``utils.flac`` encoder:
        fixed predictors and native Rice coding; decode is bit-identical)."""
        from .utils.flac import write_flac
        write_flac(file, self.get_frame_array(), self._samplerate,
                   self._samplewidth, self.nchannels)
        return self

    def _frames_16bit(self) -> np.ndarray:
        """int16 frame array for the lossy encoders (width-converted by
        ``make_16bit`` on a copy, self untouched)."""
        if self._samplewidth == 2:
            return self.get_frame_array()
        return self.copy().make_16bit(
            maximize_amplitude=False).get_frame_array()

    def write_mp3(self, file, bitrate: int = 192) -> "Sample":
        """Encode to MP3 (CBR kbps, LAME info tag for gapless decode)
        through the system libmp3lame (``utils.codecs``).  Lossy: the
        sample is width-converted to 16-bit for the encoder."""
        from .utils.codecs import write_mp3
        write_mp3(file, self._frames_16bit(), self._samplerate,
                  self.nchannels, bitrate=bitrate)
        return self

    def write_ogg(self, file, quality: float = 0.4) -> "Sample":
        """Encode to Ogg Vorbis (VBR quality -0.1..1.0) through the system
        libvorbisenc (``utils.codecs``).  Lossy: 16-bit input."""
        from .utils.codecs import write_vorbis
        write_vorbis(file, self._frames_16bit(), self._samplerate,
                     self.nchannels, quality=quality)
        return self

    def write_opus(self, file, bitrate: int = 128000) -> "Sample":
        """Encode to Ogg Opus through the system libopus (``utils.codecs``;
        the Ogg mux is the port's own).  Opus encodes only at
        8/12/16/24/48 kHz: other rates resample a copy to 48 kHz with the
        exact ratecv first (self untouched)."""
        from .utils.codecs import write_opus
        smp = self
        if self._samplerate not in (8000, 12000, 16000, 24000, 48000):
            smp = self.copy().resample(48000)
        write_opus(file, smp._frames_16bit(), smp._samplerate,
                   smp.nchannels, bitrate=bitrate)
        return self

    def write_m4a(self, file, bitrate: int = 128000) -> "Sample":
        """Encode to AAC in MP4 (.m4a), or raw ADTS when the name ends in
        .aac, through the libav shim (``utils.libav``).  Lossy: 16-bit."""
        from .utils.libav import write_with_libav
        write_with_libav(os.fspath(file), self._frames_16bit(),
                         self._samplerate, self.nchannels, bitrate=bitrate)
        return self

    def write_audio(self, file) -> "Sample":
        """Write WAV, FLAC, MP3, Ogg Vorbis, Opus, or AAC/M4A, chosen by
        the filename extension (the lossy formats need the system codec
        libraries)."""
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

    # -- effects rack (beyond the reference; contract: goldref.effects) --------------------------

    def compress(self, threshold_db: float = -20.0, ratio: float = 4.0,
                 attack: float = 0.005, release: float = 0.1,
                 makeup_db: float = 0.0, knee_db: float = 0.0,
                 sidechain: Optional["Sample"] = None) -> "Sample":
        """Peak compressor / limiter (``ratio=math.inf``): the detector and
        attack smoother are log-depth scans (ops.effects); spec/tolerance:
        goldref.effects.compressor_gains.  ``knee_db`` > 0 softens the
        static curve over a knee_db-wide window (0 keeps the hard knee).
        With ``sidechain`` the detector listens to the KEY sample, as it
        stands (ducking); past the key's end the gain releases to 1."""
        alpha, decay = C.compressor_coeffs(self._samplerate, attack, release)
        slope = 1.0 if math.isinf(ratio) else 1.0 - 1.0 / ratio
        makeup = float(np.exp2(np.float32(makeup_db) / np.float32(6.0206)))
        if not 0.0 <= knee_db <= 24.0:
            raise ValueError("compress knee_db must be in [0, 24]")
        knee = knee_db if knee_db > 0.0 else None
        x = self._frames
        if sidechain is None:
            g = dfx.compressor_gains_from_coeffs(x, threshold_db, slope,
                                                 alpha, decay, knee=knee)
        else:
            if sidechain._samplerate != self._samplerate:
                raise ValueError("sidechain samplerate mismatch")
            key = W.div(self._of(sidechain).to(torch.float32),
                        MAXVAL[sidechain._samplewidth])
            a = torch.amax(torch.abs(key), dim=1)
            n = x.shape[0]
            a = a[:n] if a.shape[0] >= n else torch.cat(
                [a, torch.zeros(n - a.shape[0], dtype=torch.float32,
                                device=a.device)])
            g = dfx.compressor_gains_from_level(a, threshold_db, slope,
                                                alpha, decay, knee=knee)
        return self._set(dpcm.gain_apply(x, (g * makeup)[:, None]))

    def reverb(self, roomsize: float = 0.7, damping: float = 0.5,
               wet: float = 0.33, dry: float = 0.7, width: float = 1.0,
               tail: float = 1.5) -> "Sample":
        """Freeverb-style reverb (lag-aligned comb stage, see ops.effects);
        extends the sample by ``tail`` seconds of decay.  Spec/tolerance:
        goldref.effects.reverb."""
        feedback, damp, wet1, wet2 = C.reverb_params(roomsize, damping, wet,
                                                   width)
        return self._set(dfx.reverb_from_params(
            self._frames, self._samplerate, feedback, damp, wet1, wet2, dry,
            self._n(tail)))

    def chorus(self, rate: float = 0.5, depth: float = 0.002,
               delay: float = 0.02, voices: int = 3, wet: float = 0.4,
               dry: float = 1.0) -> "Sample":
        """Multi-voice chorus (LFO-modulated fractional delays).
        Spec/tolerance: goldref.effects.chorus."""
        return self._set(dfx.chorus(self._frames, self._samplerate,
                                    float(rate), float(depth), float(delay),
                                    int(voices), wet, dry))

    def filter(self, kind: str, cutoff: float, q: float = 0.7071,
               gain_db: float = 0.0) -> "Sample":
        """Resonant RBJ biquad on the PCM (parallel companion-matrix scan —
        ops.effects.companion_scan); spec/tolerance:
        goldref.effects.biquad_filter.  Kinds: lowpass/highpass/bandpass,
        plus the gain kinds lowshelf/highshelf/peaking (``gain_db``)."""
        if kind in ("lowshelf", "highshelf", "peaking"):
            coeffs = C.eq_band_coeffs(kind, cutoff, gain_db, q,
                                    self._samplerate)
        else:
            coeffs = C.biquad_coeffs(kind, cutoff, q, self._samplerate)
        return self._biquad(coeffs)

    def _biquad(self, coeffs) -> "Sample":
        """One biquad, routed by conditioning: coefficient sets with
        near-unit poles (ops.coeffs.wants_ff_scan) run the float-float scan
        with (hi, lo) coefficient pairs, the rest the plain f32 scan."""
        x = self._frames
        w = self._samplewidth
        s = W.div(x.to(torch.float32), MAXVAL[w])
        if C.wants_ff_scan(coeffs):
            y, _ = dfx.biquad_apply_ff(s, tuple(C.ff_split(c) for c in coeffs))
        else:
            y, _ = dfx.biquad_apply(s, coeffs)
        return self._set(dfx.to_int_samples(y, w))

    def eq(self, low_db: float = 0.0, mid_db: float = 0.0,
           high_db: float = 0.0, low_freq: float = 120.0,
           mid_freq: float = 1000.0, mid_q: float = 1.0,
           high_freq: float = 8000.0) -> "Sample":
        """Three-band parametric EQ: low shelf, peaking mid, high shelf.
        Each NONZERO band is one RBJ biquad, as chained ``filter()`` calls;
        zero-gain bands do nothing.  Spec/tolerance: goldref.effects.eq."""
        for kind, f, g, q in (("lowshelf", low_freq, low_db, 0.7071),
                              ("peaking", mid_freq, mid_db, mid_q),
                              ("highshelf", high_freq, high_db, 0.7071)):
            if g != 0.0:
                self._biquad(C.eq_band_coeffs(kind, f, g, q, self._samplerate))
        return self

    def loudness_lufs(self) -> float:
        """Integrated programme loudness (LUFS, ITU-R BS.1770-4):
        K-weighted hop energies on the device, the two-stage gate on the
        host (ops/loudness.py).  -inf for silence or programmes shorter
        than one 400 ms block.  Spec/tolerance:
        goldref.effects.loudness_lufs."""
        return dl.loudness_integrated(self._frames, self._samplerate)

    def loudness_stats(self) -> dict:
        """The EBU R128 meter set in one pass: ``integrated`` (LUFS),
        ``lra`` (LU), ``momentary_max`` and ``short_term_max`` (LUFS).
        Spec/tolerance: goldref.effects.loudness_stats."""
        return dl.loudness_stats(self._frames, self._samplerate)

    def true_peak_dbtp(self) -> float:
        """True peak (dBTP, BS.1770-4 Annex 2, 4x polyphase oversampling);
        -inf for silence.  Spec/tolerance: goldref.effects.true_peak_dbtp."""
        tp = dl.true_peak_norm(self._frames)
        return float("-inf") if tp <= 0.0 else 20.0 * math.log10(tp)

    def normalize_lufs(self, target_lufs: float = -14.0,
                       true_peak_db: float = -1.0) -> "Sample":
        """Loudness-normalize to a target (default -14 LUFS): gain = target
        - measured, capped so that the true peak stays <= ``true_peak_db``
        dBTP, applied as one ``amplify``.  Silence is returned unchanged."""
        li = dl.loudness_integrated(self._frames, self._samplerate)
        if not math.isfinite(li):
            return self
        gain_db = target_lufs - li
        tp = dl.true_peak_norm(self._frames)
        if tp > 0.0:
            gain_db = min(gain_db, true_peak_db - 20.0 * math.log10(tp))
        return self.amplify(float(10.0 ** (gain_db / 20.0)))

    def gate(self, threshold_db: float = -50.0, range_db: float = 80.0,
             attack: float = 0.001, release: float = 0.05) -> "Sample":
        """Noise gate (decaying-max detector + one-pole smoother as
        parallel scans); spec/tolerance: goldref.effects.gate_gains."""
        alpha, decay, floor_gain = C.gate_coeffs(self._samplerate, attack,
                                               release, range_db)
        x = self._frames
        g = dfx.gate_gains_from_coeffs(x, threshold_db, floor_gain, alpha,
                                       decay, e0=0.0, z0=floor_gain)
        return self._set(dpcm.gain_apply(x, g[:, None]))

    def feedback_echo(self, delay: float, feedback: float = 0.4,
                      wet: float = 0.5, dry: float = 1.0,
                      tail: Optional[float] = None) -> "Sample":
        """Feedback delay line: first echo at ``delay`` seconds with
        amplitude ``wet``, the k-th at k*delay with wet*feedback^(k-1).
        Extends the sample by ``tail`` seconds, or by the 1-LSB rule of
        ops.coeffs.echo_tail_frames.  Spec/budget:
        goldref.effects.feedback_echo."""
        if not 0.0 <= feedback <= 0.95:
            raise ValueError("feedback must be in [0, 0.95]")
        D = max(1, self._n(delay))
        tail_frames = C.echo_tail_frames(self._samplerate, delay, feedback,
                                       wet, tail)
        return self._set(dfx.feedback_echo(self._frames, D, feedback, wet,
                                           dry, tail_frames))

    def _lfo_grid(self, grid: np.ndarray) -> torch.Tensor:
        return torch.from_numpy(np.asarray(grid, np.float32)).to(self.device)

    def tremolo(self, rate: float = 5.0, depth: float = 0.5,
                start_frame: int = 0) -> "Sample":
        """LFO amplitude modulation: per-frame gains in [1-depth, 1] from
        the house integer-DDS sine LFO, derived on the host at absolute
        frames [start_frame, ...) (ops.coeffs.tremolo_gain_grid).
        Spec/budget: goldref.effects.tremolo."""
        if not 0.0 <= depth <= 1.0:
            raise ValueError("tremolo depth must be in [0, 1]")
        if not 0.0 < rate <= 20.0:
            raise ValueError("tremolo rate must be in (0, 20] Hz")
        P = C.static_phase(int(start_frame), self.nframes, self._samplerate,
                         rate)
        return self._set(dfx.tremolo(
            self._frames, self._lfo_grid(C.tremolo_gain_grid(P, depth))))

    def autopan(self, rate: float = 0.5, depth: float = 1.0,
                start_frame: int = 0) -> "Sample":
        """LFO auto-panner: per-frame pan positions depth*sin through the
        house equal-gain pan law, derived on the host at absolute frames
        (ops.coeffs.autopan_pan_grid).  Stereo only.  Spec/budget:
        goldref.effects.autopan."""
        if self.nchannels != 2:
            raise ValueError("autopan needs a stereo sample")
        if not 0.0 <= depth <= 1.0:
            raise ValueError("autopan depth must be in [0, 1]")
        if not 0.0 < rate <= 20.0:
            raise ValueError("autopan rate must be in (0, 20] Hz")
        P = C.static_phase(int(start_frame), self.nframes, self._samplerate,
                         rate)
        return self._set(dfx.autopan(
            self._frames, self._lfo_grid(C.autopan_pan_grid(P, depth))))

    def stereo_width(self, amount: float) -> "Sample":
        """Mid/side stereo-width control (0 = mono, 1 = unity, up to 4 =
        wider).  Spec/budget: goldref.effects.stereo_width."""
        if self.nchannels != 2:
            raise ValueError("stereo_width needs a stereo sample")
        if not 0.0 <= amount <= 4.0:
            raise ValueError("width amount must be in [0, 4]")
        return self._set(dfx.stereo_width(self._frames, amount))

    def limit(self, ceiling_db: float = -1.0, release: float = 0.05,
              lookahead: float = 0.005) -> "Sample":
        """Lookahead brickwall limiter: the gain dips ``lookahead`` seconds
        before a peak (window max + box attack ramp), releases as a
        decaying max in dB, and a hard integer clamp at the ceiling makes it
        a true brickwall.  Length preserved.  Spec/tolerance:
        goldref.effects.limiter_gains."""
        if not -60.0 <= ceiling_db <= 0.0:
            raise ValueError("limiter ceiling_db must be in [-60, 0]")
        L = max(1, self._n(lookahead))
        decay = C.compressor_coeffs(self._samplerate, 0.0, release)[1]
        cint = C.limiter_ceiling(ceiling_db, self._samplewidth)
        return self._set(dfx.limiter(self._frames, ceiling_db, decay, L,
                                     cint))

    def phaser(self, rate: float = 0.5, depth: float = 1.0,
               min_freq: float = 300.0, max_freq: float = 3000.0,
               stages: int = 4, q: float = 0.7071, wet: float = 0.5,
               dry: float = 1.0) -> "Sample":
        """LFO-swept allpass cascade: ``stages`` identical RBJ allpasses
        sweep exponentially between ``min_freq`` and ``max_freq`` under the
        house integer-DDS LFO, with per-frame coefficient grids from the
        host (ops.coeffs.phaser_coeff_grids).  Sweep floors below ~120 Hz
        run the float-float scan (ops.coeffs.phaser_wants_ff).
        Spec/budget: goldref.effects.phaser."""
        if not 1 <= int(stages) <= 12:
            raise ValueError("phaser stages must be in [1, 12]")
        if min_freq < 30.0 or max_freq <= min_freq:
            raise ValueError("phaser needs 30 <= min_freq < max_freq")
        ff = C.phaser_wants_ff(min_freq)
        x = self._frames
        grids = C.phaser_coeff_grids(
            0, x.shape[0], self._samplerate, rate, depth, min_freq,
            max_freq, q, dtype=np.float64 if ff else np.float32)
        z = torch.zeros(x.shape[1], dtype=torch.float32, device=x.device)
        if ff:
            grids = tuple(tuple(self._lfo_grid(part) for part in C.ff_split(g))
                          for g in grids)
            states = tuple((z,) * 6 for _ in range(int(stages)))
        else:
            grids = tuple(self._lfo_grid(g) for g in grids)
            states = tuple((z,) * 4 for _ in range(int(stages)))
        s = W.div(x.to(torch.float32), MAXVAL[self._samplewidth])
        y, _ = dfx.phaser_apply(s, grids, states, ff)
        out = float(np.float32(dry)) * s + float(np.float32(wet)) * y
        return self._set(dfx.to_int_samples(out, self._samplewidth))

    def convolve(self, ir: "Sample", wet: float = 1.0,
                 dry: float = 0.0) -> "Sample":
        """Convolve with an impulse-response sample (f32 FFT product; a
        mono IR applies to all channels); extends by len(ir)-1 frames.
        Spec/tolerance: goldref.effects.convolve."""
        if ir._samplerate != self._samplerate:
            raise ValueError("impulse response samplerate mismatch")
        if ir.nchannels not in (1, self.nchannels):
            raise ValueError("impulse response channel mismatch")
        if ir.nframes == 0:
            raise ValueError("empty impulse response")
        ir_norm = W.div(self._of(ir).to(torch.float32),
                        MAXVAL[ir._samplewidth])
        return self._set(dfx.convolve(self._frames, ir_norm, wet, dry))

    def granulate(self, duration: float, grain: float = 0.05,
                  density: float = 25.0, jitter: float = 0.02,
                  amplitude: float = 0.7, seed: int = 0) -> "Sample":
        """Granular resynthesis onto a ``duration``-second canvas (one
        gather, the grains added in a fixed order); spec/tolerance:
        goldref.effects.granulate."""
        return self._set(dfx.granulate(
            self._frames, self._samplerate, float(duration), float(grain),
            float(density), float(jitter), amplitude, int(seed)))

    def stretch(self, factor: float, frame: int = 2048,
                hop: int = 512) -> "Sample":
        """Phase-vocoder time stretch (duration x factor, pitch kept);
        spec/tolerance: goldref.effects.stretch."""
        return self._set(dfx.stretch(self._frames, float(factor),
                                     int(frame), int(hop)))

    def pitch_shift(self, semitones: float, frame: int = 2048,
                    hop: int = 512, quality: str = "linear") -> "Sample":
        """Shift pitch by equal-tempered semitones, duration preserved:
        stretch(r) + speed(r), r = 2**(semitones/12).  ``quality='hq'``
        runs the speed leg through the windowed-sinc resampler."""
        r = 2.0 ** (semitones / 12.0)
        return self.stretch(r, frame, hop).speed(r, quality=quality)

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

    def resample(self, samplerate: int, quality: str = "linear") -> "Sample":
        """Resample to a new rate (pitch preserved).  quality='linear'
        (default) is the reference's exact audioop ratecv interpolator,
        bit-exact; quality='hq' is the windowed-sinc polyphase resampler
        (ops.resample.hq_resample; spec and <= 1 LSB budget:
        goldref.effects.hq_resample) with the SAME output length."""
        if samplerate == self._samplerate:
            return self
        if quality == "hq":
            self._hq_resample(self._samplerate, samplerate)
        elif quality == "linear":
            self._ratecv(self._samplerate, samplerate)
        else:
            raise ValueError(f"unknown resample quality {quality!r}")
        self._samplerate = samplerate
        return self

    def speed(self, speed: float, quality: str = "linear") -> "Sample":
        """Change playback speed (and pitch), keeping the samplerate.
        quality='hq' snaps the ratio to the nearest rational with both
        terms <= ops.resample.HQ_MAX_FACTOR (ops.resample.bounded_ratio)."""
        if speed == 1.0:
            return self
        if quality == "hq":
            self._hq_resample(int(self._samplerate * speed),
                              self._samplerate, snap=True)
        elif quality == "linear":
            self._ratecv(int(self._samplerate * speed), self._samplerate)
        else:
            raise ValueError(f"unknown resample quality {quality!r}")
        return self

    def _hq_resample(self, inrate: int, outrate: int,
                     snap: bool = False) -> "Sample":
        g = math.gcd(inrate, outrate)
        M, L = inrate // g, outrate // g
        if max(L, M) > dresample.HQ_MAX_FACTOR:
            if not snap:
                # an irreducible pair is a caller error, not a snap case
                raise ValueError(
                    f"quality='hq' supports rational rate ratios up to "
                    f"{dresample.HQ_MAX_FACTOR} after gcd reduction; "
                    f"got {L}/{M}")
            L, M = dresample.bounded_ratio(outrate, inrate)
        nout = dresample.nframes_out(self.nframes, M, L)
        return self._set(dresample.hq_resample(self._frames, L, M, nout))

    def _ratecv(self, inrate: int, outrate: int) -> "Sample":
        return self._set(dresample.resample_tensor(self._frames, inrate,
                                                   outrate))

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
        """Convert to the global normalization targets (params module)."""
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
    """Peak / RMS dB level meter with decay (VU meter).

    Call :meth:`update` once per chunk; levels are in dB relative to full
    scale, floored at ``lowest``.  The level decays at 30 dB/s between
    updates and the peak markers hold for 0.4 s before falling.  The
    per-chunk peak/RMS reductions of a ``Sample`` run on its device
    (``ops.pcm.vu_levels``, one host copy a chunk); host chunks
    (:meth:`update_frames`) are reduced with numpy.
    """

    DECAY_DB_PER_SEC = 30.0
    PEAK_HOLD_SEC = 0.4

    def __init__(self, rms_mode: bool = False, lowest: float = -60.0,
                 loudness: bool = False):
        """``loudness=True`` adds a live EBU R128 readout: ``momentary`` /
        ``short_term`` LUFS (and their maxima) track every chunk fed
        through :meth:`update` / :meth:`update_frames`, via
        ``ops.loudness.StreamingLoudness``."""
        if not lowest < 0:
            raise ValueError("lowest must be below 0 dB")
        self.rms_mode = rms_mode
        self.lowest = float(lowest)
        self.level_left = self.level_right = lowest
        self.peak_left = self.peak_right = lowest
        self._peak_left_hold = self._peak_right_hold = 0.0
        self._want_loudness = bool(loudness)
        self.loudness_meter = None      # built lazily (needs samplerate)

    def reset(self) -> None:
        self.level_left = self.level_right = self.lowest
        self.peak_left = self.peak_right = self.lowest
        self._peak_left_hold = self._peak_right_hold = 0.0
        self.loudness_meter = None

    @property
    def momentary_lufs(self) -> float:
        return (self.loudness_meter.momentary if self.loudness_meter
                else float("-inf"))

    @property
    def short_term_lufs(self) -> float:
        return (self.loudness_meter.short_term if self.loudness_meter
                else float("-inf"))

    def _loudness(self, samplerate: int, nchannels: int):
        if self.loudness_meter is None:
            self.loudness_meter = dl.StreamingLoudness(samplerate, nchannels)
        return self.loudness_meter

    def update(self, sample: Sample):
        """Process one sample/chunk; returns (level_l, peak_l, level_r,
        peak_r)."""
        data = sample.torch_frames
        if self._want_loudness:
            # the original channel layout (a dual-mono expansion would
            # read +3 LU high)
            self._loudness(sample.samplerate, sample.nchannels).update(data)
        if sample.nchannels == 1:
            data = torch.cat([data, data], dim=1)
        pl, pr, msl, msr = dpcm.vu_levels(data).tolist()
        return self._advance(pl, pr, msl, msr, float(sample.maxvalue),
                             sample.duration)

    def update_frames(self, frames: np.ndarray, samplerate: int,
                      maxvalue: float = 32767.0):
        """Host-side metering of int16 chunks that are already in host
        memory (a realtime mixer's buffers): no device round trip, the live
        loudness readout included."""
        a = np.asarray(frames)
        if a.ndim == 1:
            a = a[:, None]
        if self._want_loudness:
            self._loudness(samplerate, a.shape[1]).update_host(a, maxvalue)
        if a.shape[1] == 1:
            a = np.repeat(a, 2, axis=1)
        a = np.ascontiguousarray(a, np.int16)
        l, r = a[:, 0].astype(np.float64), a[:, 1].astype(np.float64)
        n = len(a)
        pl = float(np.abs(a[:, 0].astype(np.int32)).max(initial=0))
        pr = float(np.abs(a[:, 1].astype(np.int32)).max(initial=0))
        msl = float((l * l).mean()) if n else 0.0
        msr = float((r * r).mean()) if n else 0.0
        return self._advance(pl, pr, msl, msr, maxvalue, n / samplerate)

    def _advance(self, pl, pr, msl, msr, maxvalue, dt):
        if self.rms_mode:
            ampl_l = math.sqrt(max(msl, 0.0)) / maxvalue
            ampl_r = math.sqrt(max(msr, 0.0)) / maxvalue
        else:
            ampl_l = pl / maxvalue
            ampl_r = pr / maxvalue
        decay = self.DECAY_DB_PER_SEC * dt
        db_l = 20.0 * math.log10(ampl_l) if ampl_l > 0 else self.lowest
        db_r = 20.0 * math.log10(ampl_r) if ampl_r > 0 else self.lowest
        db_l = max(db_l, self.lowest)
        db_r = max(db_r, self.lowest)
        self.level_left = max(db_l, self.level_left - decay)
        self.level_right = max(db_r, self.level_right - decay)
        self._peak_left_hold += dt
        self._peak_right_hold += dt
        if db_l >= self.peak_left:
            self.peak_left = db_l
            self._peak_left_hold = 0.0
        elif self._peak_left_hold > self.PEAK_HOLD_SEC:
            self.peak_left = max(self.peak_left - decay, db_l)
        if db_r >= self.peak_right:
            self.peak_right = db_r
            self._peak_right_hold = 0.0
        elif self._peak_right_hold > self.PEAK_HOLD_SEC:
            self.peak_right = max(self.peak_right - decay, db_r)
        return (self.level_left, self.peak_left, self.level_right,
                self.peak_right)

    def print(self, bar_width: int = 60):
        """Render a console VU bar (like the reference's console meter)."""
        db_mixed = (self.level_left + self.level_right) / 2
        peak_mixed = (self.peak_left + self.peak_right) / 2
        db_level = int(bar_width - bar_width * db_mixed / self.lowest)
        peak_indicator = int(bar_width - bar_width * peak_mixed / self.lowest)
        db_meter = ("#" * db_level).ljust(bar_width)
        db_meter = db_meter[:peak_indicator] + ":" + db_meter[peak_indicator:]
        lufs = ""
        if self.loudness_meter is not None:
            # fixed width: the \r-overwritten console line must not vary
            m = self.loudness_meter.momentary
            s = self.loudness_meter.short_term
            ms = f"{m:6.1f}" if math.isfinite(m) else "  ----"
            ss = f"{s:6.1f}" if math.isfinite(s) else "  ----"
            lufs = f"  M {ms} S {ss} LUFS"
        print(f"{int(db_mixed):d} dB |{db_meter}| 0 dB{lufs}", end="\r")
