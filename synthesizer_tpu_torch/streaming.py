"""Streaming layer: decode, chunked sample streams, realtime stream mixing
(port of ``synthesizer_tpu.streaming``).

* ``AudiofileToWavStream`` -- decode any audio file to a PCM WAV stream.
  WAV files in the target format pass through; AIFF/AIFF-C, Sun AU, FLAC
  and the compressed WAV codecs (G.711 u-law/A-law, IMA ADPCM, IEEE float)
  decode in-process (``utils.decoders``, ``utils.flac``); mp3/mp2, Ogg
  Vorbis and Opus through the system codec libraries when present
  (``utils.codecs``); the rest spawns an ffmpeg (or oggdec) subprocess
  when the binary exists.  Container and codec work is host code; the
  decoded audio is normalized (clip, resample, width, channels) by
  ``Sample`` ops on ``device``.
* ``SampleStream`` -- iterate a WAV stream as fixed-size ``Sample``\\ s on
  ``device``.
* ``EndlessFramesFilter`` -- pad a finished stream with endless silence.
* ``VolumeFilter`` -- per-stream volume (``Sample.amplify`` per chunk).
* ``RateConvertFilter`` -- live rate conversion; the resampler's carry
  stays on the device.
* ``StreamMixer`` -- mix N live streams into timestamped chunks (the
  jukebox crossfade engine); the chunk addition runs on the device.

Every entry point puts its samples on the card unless the caller passes
``device="cpu"``; a filter keeps the device of the chunks it is given.
"""

from __future__ import annotations

import io
import json
import shutil
import subprocess
import wave
from typing import BinaryIO, Iterator, List, Optional, Tuple, Union

import numpy as np
import torch

from . import params
from .ops.pcm import DTYPES as _TDT
from .sample import Sample
from .utils.device import resolve as _device

__all__ = ["AudiofileToWavStream", "SampleStream", "EndlessFramesFilter",
           "VolumeFilter", "RateConvertFilter", "StreamMixer", "StreamingError"]

class StreamingError(Exception):
    pass


def _ffmpeg_path() -> Optional[str]:
    return shutil.which("ffmpeg")


def _ffprobe_path() -> Optional[str]:
    return shutil.which("ffprobe")


def _oggdec_path() -> Optional[str]:
    return shutil.which("oggdec")


class AudiofileToWavStream(io.RawIOBase):
    """Read any audio file as a WAV stream of normalized PCM.

    WAV files in the target format pass through; other WAVs are converted
    in memory (through ``Sample`` ops on ``device``); everything else is
    decoded in-process or piped through ffmpeg/oggdec when present
    (``format_probe`` holds ffprobe's result)."""

    def __init__(self, filename: str, samplerate: int = 0, nchannels: int = 0,
                 samplewidth: int = 0, hqresample: bool = True,
                 startfrom: float = 0.0, duration: float = 0.0,
                 device="cuda"):
        super().__init__()
        self.filename = filename
        self.samplerate = samplerate or params.norm_samplerate
        self.nchannels = nchannels or params.norm_nchannels
        self.samplewidth = samplewidth or params.norm_samplewidth
        self.hqresample = hqresample
        self.startfrom = startfrom
        self.duration = duration
        self.device = _device(device)
        self._stream: Optional[BinaryIO] = None
        self._proc: Optional[subprocess.Popen] = None
        self.format_probe = None
        lower = filename.lower()
        if lower.endswith((".wav", ".wave")):
            self._open_wav()
        elif lower.endswith((".aif", ".aiff", ".aifc", ".au", ".snd",
                             ".flac", ".mp3", ".mp2", ".ogg", ".oga",
                             ".opus", ".mod", ".xm", ".it", ".s3m",
                             ".mptm", ".m4a", ".aac", ".mp4", ".wma",
                             ".mka", ".webm")):
            # in-process first; a file every in-process rung rejects
            # (damaged frames, missing libraries) still gets ffmpeg, or
            # oggdec for .ogg, when the binary exists
            try:
                self._open_host_decoder()
            except StreamingError:
                if _ffmpeg_path() is None and not (
                        lower.endswith((".ogg", ".oga"))
                        and _oggdec_path() is not None):
                    raise
                self._open_ffmpeg()
        else:
            self._open_ffmpeg()

    def _target_format_ok(self, w: wave.Wave_read) -> bool:
        return (w.getframerate() == self.samplerate
                and w.getnchannels() == self.nchannels
                and w.getsampwidth() == self.samplewidth
                and not self.startfrom and not self.duration)

    def _open_wav(self) -> None:
        try:
            with wave.open(self.filename, "rb") as w:
                ok = self._target_format_ok(w)
        except (wave.Error, EOFError):
            # compressed WAV (u-law/A-law/IMA-ADPCM/float): in-process
            self._open_host_decoder()
            return
        if ok:
            self._stream = open(self.filename, "rb")
            return
        self._stream = self._normalized_wav(
            Sample(wave_file=self.filename, device=self.device))

    def _open_host_decoder(self) -> None:
        """Decode AIFF/AU/compressed-WAV/FLAC/mp3/ogg/opus in-process
        (``utils.decoders``), then normalize through the same ``Sample``
        pipeline as every other rung."""
        from .utils.decoders import DecodeError, decode_audio_file
        try:
            frames, rate, width, nch = decode_audio_file(self.filename)
        except DecodeError as e:
            raise StreamingError(str(e)) from e
        hq_pending = False
        if (self.hqresample and rate != self.samplerate and width == 2
                and self._lossy_source()):
            # the hqresample flag maps to soxr for lossy music sources; the
            # lossless formats keep the exact ratecv
            from .utils.soxr import SoxrError, have_soxr, soxr_resample
            if have_soxr():
                try:
                    frames = soxr_resample(frames, rate, self.samplerate)
                    rate = self.samplerate
                except SoxrError:
                    pass
            if rate != self.samplerate:
                # no libsoxr here: the windowed-sinc resampler is the hq rung
                hq_pending = True
        smp = Sample.from_raw_frames(
            np.ascontiguousarray(frames).tobytes(), width, rate, nch,
            device=self.device)
        if hq_pending:
            # resample BEFORE _normalized_wav's startfrom/duration clip: a
            # clip first would feed the sinc filter zeros where the clip
            # edge has real neighbours, and the clip must fall on
            # target-rate frames
            try:
                smp.resample(self.samplerate, quality="hq")
            except ValueError:
                pass           # a ratio the hq path refuses: exact ratecv
        self._stream = self._normalized_wav(smp)

    def _lossy_source(self) -> bool:
        """mp3/ogg/opus/aac/wma/mka by magic (these came through a lossy
        codec, so the exact-ratecv contract does not apply)."""
        from .utils.codecs import looks_like_mpeg, looks_like_ogg
        try:
            with open(self.filename, "rb") as f:
                magic = f.read(12)
        except OSError:
            return False
        if looks_like_mpeg(magic) or looks_like_ogg(magic):
            return True
        if magic[4:8] == b"ftyp":                  # MP4 family (m4a)
            return True
        if (len(magic) >= 2 and magic[0] == 0xFF
                and (magic[1] & 0xF6) == 0xF0):    # ADTS AAC
            return True
        return magic[:4] in (b"\x30\x26\xb2\x75",  # ASF (wma)
                             b"\x1a\x45\xdf\xa3")  # EBML (mka/webm)

    def _normalized_wav(self, smp: Sample) -> io.BytesIO:
        """Clip/resample/width/channel-convert a decoded Sample to the
        target stream format -> in-memory WAV."""
        if self.startfrom or self.duration:
            end = (self.startfrom + self.duration) if self.duration else smp.duration
            smp.clip(self.startfrom, end)
        smp.resample(self.samplerate)
        if self.samplewidth != smp.samplewidth:
            if self.samplewidth == 2:
                smp.make_16bit(maximize_amplitude=False)
            else:
                smp.make_32bit(scale_amplitude=True)
        if self.nchannels == 2:
            smp.stereo()
        elif self.nchannels == 1 and smp.nchannels == 2:
            smp.mono()
        bio = io.BytesIO()
        smp.write_wav(bio)
        bio.seek(0)
        return bio

    def _open_ffmpeg(self) -> None:
        ffmpeg = _ffmpeg_path()
        if ffmpeg is None:
            if (self.filename.lower().endswith(".ogg")
                    and _oggdec_path() is not None):
                self._open_oggdec()
                return
            from .utils.decoders import DecodeError
            try:
                # magic-sniffing catches misnamed wav/aiff/au files
                self._open_host_decoder()
                return
            except (StreamingError, DecodeError, OSError):
                pass
            raise StreamingError(
                f"cannot decode {self.filename!r}: no ffmpeg available "
                "and no in-process decoder recognizes it")
        if _ffprobe_path():
            try:
                out = subprocess.run(
                    [_ffprobe_path(), "-v", "quiet", "-print_format", "json",
                     "-show_format", "-show_streams", self.filename],
                    capture_output=True, check=True).stdout
                self.format_probe = json.loads(out)
            except Exception:
                self.format_probe = None
        codec = {1: "pcm_u8", 2: "pcm_s16le", 4: "pcm_s32le"}[self.samplewidth]
        cmd = [ffmpeg, "-v", "quiet"]
        if self.startfrom:
            cmd += ["-ss", str(self.startfrom)]
        cmd += ["-i", self.filename]
        if self.duration:
            cmd += ["-t", str(self.duration)]
        if self.hqresample:
            # raise the swr resampler's filter quality (WAV-path
            # conversions keep the exact ratecv regardless)
            cmd += ["-af",
                    f"aresample=osr={self.samplerate}:filter_size=64:cutoff=0.95"]
        cmd += ["-ar", str(self.samplerate), "-ac", str(self.nchannels),
                "-acodec", codec, "-f", "wav", "-"]
        self._proc = subprocess.Popen(cmd, stdout=subprocess.PIPE)
        self._stream = self._proc.stdout

    def _open_oggdec(self) -> None:
        """ffmpeg-less .ogg fallback: oggdec emits the source rate/width,
        so the decoded WAV is normalized in memory."""
        proc = subprocess.run([_oggdec_path(), "-Q", "-o", "-", self.filename],
                              capture_output=True)
        if proc.returncode != 0 or not proc.stdout[:4] == b"RIFF":
            raise StreamingError(
                f"oggdec failed to decode {self.filename!r}")
        bio = io.BytesIO(proc.stdout)
        with wave.open(bio, "rb") as w:
            frames = w.readframes(w.getnframes())
            smp = Sample.from_raw_frames(frames, w.getsampwidth(),
                                         w.getframerate(), w.getnchannels(),
                                         device=self.device)
        self._stream = self._normalized_wav(smp)

    def read(self, size: int = -1) -> bytes:
        return self._stream.read(size)

    def readable(self) -> bool:
        return True

    def close(self) -> None:
        if self._stream is not None:
            self._stream.close()
        if self._proc is not None:
            self._proc.terminate()
            self._proc.wait()
        super().close()


class SampleStream:
    """Iterate a WAV stream (or file) as fixed-size Samples on ``device``.

    The WAV header is parsed once; each chunk is one host -> device copy."""

    def __init__(self, wav_stream: Union[str, BinaryIO, AudiofileToWavStream],
                 frames_per_chunk: int = 0, device="cuda"):
        self.frames_per_chunk = frames_per_chunk or params.norm_frames_per_chunk
        self.device = _device(device)
        self._wav = wave.open(wav_stream, "rb")
        self.samplerate = self._wav.getframerate()
        self.nchannels = self._wav.getnchannels()
        self.samplewidth = self._wav.getsampwidth()

    def __iter__(self) -> Iterator[Sample]:
        return self

    def __next__(self) -> Sample:
        frames = self._wav.readframes(self.frames_per_chunk)
        if not frames:
            raise StopIteration
        return Sample.from_raw_frames(frames, self.samplewidth,
                                      self.samplerate, self.nchannels,
                                      device=self.device)

    def close(self) -> None:
        self._wav.close()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()


class EndlessFramesFilter:
    """Wrap a sample stream so it yields silence chunks forever after the
    source ends (keeps StreamMixer timing alive).  The silence lies on the
    device of the source's last chunk, or on ``device`` (the stream's own
    ``device`` by default) if it had none."""

    def __init__(self, stream: Iterator[Sample], frames_per_chunk: int = 0,
                 samplerate: int = 0, nchannels: int = 0, samplewidth: int = 0,
                 device=None):
        self.stream = stream
        self.frames_per_chunk = frames_per_chunk or params.norm_frames_per_chunk
        self.samplerate = samplerate or getattr(stream, "samplerate", params.norm_samplerate)
        self.nchannels = nchannels or getattr(stream, "nchannels", params.norm_nchannels)
        self.samplewidth = samplewidth or getattr(stream, "samplewidth", params.norm_samplewidth)
        self.device = device if device is not None else getattr(
            stream, "device", "cuda")
        self._ended = False

    def __iter__(self):
        return self

    def __next__(self) -> Sample:
        if not self._ended:
            try:
                chunk = next(self.stream)
                self.device = chunk.device
                return chunk
            except StopIteration:
                self._ended = True
        silence = torch.zeros((self.frames_per_chunk, self.nchannels),
                              dtype=_TDT[self.samplewidth],
                              device=_device(self.device))
        return Sample.from_torch(silence, self.samplerate, self.samplewidth)


class VolumeFilter:
    """Per-stream volume: ``Sample.amplify`` on every chunk."""

    def __init__(self, stream: Iterator[Sample], volume: float = 1.0):
        self.stream = stream
        self.volume = volume

    def __iter__(self):
        return self

    def __next__(self) -> Sample:
        return next(self.stream).amplify(self.volume)


class RateConvertFilter:
    """Live rate conversion of a sample stream, on the chunks' device.

    Wraps a chunked stream and emits the same audio at ``target_rate``:
    quality='linear' (default) is the exact stateful ratecv
    (``ops.resample.StreamingResampler``, bit-exact to audioop);
    quality='hq' is the windowed-sinc twin
    (``ops.resample.StreamingHQResampler``, the streaming form of
    ``Sample.resample(quality='hq')`` with its end-of-stream flush of the
    filter tail).  The carry stays on the device and the host tracks only
    the integer output phase: no chunk waits for the device.  Output chunk
    sizes vary (the rate ratio dictates what each input chunk completes).
    """

    def __init__(self, stream: Iterator[Sample], target_rate: int,
                 quality: str = "linear"):
        from .ops.resample import StreamingHQResampler, StreamingResampler
        if quality not in ("linear", "hq"):
            raise ValueError(f"unknown resample quality {quality!r}")
        self.stream = stream
        self.target_rate = target_rate
        self._rs: Optional[object] = None
        self._make = StreamingHQResampler if quality == "hq" \
            else StreamingResampler
        self._hq = quality == "hq"
        self._meta: Optional[tuple] = None
        self._done = False
        self._pending_in: Optional[Sample] = None   # requeued at a format change
        self._src_sig: Optional[tuple] = None       # (rate, width, nch) of _rs

    def __iter__(self):
        return self

    def _flush_tail(self) -> Optional[Sample]:
        """Drain the hq resampler's buffered filter tail (linear withholds
        no rows)."""
        if self._hq and self._rs is not None:
            y, n = self._rs.flush()
            if n:
                width, name = self._meta
                return Sample.from_torch(y, self.target_rate, width, name)
        return None

    def __next__(self) -> Sample:
        while True:
            if self._done:
                raise StopIteration
            if self._pending_in is not None:
                chunk, self._pending_in = self._pending_in, None
            else:
                try:
                    chunk = next(self.stream)
                except StopIteration:
                    self._done = True
                    tail = self._flush_tail()
                    if tail is not None:
                        return tail
                    raise
            sig = (chunk.samplerate, chunk.samplewidth, chunk.nchannels)
            if self._rs is not None and sig != self._src_sig:
                # a mid-stream format change: flush the active resampler's
                # tail first so the stream stays in time order, retire it,
                # and requeue the chunk for a resampler of its own format
                tail = self._flush_tail()
                self._rs = None
                self._meta = None
                self._pending_in = chunk
                if tail is not None:
                    return tail
                continue
            if chunk.samplerate == self.target_rate:
                return chunk
            if self._rs is None:
                self._rs = self._make(chunk.samplerate, self.target_rate,
                                      nchannels=chunk.nchannels,
                                      dtype=_TDT[chunk.samplewidth],
                                      device=chunk.device)
                self._meta = (chunk.samplewidth, chunk.name)
                self._src_sig = sig
            y, n = self._rs.push(chunk.torch_frames)
            if n == 0 and self._hq:
                continue          # window not yet full: pull more
            return Sample.from_torch(y, self.target_rate, chunk.samplewidth,
                                     chunk.name)


class StreamMixer:
    """Mix N live sample streams into timestamped chunks in realtime.

    Yields ``(timestamp_seconds, Sample)`` tuples; streams can be added and
    removed while running (two-deck crossfading).  All stream chunks share
    the normalized format; the silence of an endless stream and of an empty
    mixer lies on ``device``."""

    def __init__(self, streams: List[Iterator[Sample]] = (),
                 endless: bool = False, samplerate: int = 0, nchannels: int = 0,
                 samplewidth: int = 0, frames_per_chunk: int = 0,
                 device="cuda"):
        self.samplerate = samplerate or params.norm_samplerate
        self.nchannels = nchannels or params.norm_nchannels
        self.samplewidth = samplewidth or params.norm_samplewidth
        self.frames_per_chunk = frames_per_chunk or params.norm_frames_per_chunk
        self.device = _device(device)
        self.endless = endless
        self.timestamp = 0.0
        self._streams: List[Iterator[Sample]] = []
        for s in streams:
            self.add_stream(s)

    def add_stream(self, stream: Iterator[Sample], endless: bool = False):
        if endless:
            stream = EndlessFramesFilter(stream, self.frames_per_chunk,
                                         self.samplerate, self.nchannels,
                                         self.samplewidth, self.device)
        self._streams.append(stream)
        return stream

    def remove_stream(self, stream) -> None:
        if stream in self._streams:
            self._streams.remove(stream)

    def close(self) -> None:
        for s in list(self._streams):
            closer = getattr(s, "close", None)
            if closer:
                closer()
        self._streams.clear()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()

    def __iter__(self) -> Iterator[Tuple[float, Sample]]:
        chunk_dur = self.frames_per_chunk / self.samplerate
        while self.endless or self._streams:
            mixed: Optional[Sample] = None
            for stream in list(self._streams):
                try:
                    chunk = next(stream)
                except StopIteration:
                    self.remove_stream(stream)
                    continue
                if chunk.nframes < self.frames_per_chunk:
                    chunk.add_silence(
                        (self.frames_per_chunk - chunk.nframes) / self.samplerate)
                if mixed is None:
                    mixed = chunk.copy()
                else:
                    mixed.mix(chunk)
            if mixed is None:
                z = torch.zeros((self.frames_per_chunk, self.nchannels),
                                dtype=_TDT[self.samplewidth],
                                device=self.device)
                mixed = Sample.from_torch(z, self.samplerate,
                                          self.samplewidth)
            yield self.timestamp, mixed
            self.timestamp += chunk_dur
