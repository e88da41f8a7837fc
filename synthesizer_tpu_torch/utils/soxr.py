"""High-quality resampling via the system libsoxr (ctypes binding; copied
from ``synthesizer_tpu.utils.soxr``).

The reference's ``AudiofileToWavStream(hqresample=True)`` raised the
ffmpeg swr filter quality for music-file decode (reference
synthplayer/streaming.py); our in-process decode rungs made that flag a
no-op for mp3/ogg/opus.  This binding restores it: when libsoxr is on
the system, lossy-codec decodes can resample through the SoX VHQ
resampler instead of the exact-but-linear audioop-semantics ratecv.

The audioop-contract paths (WAV/AIFF/AU/FLAC conversions, Sample.resample,
the sequencer) NEVER use this — their spec is bit-exact ratecv
(docs/NUMERICS.md); soxr is opt-in polish for lossy music
sources only, exactly like the reference's flag.
"""

from __future__ import annotations

import ctypes
from ctypes import POINTER, byref, c_char_p, c_double, c_size_t, c_uint, c_void_p

import numpy as np

__all__ = ["have_soxr", "soxr_resample", "SoxrError"]


class SoxrError(Exception):
    pass


_LIB: list = []          # [handle-or-None] once probed


def _soxr():
    if not _LIB:
        handle = None
        for name in ("libsoxr.so.0", "libsoxr.so"):
            try:
                handle = ctypes.CDLL(name)
                break
            except OSError:
                continue
        _LIB.append(handle)
    return _LIB[0]


def have_soxr() -> bool:
    return _soxr() is not None


def soxr_resample(frames: np.ndarray, in_rate: int,
                  out_rate: int) -> np.ndarray:
    """Resample int16 frames [n, ch] -> [m, ch] with soxr's default
    (high) quality; float32 interleaved I/O, NULL specs = SOXR_HQ."""
    lib = _soxr()
    if lib is None:
        raise SoxrError("libsoxr is not available on this system")
    frames = np.asarray(frames)
    if frames.ndim == 1:
        frames = frames[:, None]
    n, ch = frames.shape
    if in_rate == out_rate or n == 0:
        return np.ascontiguousarray(frames, np.int16)
    fin = np.ascontiguousarray(frames.astype(np.float32) / 32768.0)
    olen = int(np.ceil(n * out_rate / in_rate)) + 16
    fout = np.empty((olen, ch), np.float32)
    idone = c_size_t(0)
    odone = c_size_t(0)
    lib.soxr_oneshot.restype = c_char_p      # soxr_error_t == const char*
    lib.soxr_oneshot.argtypes = [c_double, c_double, c_uint,
                                 c_void_p, c_size_t, POINTER(c_size_t),
                                 c_void_p, c_size_t, POINTER(c_size_t),
                                 c_void_p, c_void_p, c_void_p]
    err = lib.soxr_oneshot(float(in_rate), float(out_rate), ch,
                           fin.ctypes.data, n, byref(idone),
                           fout.ctypes.data, olen, byref(odone),
                           None, None, None)
    if err:
        raise SoxrError(err.decode("utf-8", "replace"))
    out = fout[:odone.value]
    return np.clip(np.rint(out.astype(np.float64) * 32768.0),
                   -32768, 32767).astype(np.int16)
