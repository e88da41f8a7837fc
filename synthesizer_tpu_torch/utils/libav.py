"""Universal audio decode/encode via the system libavformat/libavcodec
(copied from ``synthesizer_tpu.utils.libav``).

The in-process ladder (utils/decoders.py) handles the spec-stable and
common formats with our own parsers and direct codec-library bindings
(WAV/AIFF/AU/FLAC natively, mp3 via libmpg123, ogg via libvorbisfile,
opus via libopus, modules via libopenmpt) — those rungs carry the
numeric contracts and known-answer tests.  THIS rung is the catch-all
behind them: a small C shim (native/avshim.c, compiled on first use
against the host's own ffmpeg dev headers) that decodes ANY
libav-supported audio file (m4a/aac, wma, mka/webm, ...) to interleaved
s16 at native rate, replacing the reference's ffmpeg *subprocess*
ladder (reference synthplayer/streaming.py) with an in-process call.

Absence of the libraries or headers degrades exactly like the other
optional rungs: ``have_libav()`` is False and callers fall through to
the ffmpeg-binary ladder / DecodeError.
"""

from __future__ import annotations

import ctypes
import os
import threading
from ctypes import POINTER, byref, c_char_p, c_int, c_longlong
from typing import Tuple

import numpy as np

from .native import build_shared

__all__ = ["have_libav", "read_with_libav", "probe_libav",
           "write_with_libav", "LibavError"]


class LibavError(Exception):
    pass


_LINK = ["-lavformat", "-lavcodec", "-lavutil", "-lswresample"]

_lib = None
_tried = False
_lock = threading.Lock()


def _load():
    global _lib, _tried
    with _lock:
        if _tried:
            return _lib
        _tried = True
        try:
            lib = ctypes.CDLL(build_shared(
                "avshim", ["-O2", "-std=c11",
                           "-I/usr/include/x86_64-linux-gnu"], _LINK,
                timeout=120))
        except Exception:
            return None
        i16p = POINTER(ctypes.c_int16)
        lib.avshim_decode.argtypes = [
            c_char_p, POINTER(i16p), POINTER(c_longlong), POINTER(c_int),
            POINTER(c_int), c_char_p, c_int]
        lib.avshim_decode.restype = c_int
        lib.avshim_probe.argtypes = [
            c_char_p, POINTER(c_longlong), POINTER(c_int), POINTER(c_int),
            c_char_p, c_int, c_char_p, c_int]
        lib.avshim_probe.restype = c_int
        lib.avshim_encode.argtypes = [
            c_char_p, i16p, c_longlong, c_int, c_int, c_int,
            c_char_p, c_int]
        lib.avshim_encode.restype = c_int
        lib.avshim_free.argtypes = [i16p]
        lib.avshim_free.restype = None
        _lib = lib
        return _lib


def have_libav() -> bool:
    return _load() is not None


def read_with_libav(filename: str) -> Tuple[np.ndarray, int, int, int]:
    """Decode any libav-supported file -> (frames [n, nch] int16, rate,
    width=2, nch).  >2-channel sources downmix to stereo in the shim."""
    lib = _load()
    if lib is None:
        raise LibavError("libav (ffmpeg shared libraries + dev headers) "
                         "is not available on this system")
    out = POINTER(ctypes.c_int16)()
    nframes = c_longlong(0)
    rate = c_int(0)
    nch = c_int(0)
    err = ctypes.create_string_buffer(256)
    rc = lib.avshim_decode(os.fsencode(filename), byref(out),
                           byref(nframes), byref(rate), byref(nch),
                           err, len(err))
    if rc != 0:
        raise LibavError(f"libav cannot decode {filename!r}: "
                         f"{err.value.decode('utf-8', 'replace')}")
    try:
        n, ch = nframes.value, nch.value
        frames = np.ctypeslib.as_array(out, shape=(n, ch)).copy()
    finally:
        lib.avshim_free(out)
    return frames, rate.value, 2, ch


def probe_libav(filename: str) -> Tuple[int, int, int]:
    """Header-only probe -> (nframes, rate, nch) from the container's
    declared duration (0 frames when the container carries none)."""
    lib = _load()
    if lib is None:
        raise LibavError("libav is not available on this system")
    nframes = c_longlong(0)
    rate = c_int(0)
    nch = c_int(0)
    codec = ctypes.create_string_buffer(32)
    err = ctypes.create_string_buffer(256)
    rc = lib.avshim_probe(os.fsencode(filename), byref(nframes),
                          byref(rate), byref(nch), codec, len(codec),
                          err, len(err))
    if rc != 0:
        raise LibavError(f"libav cannot probe {filename!r}: "
                         f"{err.value.decode('utf-8', 'replace')}")
    return int(nframes.value), rate.value, nch.value


def write_with_libav(filename: str, frames: np.ndarray, samplerate: int,
                     nchannels: int, bitrate: int = 128000) -> None:
    """Encode int16 frames into whatever container/codec the filename's
    extension implies (.m4a -> AAC in MP4, .aac -> ADTS AAC, ...)."""
    lib = _load()
    if lib is None:
        raise LibavError("libav is not available on this system")
    frames = np.ascontiguousarray(frames, np.int16).reshape(-1, nchannels)
    err = ctypes.create_string_buffer(256)
    rc = lib.avshim_encode(
        os.fsencode(filename),
        frames.ctypes.data_as(POINTER(ctypes.c_int16)),
        len(frames), samplerate, nchannels, bitrate, err, len(err))
    if rc != 0:
        raise LibavError(f"libav cannot encode {filename!r}: "
                         f"{err.value.decode('utf-8', 'replace')}")
