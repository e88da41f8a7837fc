"""Tracker module (MOD/XM/IT/S3M...) decode via the system libopenmpt
(copied from ``synthesizer_tpu.utils.modules``).

The sequencer layer already speaks tracker idioms (patterns, orders,
accents, swing — sequencer.py); this binding lets the PLAYBACK side
consume actual tracker module files wherever any other audio file is
accepted (jukebox decks, AudiofileToWavStream, Sample loading) by
rendering them through the host's libopenmpt.  ctypes, no subprocess;
absence degrades to DecodeError like the other optional codec rungs
(utils/codecs.py).
"""

from __future__ import annotations

import ctypes
import os
from ctypes import POINTER, byref, c_char_p, c_double, c_int, c_int32, c_size_t, c_void_p
from typing import Optional, Tuple

import numpy as np

__all__ = ["have_openmpt", "looks_like_module", "read_module",
           "probe_module", "module_title", "ModuleError",
           "MODULE_EXTENSIONS"]


class ModuleError(Exception):
    pass


#: extensions routed to this rung by the streaming ladder (libopenmpt
#: supports many more; these are the ones the magic sniffer also knows)
MODULE_EXTENSIONS = (".mod", ".xm", ".it", ".s3m", ".mptm")

_LIB: list = []


def _openmpt():
    if not _LIB:
        handle = None
        for name in ("libopenmpt.so.0", "libopenmpt.so"):
            try:
                handle = ctypes.CDLL(name)
                break
            except OSError:
                continue
        _LIB.append(handle)
    return _LIB[0]


def have_openmpt() -> bool:
    return _openmpt() is not None


_MOD_MAGICS = {b"M.K.", b"M!K!", b"M&K!", b"N.T.", b"4CHN", b"6CHN",
               b"8CHN", b"FLT4", b"FLT8", b"CD81", b"OKTA", b"OCTA",
               b"16CH", b"32CH"}


def looks_like_module(header: bytes) -> bool:
    """Magic-sniff the common tracker formats (header needs >= 1084
    bytes for the classic MOD tag at offset 1080)."""
    if header[:4] == b"IMPM":                       # Impulse Tracker
        return True
    if header[:17] == b"Extended Module: ":         # FastTracker II
        return True
    if len(header) >= 48 and header[44:48] == b"SCRM":   # ScreamTracker 3
        return True
    if len(header) >= 1084 and header[1080:1084] in _MOD_MAGICS:
        return True
    return False


def _create(data: bytes):
    lib = _openmpt()
    if lib is None:
        raise ModuleError("libopenmpt is not available on this system")
    lib.openmpt_module_create_from_memory2.restype = c_void_p
    lib.openmpt_module_create_from_memory2.argtypes = [
        c_void_p, c_size_t, c_void_p, c_void_p, c_void_p, c_void_p,
        POINTER(c_int), c_void_p, c_void_p]
    # route load errors to the library's silent logger instead of stderr
    silent = getattr(lib, "openmpt_log_func_silent", None)
    logfn = ctypes.cast(silent, c_void_p) if silent else None
    err = c_int(0)
    mod = lib.openmpt_module_create_from_memory2(
        data, len(data), logfn, None, None, None, byref(err), None, None)
    if not mod:
        raise ModuleError(f"libopenmpt cannot parse this module "
                          f"(error {err.value})")
    return lib, mod


def read_module(filename: str,
                samplerate: int = 48000) -> Tuple[np.ndarray, int, int,
                                                  int]:
    """Render a tracker module -> (frames [n, 2] int16, samplerate, 2, 2)
    through libopenmpt's own mixer at the requested rate."""
    with open(filename, "rb") as f:
        data = f.read()
    lib, mod = _create(data)
    try:
        rd = lib.openmpt_module_read_interleaved_stereo
        rd.restype = c_size_t
        rd.argtypes = [c_void_p, c_int32, c_size_t, c_void_p]
        block = 1 << 16
        buf = np.empty((block, 2), np.int16)
        chunks = []
        while True:
            n = rd(mod, samplerate, block, buf.ctypes.data)
            if n == 0:
                break
            chunks.append(buf[:n].copy())
        if not chunks:
            raise ModuleError(f"module {filename!r} rendered no audio")
        return np.concatenate(chunks), samplerate, 2, 2
    finally:
        lib.openmpt_module_destroy.argtypes = [c_void_p]
        lib.openmpt_module_destroy(mod)


def probe_module(filename: str,
                 samplerate: int = 48000) -> Tuple[int, int, int]:
    """Header-only probe -> (nframes at ``samplerate``, samplerate, 2)
    from libopenmpt's computed duration (no audio rendered)."""
    with open(filename, "rb") as f:
        data = f.read()
    lib, mod = _create(data)
    try:
        lib.openmpt_module_get_duration_seconds.restype = c_double
        lib.openmpt_module_get_duration_seconds.argtypes = [c_void_p]
        dur = lib.openmpt_module_get_duration_seconds(mod)
        return int(dur * samplerate), samplerate, 2
    finally:
        lib.openmpt_module_destroy.argtypes = [c_void_p]
        lib.openmpt_module_destroy(mod)


def module_title(filename: str) -> Optional[str]:
    """The module's embedded title ('' and absence -> None)."""
    with open(filename, "rb") as f:
        data = f.read()
    lib, mod = _create(data)
    try:
        lib.openmpt_module_get_metadata.restype = c_void_p
        lib.openmpt_module_get_metadata.argtypes = [c_void_p, c_char_p]
        ptr = lib.openmpt_module_get_metadata(mod, b"title")
        if not ptr:
            return None
        try:
            title = ctypes.string_at(ptr).decode("utf-8", "replace")
        finally:
            lib.openmpt_free_string.argtypes = [c_void_p]
            lib.openmpt_free_string(ptr)
        return title or None
    finally:
        lib.openmpt_module_destroy.argtypes = [c_void_p]
        lib.openmpt_module_destroy(mod)
