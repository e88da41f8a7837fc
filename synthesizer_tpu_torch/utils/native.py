"""ctypes bindings for the native pcmops library (copied from
``synthesizer_tpu.utils.native``), and the build of the repo's native C
libraries.

``build_shared`` compiles one source of the repo's ``native/`` directory
(``pcmops.c``, ``flacdec.c``, ``avshim.c``, all unchanged) into
``build/native/`` at first use, when a C compiler is available.  The JAX
package builds its own copies next to the sources; the port never writes
there, so the two packages never write one ``.so`` at once.  A build goes
to a temporary name and is renamed into place, so two processes that build
the same library at once (test workers) each load a whole file.

Every pcmops binding has a numpy fallback, so the package works without a
toolchain.  Used by the realtime playback path, where a launch per 33 ms
chunk would cost more than the K-way add it runs: bulk DSP stays on the
device.
"""

from __future__ import annotations

import ctypes
import os
import subprocess
import tempfile
import threading
from typing import Optional, Sequence, Tuple

import numpy as np

_REPO = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))
NATIVE_SRC = os.path.join(_REPO, "native")
BUILD_DIR = os.path.join(_REPO, "build", "native")


def build_shared(name: str, cflags: Sequence[str], libs: Sequence[str] = (),
                 timeout: float = 60) -> str:
    """``native/<name>.c`` -> ``build/native/lib<name>.so`` (rebuilt when
    the source is newer) -> the library's path.  Raises when the compiler
    fails or is missing."""
    src = os.path.join(NATIVE_SRC, f"{name}.c")
    so = os.path.join(BUILD_DIR, f"lib{name}.so")
    if os.path.exists(so) and os.path.getmtime(so) >= os.path.getmtime(src):
        return so
    os.makedirs(BUILD_DIR, exist_ok=True)
    fd, tmp = tempfile.mkstemp(suffix=".so", dir=BUILD_DIR)
    os.close(fd)
    try:
        subprocess.run(["cc", *cflags, "-fPIC", "-shared", "-o", tmp, src,
                        *libs], check=True, capture_output=True,
                       timeout=timeout)
        os.replace(tmp, so)
    finally:
        if os.path.exists(tmp):
            os.remove(tmp)
    return so


_lib: Optional[ctypes.CDLL] = None
_tried = False
_lock = threading.Lock()


def _load() -> Optional[ctypes.CDLL]:
    global _lib, _tried
    with _lock:
        if _tried:
            return _lib
        _tried = True
        try:
            lib = ctypes.CDLL(build_shared("pcmops",
                                           ["-O3", "-std=c11"], ["-lm"]))
        except Exception:
            return None
        i16p = ctypes.POINTER(ctypes.c_int16)
        lib.sat_add_i16.argtypes = [i16p, i16p, i16p, ctypes.c_size_t]
        lib.sat_add_i32.argtypes = [ctypes.POINTER(ctypes.c_int32)] * 3 + [ctypes.c_size_t]
        lib.mix_k_i16.argtypes = [ctypes.POINTER(i16p), ctypes.c_int, i16p,
                                  ctypes.c_size_t]
        lib.mul_floor_i16.argtypes = [i16p, ctypes.c_float, i16p, ctypes.c_size_t]
        lib.peak_i16.argtypes = [i16p, ctypes.c_size_t]
        lib.peak_i16.restype = ctypes.c_int32
        lib.mean_square_i16.argtypes = [i16p, ctypes.c_size_t]
        lib.mean_square_i16.restype = ctypes.c_double
        lib.vu_i16.argtypes = [i16p, ctypes.c_size_t,
                               ctypes.POINTER(ctypes.c_int32),
                               ctypes.POINTER(ctypes.c_double)]
        _lib = lib
        return _lib


def available() -> bool:
    return _load() is not None


def _i16p(a: np.ndarray):
    return a.ctypes.data_as(ctypes.POINTER(ctypes.c_int16))


def sat_add_i16(a: np.ndarray, b: np.ndarray) -> np.ndarray:
    """Saturating int16 add (contiguous arrays of equal size)."""
    lib = _load()
    a = np.ascontiguousarray(a, np.int16)
    b = np.ascontiguousarray(b, np.int16)
    if lib is None:
        return np.clip(a.astype(np.int32) + b.astype(np.int32),
                       -32768, 32767).astype(np.int16)
    out = np.empty_like(a)
    lib.sat_add_i16(_i16p(a), _i16p(b), _i16p(out), a.size)
    return out


def mix_k_i16(bufs: Sequence[np.ndarray]) -> np.ndarray:
    """Sum K int16 chunks in int32, saturate once (RealTimeMixer hot path)."""
    lib = _load()
    bufs = [np.ascontiguousarray(b, np.int16) for b in bufs]
    if lib is None:
        acc = np.zeros(bufs[0].shape, np.int32)
        for b in bufs:
            acc += b
        return np.clip(acc, -32768, 32767).astype(np.int16)
    out = np.empty_like(bufs[0])
    arr_t = ctypes.POINTER(ctypes.c_int16) * len(bufs)
    ptrs = arr_t(*[_i16p(b) for b in bufs])
    lib.mix_k_i16(ptrs, len(bufs), _i16p(out), out.size)
    return out


def mul_floor_i16(a: np.ndarray, factor: float) -> np.ndarray:
    """f32-spec scale: floor(f32(a) * f32(factor)), clamp."""
    lib = _load()
    a = np.ascontiguousarray(a, np.int16)
    if lib is None:
        p = a.astype(np.float32) * np.float32(factor)
        return np.clip(np.floor(p.astype(np.float64)), -32768, 32767).astype(np.int16)
    out = np.empty_like(a)
    lib.mul_floor_i16(_i16p(a), ctypes.c_float(factor), _i16p(out), a.size)
    return out


def vu_i16(stereo: np.ndarray) -> Tuple[int, int, float, float]:
    """Interleaved stereo [n, 2] -> (peak_l, peak_r, ms_l, ms_r)."""
    lib = _load()
    a = np.ascontiguousarray(stereo, np.int16)
    n = a.shape[0]
    if lib is None:
        l, r = a[:, 0].astype(np.float64), a[:, 1].astype(np.float64)
        return (int(np.abs(a[:, 0].astype(np.int32)).max(initial=0)),
                int(np.abs(a[:, 1].astype(np.int32)).max(initial=0)),
                float((l * l).mean()) if n else 0.0,
                float((r * r).mean()) if n else 0.0)
    peaks = (ctypes.c_int32 * 2)()
    ms = (ctypes.c_double * 2)()
    lib.vu_i16(_i16p(a), n, peaks, ms)
    return int(peaks[0]), int(peaks[1]), float(ms[0]), float(ms[1])
