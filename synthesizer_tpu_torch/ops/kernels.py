"""Fused voice-bank render: the Hopper kernel's wrapper and its plain version.

``render_stereo`` is the port of ``synthesizer_tpu.ops.kernels.
render_stereo_pallas``.  For CUDA tensors it launches the hand-written
kernel in ``csrc/voicebank_render.cu`` (CUDA C++ for ``sm_90a``, built by
``nvcc`` at first use into ``build/`` and loaded with ``ctypes``); for CPU
tensors it runs ``render_stereo_reference``, which is the plain
``render_block`` over the same layout.  There is no fallback between the
two: a CUDA tensor launches the kernel or raises.

Nothing here imports a GPU toolchain at import time, so the CPU tests can
import the module.
"""

from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import shutil
import subprocess
from pathlib import Path

import numpy as np
import torch

from ..models.voicebank import (BANK_TABLE_LEN, I32_FIELDS, U32_FIELDS,
                                BankLayout, VoiceParams, render_block)

_SRC = Path(__file__).resolve().parent.parent / "csrc" / "voicebank_render.cu"
#: build products go under the checkout's ``build/`` (listed in .gitignore)
BUILD_DIR = Path(__file__).resolve().parents[2] / "build"
#: -fmad=false keeps every f32 multiply and add separately rounded, as the
#: plain version computes them (no --use_fast_math: pluck needs accurate
#: cosf/logf/expf and denormals must not flush)
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-fmad=false", "-shared", "-Xcompiler", "-fPIC",
              "-Xptxas", "-v")

#: per-voice parameter columns of the kernel's [V, NCOLS] int32 matrix
#: (f32 fields bit-cast); the order matches ``enum Col`` in the source
KERNEL_COLUMNS = ("wave", "base_inc", "phase0", "amp", "bias", "pan", "start",
                  "gate", "attack", "decay", "sustain_level", "release",
                  "fm_inc", "fm_phase0", "fm_depth", "fm_r", "fm_c0",
                  "pulse_width", "seed", "noise_hold", "damping",
                  "glide_inc0", "glide_d", "glide_frames")
MAX_GROUPS = 16
_REFERENCE_BLOCK = 131072


def build_library() -> tuple:
    """Compile ``csrc/voicebank_render.cu`` (once per source hash) ->
    (path of the shared library, compiler log; empty when cached)."""
    key = hashlib.sha256(_SRC.read_bytes()
                         + " ".join(NVCC_FLAGS).encode()).hexdigest()[:16]
    lib = BUILD_DIR / f"voicebank_render_{key}.so"
    if lib.exists():
        return lib, ""
    nvcc = shutil.which("nvcc") or "/usr/local/cuda/bin/nvcc"
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = lib.with_name(f"{lib.name}.{os.getpid()}.tmp")
    res = subprocess.run([nvcc, *NVCC_FLAGS, "-o", str(tmp), str(_SRC)],
                         capture_output=True, text=True)
    if res.returncode != 0:
        raise RuntimeError(f"nvcc failed ({res.returncode}):\n{res.stderr}")
    os.replace(tmp, lib)
    return lib, res.stdout + res.stderr


@functools.lru_cache(maxsize=None)
def _library() -> ctypes.CDLL:
    lib = ctypes.CDLL(str(build_library()[0]))
    fn = lib.voicebank_render
    fn.argtypes = [ctypes.c_void_p,                 # params [V, NCOLS] i32
                   ctypes.c_void_p, ctypes.c_int,   # harm_amps, row stride
                   ctypes.c_void_p,                 # table [V, 256]
                   ctypes.POINTER(ctypes.c_int32),  # groups (host) [G, 4]
                   ctypes.c_int,                    # G
                   ctypes.c_int,                    # num_harmonics
                   ctypes.c_int, ctypes.c_int,      # n0, nframes
                   ctypes.c_float,                  # f32(1/samplerate)
                   ctypes.c_int,                    # use_glide
                   ctypes.c_void_p,                 # out [nframes, 2] f32
                   ctypes.c_void_p]                 # cudaStream_t
    fn.restype = ctypes.c_int
    return lib


def _kernel_params(vp: VoiceParams) -> torch.Tensor:
    """[V, NCOLS] int32: u32 fields as their two's-complement i32 bits,
    f32 fields bit-cast."""
    cols = []
    for name in KERNEL_COLUMNS:
        f = getattr(vp, name)
        if f.dtype == torch.float32:
            cols.append(f.view(torch.int32))
        elif f.dtype == torch.int64:
            cols.append(torch.where(f >= 2 ** 31, f - 2 ** 32, f).to(torch.int32))
        else:
            cols.append(f)
    return torch.stack(cols, dim=1).contiguous()


def _check_inputs(vp: VoiceParams, n0: int, nframes: int,
                  layout: BankLayout):
    dev = vp.device
    V = vp.wave.shape[0]
    for name in KERNEL_COLUMNS:
        f = getattr(vp, name)
        want = (torch.int64 if name in U32_FIELDS
                else torch.int32 if name in I32_FIELDS else torch.float32)
        if f.device != dev or f.dtype != want or f.shape != (V,):
            raise ValueError(f"{name}: expected {want} [{V}] on {dev}, got "
                             f"{f.dtype} {tuple(f.shape)} on {f.device}")
    for name in ("harm_amps", "table"):
        f = getattr(vp, name)
        if (f.device != dev or f.dtype != torch.float32 or f.dim() != 2
                or f.shape[0] != V or not f.is_contiguous()):
            raise ValueError(f"{name}: expected contiguous f32 [{V}, ...] on "
                             f"{dev}, got {f.dtype} {tuple(f.shape)}")
    if (vp.harm_amps.shape[1] < layout.num_harmonics
            or vp.table.shape[1] != BANK_TABLE_LEN):
        raise ValueError(f"harm_amps needs >= {layout.num_harmonics} columns "
                         f"and table {BANK_TABLE_LEN}, got "
                         f"{vp.harm_amps.shape[1]} and {vp.table.shape[1]}")
    if not 0 < len(layout.groups) <= MAX_GROUPS:
        raise ValueError(f"the kernel takes 1..{MAX_GROUPS} groups, got "
                         f"{len(layout.groups)}")
    for (wid, _, start, count) in layout.groups:
        if not -1 <= wid <= 12 or start < 0 or count < 0 or start + count > V:
            raise ValueError(f"bad group {(wid, start, count)} for {V} voices")
    if n0 < 0 or nframes <= 0 or n0 + nframes > 2 ** 31 - 1:
        raise ValueError(f"frames [{n0}, {n0 + nframes}) outside the "
                         f"kernel's i32 frame range")


def render_stereo(vp: VoiceParams, n0: int, *, nframes: int,
                  samplerate: int, layout: BankLayout,
                  use_glide: bool = False) -> torch.Tensor:
    """Render [nframes, 2] f32 starting at absolute frame n0.

    CUDA tensors: one launch of the Hopper kernel, counted in
    ``render_stereo.launches``.  CPU tensors: the plain version."""
    if vp.device.type == "cpu":
        return render_stereo_reference(vp, n0, nframes=nframes,
                                       samplerate=samplerate, layout=layout,
                                       use_glide=use_glide)
    if vp.device.type != "cuda":
        raise ValueError(f"render_stereo takes CPU or CUDA tensors, got "
                         f"{vp.device}")
    n0 = int(n0)
    _check_inputs(vp, n0, nframes, layout)
    lib = _library()
    params = _kernel_params(vp)
    groups = [int(x) for g in layout.groups for x in g]
    gbuf = (ctypes.c_int32 * len(groups))(*groups)
    out = torch.empty((nframes, 2), dtype=torch.float32, device=vp.device)
    with torch.cuda.device(vp.device):
        stream = torch.cuda.current_stream().cuda_stream
        rc = lib.voicebank_render(
            params.data_ptr(), vp.harm_amps.data_ptr(),
            vp.harm_amps.shape[1], vp.table.data_ptr(), gbuf,
            len(layout.groups), layout.num_harmonics, n0, nframes,
            float(np.float32(1.0 / samplerate)), int(use_glide),
            out.data_ptr(), stream)
    if rc != 0:
        raise RuntimeError(f"voicebank_render launch failed: CUDA error {rc}")
    render_stereo.launches += 1
    return out


render_stereo.launches = 0


def render_stereo_reference(vp: VoiceParams, n0: int, *, nframes: int,
                            samplerate: int, layout: BankLayout,
                            use_glide: bool = False) -> torch.Tensor:
    """The kernel's plain version: ``render_block`` over the same layout,
    on vp's device, in blocks of at most 131072 frames to bound memory
    (block size does not change the result)."""
    blocks = []
    for b0 in range(0, nframes, _REFERENCE_BLOCK):
        nb = min(_REFERENCE_BLOCK, nframes - b0)
        blocks.append(render_block(vp, n0 + b0, nb, samplerate,
                                   layout.num_harmonics, layout,
                                   use_glide=use_glide))
    return torch.cat(blocks)
