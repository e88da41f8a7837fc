"""Fused voice-bank render: the Hopper kernels' wrappers and their plain
versions.

``render_stereo`` is the port of ``synthesizer_tpu.ops.kernels.
render_stereo_pallas``.  For CUDA tensors it launches the two hand-written
kernels in ``csrc/voicebank_render.cu`` (CUDA C++ for ``sm_90a``, built by
``nvcc`` at first use into ``build/`` and loaded with ``ctypes``): the
per-voice setup kernel (``voice_setup``, plain versions ``voice_constants``
and, for its per-segment pass over the curves, ``curve_constants``) and the
tiled render kernel that skips silent voice-tiles (plain version of its
test: ``active_voice_tiles``) and looks a curve's segments up once per
voice and tile (plain version: ``tile_segment_windows``).  The render takes
the pitch, amplitude and FM-depth curves (``use_bend``/``use_amp``/``use_dmod``) and, for the
sparse render, per-chunk rows of candidate voices (``idx``).  For CPU
tensors it runs ``render_stereo_reference``, the plain ``render_block``
over the same layout and rows.  With per-voice bus ids (``seg``, ``nseg``)
the render gives each voice's signal to its own stereo bus (the segment
buses of ``render_block``): on the card a span pass (plain version:
``bus_span_candidates``) lists the voices that may sound in each span of
tiles, and the render kernel's bus specialisation walks a tile's span list
once, buckets the voices it admits by bus and renders bus after bus (plain
version of the order: ``bus_tile_lists``).  There is no fallback between
the two: a CUDA tensor launches the kernels or raises.

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
from typing import NamedTuple, Optional

import numpy as np
import torch

from ..models.voicebank import (_I32_MAX, _U32, BANK_TABLE_LEN, I32_FIELDS,
                                U32_FIELDS, BankLayout, VoiceParams, _noise,
                                _noise_u32, _phase_x, _seg_idx, _tri_u32,
                                _wrap_i32, render_block)
from .trig import cos_turns, log_f32, sin_turns

_SRC = Path(__file__).resolve().parent.parent / "csrc" / "voicebank_render.cu"
#: build products go under the checkout's ``build/`` (listed in .gitignore)
BUILD_DIR = Path(__file__).resolve().parents[2] / "build"
#: -fmad=false keeps every f32 multiply and add separately rounded, as the
#: plain version computes them (no --use_fast_math: pluck needs accurate
#: cosf/logf/expf and denormals must not flush)
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-fmad=false", "-shared", "-Xcompiler", "-fPIC",
              "-Xptxas", "-v")

#: the VoiceParams columns the setup kernel reads through a table of device
#: pointers; the order matches ``enum Col`` in the source
KERNEL_COLUMNS = ("wave", "base_inc", "phase0", "amp", "bias", "pan", "start",
                  "gate", "attack", "decay", "sustain_level", "release",
                  "fm_inc", "fm_phase0", "fm_depth", "fm_r", "fm_c0",
                  "pulse_width", "seed", "noise_hold", "damping",
                  "glide_inc0", "glide_d", "glide_frames")
#: the curve segment arrays both kernels read through a second pointer
#: table, [V, S], [V, KA] and [V, KD]; the order matches ``struct Curves``
CURVE_COLUMNS = ("bend_start", "bend_phase", "bend_inc", "bend_d",
                 "acurve_start", "acurve_g0", "acurve_dg",
                 "dcurve_start", "dcurve_c", "dcurve_a", "dcurve_b")
#: words of a voice's row of the [V, C] constants, before the pluck
#: partials; the order matches ``enum Const`` in the source.  Words from
#: ``amp`` on are f32 bit patterns, the rest u32 (or i32) values.
CONST_COLUMNS = ("wave", "inc", "phase0", "start", "fm_inc", "fm_phase0",
                 "seed", "noise_hold", "glide_inc0", "glide_d",
                 "glide_frames", "phase_g", "inc_g", "pulse_wu", "flags",
                 "pluck_ka", "amp", "bias", "lg", "rg", "a", "t2", "t3", "t4",
                 "sl", "a_r", "d_r", "r_r", "fm_c0", "fm_r", "fm_scale")
CONST_BASE = len(CONST_COLUMNS)
#: bits of the ``flags`` word: cull-safe, cull-safe as a pluck voice, FM
#: on, a pitch / amplitude / FM-depth curve, and each curve row's starts
#: non-decreasing (searched, not counted)
FLAG_SAFE, FLAG_PLUCK_SAFE, FLAG_FM_ON = 1, 2, 4
FLAG_BEND, FLAG_AMP, FLAG_DC = 8, 16, 32
FLAG_BEND_SORTED, FLAG_AMP_SORTED, FLAG_DC_SORTED = 64, 128, 256
#: bits of the render's ``modes`` argument (the bank's static flags)
MODE_GLIDE, MODE_BEND, MODE_AMP, MODE_DMOD = 1, 2, 4, 8
#: a voice is cull-safe only if every value that scales its waveform lies
#: within +-2^32, so (bias + amp*w) stays finite and times 0 is +-0
CULL_MAX = 2.0 ** 32
#: frames per render block: the unit in which silent voices are skipped
TILE = 512
#: segments of one curve that a tile's window in shared memory holds; a
#: (voice, tile, curve) that spans more is searched in global memory
WINDOW = 4
#: int32 counters a render leaves behind its constants: voice-tiles
#: evaluated and, from the curve kernel, curve windows looked up (one per
#: evaluated voice-tile and curve the voice carries) and those that search
#: the whole row per frame
COUNTS = 3
#: the curves in the order of the per-segment buffer, and the words of one
#: segment's entry (``CurveSegments``)
CURVES = ("bend", "amp", "depth")
SEGMENT_WORDS = (4, 4, 8)
#: the bus render's span lists: tiles a span (at least SPAN_TILES, doubled
#: while the lists would hold more than SPAN_ENTRIES entries), and the
#: fields of an entry's key word (bus id in the low 16 bits, the wave code
#: & 0x1ff from KEY_CODE_SHIFT, KEY_UNSAFE for a voice that is not
#: cull-safe); an entry is (voice, key, start, t4's f32 bits)
SPAN_TILES = 32
SPAN_ENTRIES = 1 << 22
KEY_CODE_SHIFT = 16
KEY_UNSAFE = 1 << 25
MAX_GROUPS = 16
_REFERENCE_BLOCK = 131072
_EPS = float(np.float32(1e-30))
_TWO_NEG32 = float(np.float32(2.0 ** -32))


def const_width(num_harmonics: int) -> int:
    """Words of one voice's constants: the base words plus 3 for each pluck
    partial (u/denom, phase offset, decay rate)."""
    return CONST_BASE + 3 * max(1, num_harmonics)


def build_library() -> tuple:
    """Compile ``csrc/voicebank_render.cu`` (once per source hash) ->
    (path of the shared library, compiler log: kept beside the library, so
    a later call finds ptxas' resource lines too)."""
    key = hashlib.sha256(_SRC.read_bytes()
                         + " ".join(NVCC_FLAGS).encode()).hexdigest()[:16]
    lib = BUILD_DIR / f"voicebank_render_{key}.so"
    log = lib.with_suffix(".log")
    if lib.exists():
        return lib, log.read_text() if log.exists() else ""
    nvcc = shutil.which("nvcc") or "/usr/local/cuda/bin/nvcc"
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = lib.with_name(f"{lib.name}.{os.getpid()}.tmp")
    res = subprocess.run([nvcc, *NVCC_FLAGS, "-o", str(tmp), str(_SRC)],
                         capture_output=True, text=True)
    if res.returncode != 0:
        raise RuntimeError(f"nvcc failed ({res.returncode}):\n{res.stderr}")
    log.write_text(res.stdout + res.stderr)
    os.replace(tmp, lib)
    return lib, res.stdout + res.stderr


@functools.lru_cache(maxsize=None)
def _library() -> ctypes.CDLL:
    lib = ctypes.CDLL(str(build_library()[0]))
    info = [ctypes.c_int() for _ in range(4)]
    lib.voicebank_info(*(ctypes.byref(x) for x in info))
    got = tuple(x.value for x in info)
    if got != (CONST_BASE, TILE, WINDOW, COUNTS):
        raise RuntimeError(f"{_SRC.name} has (constant words, tile frames, "
                           f"window segments, counters) = {got}, the wrapper "
                           f"expects {(CONST_BASE, TILE, WINDOW, COUNTS)}")
    lib.voicebank_setup.argtypes = [
        ctypes.POINTER(ctypes.c_void_p),                # column pointers (host)
        ctypes.POINTER(ctypes.c_void_p),                # curve pointers (host)
        ctypes.POINTER(ctypes.c_int),                   # S, KA, KD (host)
        ctypes.c_void_p, ctypes.c_int,                  # harm_amps, row stride
        ctypes.c_void_p,                                # table [V, 256]
        ctypes.c_int, ctypes.c_int,                     # V, num_harmonics
        ctypes.c_float,                                 # f32(1/samplerate)
        ctypes.c_void_p, ctypes.c_int,                  # consts [V, C], C
        ctypes.c_void_p,                                # per-segment buffer
        ctypes.c_void_p,                                # counters [COUNTS]
        ctypes.c_void_p]                                # cudaStream_t
    lib.voicebank_render.argtypes = [
        ctypes.c_void_p, ctypes.c_int,                  # consts [V, C], C
        ctypes.c_void_p, ctypes.c_int,                  # harm_amps, row stride
        ctypes.c_void_p,                                # table [V, 256]
        ctypes.POINTER(ctypes.c_int32), ctypes.c_int,   # groups (host) [G, 4]
        ctypes.POINTER(ctypes.c_void_p),                # curve pointers (host)
        ctypes.POINTER(ctypes.c_int),                   # S, KA, KD (host)
        ctypes.c_void_p,                                # per-segment buffer
        ctypes.c_int,                                   # num_harmonics
        ctypes.c_int, ctypes.c_int,                     # n0, nframes
        ctypes.c_float,                                 # f32(1/samplerate)
        ctypes.c_int,                                   # modes
        ctypes.c_void_p, ctypes.c_int, ctypes.c_int,    # idx, K, chunk_frames
        ctypes.c_int,                                   # V
        ctypes.c_void_p, ctypes.c_int,                  # bus [V] int32, nseg
        ctypes.c_int, ctypes.c_void_p,                  # span tiles, lists
        ctypes.c_void_p,                                # out [nframes, (nseg,) 2]
        ctypes.c_void_p,                                # counters [COUNTS]
        ctypes.c_void_p]                                # cudaStream_t
    lib.voicebank_setup.restype = lib.voicebank_render.restype = ctypes.c_int
    return lib


def _column_pointers(vp: VoiceParams, names=KERNEL_COLUMNS):
    """Host array of device pointers to vp's ``names`` columns (enum Col
    order, or ``CURVE_COLUMNS`` for struct Curves)."""
    return (ctypes.c_void_p * len(names))(
        *(getattr(vp, name).data_ptr() for name in names))


def _curve_dims(vp: VoiceParams):
    """Host array (S, KA, KD): the widths of the curve segment arrays."""
    return (ctypes.c_int * 3)(vp.bend_start.shape[1], vp.acurve_start.shape[1],
                              vp.dcurve_start.shape[1])


def _dtype(name: str) -> torch.dtype:
    return (torch.int64 if name in U32_FIELDS
            else torch.int32 if name in I32_FIELDS else torch.float32)


#: (field, dtype, which dim sets its width) of every tensor the kernels
#: read through raw pointers: 0 = a [V] column, else the field whose
#: second dim it shares
_READ = tuple((name, _dtype(name), 0) for name in KERNEL_COLUMNS) + (
    ("harm_amps", torch.float32, "harm_amps"),
    ("table", torch.float32, "table"),
    *((name, _dtype(name), "bend_start") for name in CURVE_COLUMNS[:4]),
    *((name, _dtype(name), "acurve_start") for name in CURVE_COLUMNS[4:7]),
    *((name, _dtype(name), "dcurve_start") for name in CURVE_COLUMNS[7:]))


def _check_params(vp: VoiceParams, num_harmonics: int):
    """What the setup kernel reads through raw pointers."""
    dev = vp.wave.device
    V = vp.wave.shape[0]
    shapes = {0: (V,)}
    for name in ("harm_amps", "table", "bend_start", "acurve_start",
                 "dcurve_start"):
        shapes[name] = (V, getattr(vp, name).shape[-1])
    for name, want, width in _READ:
        f = getattr(vp, name)
        shape = shapes[width]
        if (f.dtype is not want or f.device != dev or f.shape != shape
                or shape[-1] < 1 or not f.is_contiguous()):
            raise ValueError(f"{name}: expected contiguous {want} {list(shape)} "
                             f"on {dev}, got {f.dtype} {list(f.shape)} on "
                             f"{f.device}")
    if (vp.harm_amps.shape[1] < num_harmonics
            or vp.table.shape[1] != BANK_TABLE_LEN):
        raise ValueError(f"harm_amps needs >= {num_harmonics} columns "
                         f"and table {BANK_TABLE_LEN}, got "
                         f"{vp.harm_amps.shape[1]} and {vp.table.shape[1]}")
    if V == 0:
        raise ValueError("the kernels take at least one voice")


def _check_inputs(vp: VoiceParams, n0: int, nframes: int,
                  layout: BankLayout, idx=None, chunk_frames: int = 0,
                  seg=None, nseg: int = 0):
    """What both kernels of ``render_stereo`` read."""
    _check_params(vp, layout.num_harmonics)
    V = vp.wave.shape[0]
    if seg is not None:
        if (seg.device != vp.device or seg.dtype != torch.int32
                or seg.shape != (V,) or not seg.is_contiguous()
                or not 1 <= nseg <= 65535):
            raise ValueError(f"seg: expected contiguous int32 [{V}] on "
                             f"{vp.device} and 1 <= nseg <= 65535, got "
                             f"{seg.dtype} {tuple(seg.shape)} on {seg.device}, "
                             f"nseg={nseg}")
        if idx is not None:
            raise ValueError("segment buses take no sparse rows")
    elif nseg:
        raise ValueError("nseg without seg")
    if not 0 < len(layout.groups) <= MAX_GROUPS:
        raise ValueError(f"the kernel takes 1..{MAX_GROUPS} groups, got "
                         f"{len(layout.groups)}")
    for (wid, _, start, count) in layout.groups:
        if not -1 <= wid <= 12 or start < 0 or count < 0 or start + count > V:
            raise ValueError(f"bad group {(wid, start, count)} for {V} voices")
    if n0 < 0 or nframes <= 0 or n0 + nframes > 2 ** 31 - 1:
        raise ValueError(f"frames [{n0}, {n0 + nframes}) outside the "
                         f"kernel's i32 frame range")
    if idx is None:
        return
    if len(layout.groups) != 1:
        raise ValueError("sparse rows take a one-group layout")
    if chunk_frames <= 0 or chunk_frames % TILE or n0 % chunk_frames:
        raise ValueError(f"sparse rows need chunk_frames a multiple of "
                         f"{TILE} and n0 one of chunk_frames, got "
                         f"chunk_frames={chunk_frames}, n0={n0}")
    if (idx.device != vp.device or idx.dtype != torch.int32 or idx.dim() != 2
            or idx.shape[1] < 1 or not idx.is_contiguous()
            or (n0 + nframes - 1) // chunk_frames >= idx.shape[0]):
        raise ValueError(f"idx: expected contiguous int32 [nchunks, K] on "
                         f"{vp.device} covering frames [{n0}, "
                         f"{n0 + nframes}) in chunks of {chunk_frames}, got "
                         f"{idx.dtype} {tuple(idx.shape)} on {idx.device}")


def _sr_r(samplerate: int) -> float:
    return float(np.float32(1.0 / samplerate))


def _launch(rc: int, name: str):
    if rc != 0:
        raise RuntimeError(f"{name} launch failed: CUDA error {rc}")


class VoiceSetup(NamedTuple):
    """What the setup kernel writes: the constants [V, C] int32, the
    render's counters int32 [COUNTS] (set to 0), and the flat per-segment
    buffer of the curves (``segment_views``), or None without curves."""
    consts: torch.Tensor
    counts: torch.Tensor
    seg: Optional[torch.Tensor]


def voice_setup(vp: VoiceParams, samplerate: int, num_harmonics: int,
                segments: bool = False) -> VoiceSetup:
    """Launch the setup kernel on CUDA tensors, with its per-segment pass
    if ``segments``.  Counted in ``voice_setup.launches``.  Plain versions:
    ``voice_constants`` and ``curve_constants``."""
    if vp.device.type != "cuda":
        raise ValueError(f"voice_setup takes CUDA tensors, got {vp.device}")
    _check_params(vp, num_harmonics)
    return _setup(vp, samplerate, num_harmonics, segments)


def _setup(vp: VoiceParams, samplerate: int, num_harmonics: int,
           segments: bool, curves=None) -> VoiceSetup:
    """voice_setup without the checks, for render_stereo (which has made
    them and passes its curve pointer table and widths)."""
    V = vp.wave.shape[0]
    C = const_width(num_harmonics)
    if curves is None:
        curves = _column_pointers(vp, CURVE_COLUMNS), _curve_dims(vp)
    buf = torch.empty(V * C + COUNTS, dtype=torch.int32, device=vp.device)
    consts, counts = buf[:V * C].view(V, C), buf[V * C:]
    seg = None
    if segments:
        words = sum(k * w for k, w in zip(curves[1], SEGMENT_WORDS))
        seg = torch.empty(V * words, dtype=torch.int32, device=vp.device)
    with torch.cuda.device(vp.device):
        stream = torch.cuda.current_stream().cuda_stream
        _launch(_library().voicebank_setup(
            _column_pointers(vp), *curves, vp.harm_amps.data_ptr(),
            vp.harm_amps.shape[1], vp.table.data_ptr(), V, num_harmonics,
            _sr_r(samplerate), consts.data_ptr(), C,
            0 if seg is None else seg.data_ptr(), counts.data_ptr(),
            stream), "voicebank_setup")
    voice_setup.launches += 1
    return VoiceSetup(consts, counts, seg)


voice_setup.launches = 0


def _modes(use_glide, use_bend, use_amp, use_dmod) -> int:
    return ((MODE_GLIDE if use_glide else 0) | (MODE_BEND if use_bend else 0)
            | (MODE_AMP if use_amp else 0) | (MODE_DMOD if use_dmod else 0))


def render_stereo(vp: VoiceParams, n0: int, *, nframes: int,
                  samplerate: int, layout: BankLayout,
                  use_glide: bool = False, use_bend: bool = False,
                  use_amp: bool = False, use_dmod: bool = False,
                  idx=None, chunk_frames: int = 0, seg=None,
                  nseg: int = 0) -> torch.Tensor:
    """Render [nframes, 2] f32 starting at absolute frame n0.

    ``seg`` (int32 [V] on vp's device, with ``nseg``): segment buses ->
    [nframes, nseg, 2], bus b the sum of the voices whose id is b, in
    packed order.  On CUDA the span pass and then the render kernel's bus
    mode: the render is counted in ``render_stereo.launches`` and, besides,
    in ``render_stereo.bus_launches``, the span pass in
    ``render_stereo.span_launches``; ``render_stereo.spans`` is then its
    lists (``bus_span_candidates``' layout).

    ``idx`` (int32 [nchunks, K], with ``chunk_frames``): sparse rows, as
    ``VoiceBank.sparse_plan`` makes them.  The frames of absolute chunk c
    (frames [c*chunk_frames, (c+1)*chunk_frames)) sum only the voices of
    row c, in row order; a slot outside [0, V) is empty.  Needs a
    one-group layout, and on CUDA chunk_frames a multiple of ``TILE`` and
    n0 a multiple of chunk_frames.

    CUDA tensors: one launch of the setup kernel and one of the render
    kernel, counted in ``voice_setup.launches`` and
    ``render_stereo.launches``; ``render_stereo.voice_tiles`` is then the
    device int32 [1] count of voice-tiles the render evaluated and
    ``render_stereo.windows`` the int32 [2] counts of curve windows it
    looked up and of those that searched the whole row per frame
    (``tile_segment_windows``).  CPU tensors: the plain version."""
    flags = dict(use_glide=use_glide, use_bend=use_bend, use_amp=use_amp,
                 use_dmod=use_dmod, idx=idx, chunk_frames=chunk_frames,
                 seg=seg, nseg=nseg)
    if vp.device.type == "cpu":
        return render_stereo_reference(vp, n0, nframes=nframes,
                                       samplerate=samplerate, layout=layout,
                                       **flags)
    if vp.device.type != "cuda":
        raise ValueError(f"render_stereo takes CPU or CUDA tensors, got "
                         f"{vp.device}")
    n0 = int(n0)
    _check_inputs(vp, n0, nframes, layout, idx, chunk_frames, seg, nseg)
    H = layout.num_harmonics
    V = vp.wave.shape[0]
    curves = _column_pointers(vp, CURVE_COLUMNS), _curve_dims(vp)
    modes = _modes(use_glide, use_bend, use_amp, use_dmod)
    consts, counts, segbuf = _setup(
        vp, samplerate, H, bool(modes & (MODE_BEND | MODE_AMP | MODE_DMOD)),
        curves)
    groups = [int(x) for g in layout.groups for x in g]
    out = torch.empty((nframes, 2) if seg is None else (nframes, nseg, 2),
                      dtype=torch.float32, device=vp.device)
    span, spans = 0, None
    if seg is not None:
        nslots = sum(g[3] for g in layout.groups)
        span = span_tiles(nframes, nslots)
        nspans = -(-nframes // (span * TILE))
        spans = torch.empty(nspans * (4 * nslots + 1), dtype=torch.int32,
                            device=vp.device)
    with torch.cuda.device(vp.device):
        stream = torch.cuda.current_stream().cuda_stream
        _launch(_library().voicebank_render(
            consts.data_ptr(), consts.shape[1], vp.harm_amps.data_ptr(),
            vp.harm_amps.shape[1], vp.table.data_ptr(),
            (ctypes.c_int32 * len(groups))(*groups), len(layout.groups),
            *curves, 0 if segbuf is None else segbuf.data_ptr(), H, n0,
            nframes,
            _sr_r(samplerate), modes, 0 if idx is None else idx.data_ptr(),
            0 if idx is None else idx.shape[1], int(chunk_frames), V,
            0 if seg is None else seg.data_ptr(), 1 if seg is None else nseg,
            span, 0 if spans is None else spans.data_ptr(),
            out.data_ptr(), counts.data_ptr(), stream), "voicebank_render")
    render_stereo.launches += 1
    render_stereo.spans = None
    if seg is not None:
        render_stereo.bus_launches += 1
        render_stereo.span_launches += 1
        render_stereo.spans = (spans[:nspans * nslots * 4].view(
            nspans, nslots, 4), spans[nspans * nslots * 4:])
    render_stereo.voice_tiles = counts[:1]
    render_stereo.windows = counts[1:3]
    return out


render_stereo.launches = 0
render_stereo.bus_launches = 0
render_stereo.span_launches = 0
render_stereo.spans = None
render_stereo.voice_tiles = None
render_stereo.windows = None


def render_stereo_reference(vp: VoiceParams, n0: int, *, nframes: int,
                            samplerate: int, layout: BankLayout,
                            use_glide: bool = False, use_bend: bool = False,
                            use_amp: bool = False, use_dmod: bool = False,
                            idx=None, chunk_frames: int = 0, seg=None,
                            nseg: int = 0) -> torch.Tensor:
    """The kernel's plain version: ``render_block`` over the same layout,
    on vp's device, in blocks of at most 131072 frames to bound memory
    (block size does not change the result).  With ``idx`` each chunk
    renders the voices of its row (empty slots dropped) as one group of
    the layout's wave and FM flag; with ``seg`` each voice adds to its own
    bus, and a voice whose id is outside [0, nseg) to none, as in the
    kernel."""
    flags = dict(use_glide=use_glide, use_bend=use_bend, use_amp=use_amp,
                 use_dmod=use_dmod)
    H = layout.num_harmonics

    def blocks(sub, sub_layout, a, b, **kw):
        return [render_block(sub, b0, min(_REFERENCE_BLOCK, b - b0), samplerate,
                             H, sub_layout, **flags, **kw)
                for b0 in range(a, b, _REFERENCE_BLOCK)]

    if seg is not None:
        if idx is not None:
            raise ValueError("segment buses take no sparse rows")
        ids = seg.tolist() if isinstance(seg, torch.Tensor) else list(seg)
        keep = [i for i, b in enumerate(ids) if 0 <= int(b) < nseg]
        sub, sub_layout = solo_params(vp, layout, keep)
        return torch.cat(blocks(sub, sub_layout, n0, n0 + nframes,
                                seg=[int(ids[i]) for i in keep], nseg=nseg))
    if idx is None:
        return torch.cat(blocks(vp, layout, n0, n0 + nframes))
    if len(layout.groups) != 1 or chunk_frames <= 0:
        raise ValueError("sparse rows take a one-group layout and "
                         "chunk_frames > 0")
    (wid, has_fm, _, _), = layout.groups
    V = vp.wave.shape[0]
    out = []
    end = n0 + nframes
    for c in range(n0 // chunk_frames, -(-end // chunk_frames)):
        a = max(n0, c * chunk_frames)
        b = min(end, (c + 1) * chunk_frames)
        rows = idx[c].to(torch.int64)
        rows = rows[(rows >= 0) & (rows < V)]
        if rows.numel() == 0:
            out.append(torch.zeros((b - a, 2), dtype=torch.float32,
                                   device=vp.device))
            continue
        sub = VoiceParams(*(f.index_select(0, rows) for f in vp))
        sub_layout = BankLayout(((wid, has_fm, 0, rows.numel()),),
                                rows.numel(), H)
        out.extend(blocks(sub, sub_layout, a, b))
    return torch.cat(out)


def solo_params(vp: VoiceParams, layout: BankLayout, voices):
    """The voices ``voices`` (packed indices, ascending) of a bank as a bank
    of their own -> (VoiceParams, BankLayout): each group keeps its wave
    and FM flag and holds its chosen voices in packed order.  Rendered
    flat, it sums what a segment bus of those voices sums, in the same
    order: the bus's solo render."""
    keep = sorted(int(v) for v in voices)
    rows = torch.tensor(keep, dtype=torch.int64, device=vp.device)
    sub = VoiceParams(*(f.index_select(0, rows) for f in vp))
    groups, pos = [], 0
    for (wid, has_fm, start, count) in layout.groups:
        k = sum(1 for v in keep if start <= v < start + count)
        groups.append((wid, has_fm, pos, k))
        pos += k
    return sub, BankLayout(tuple(groups), len(keep), layout.num_harmonics)


def _u32_bits(x: torch.Tensor) -> torch.Tensor:
    """u32 values held in int64 -> their int32 bit patterns."""
    return torch.where(x >= 2 ** 31, x - 2 ** 32, x).to(torch.int32)


def _f32_bits(x: torch.Tensor) -> torch.Tensor:
    return x.contiguous().view(torch.int32)


def voice_constants(vp: VoiceParams, samplerate: int,
                    num_harmonics: int) -> torch.Tensor:
    """The setup kernel's plain version -> [V, C] int32, C =
    ``const_width(num_harmonics)``: the words of ``CONST_COLUMNS`` and then
    (u/denom, phi, alpha) per pluck partial, zero for partials that do not
    sound.  Every f32 value is the same expression in the same order as
    the per-frame code of ``render_block``; max and min follow CUDA's
    fmaxf/fminf (a NaN operand yields the other one)."""
    dev = vp.device
    f32 = torch.float32
    zero = torch.zeros((), dtype=f32, device=dev)
    one = torch.ones((), dtype=f32, device=dev)
    eps = torch.full((), _EPS, dtype=f32, device=dev)
    sr_r = _sr_r(samplerate)
    inc = vp.base_inc
    V = inc.shape[0]
    H = num_harmonics
    K = max(1, H)

    G = vp.glide_frames.to(torch.int64) & _U32
    phase_g = (vp.glide_inc0 * G + vp.glide_d * _tri_u32(G)) & _U32
    inc_g = (vp.glide_inc0 + vp.glide_d * G) & _U32
    wu = vp.pulse_width * 4294967296.0              # __float2uint_rz
    wu = torch.where(torch.isnan(wu), zero, wu.clamp(0.0, 4294967296.0))
    wu = wu.to(torch.int64).clamp_max(_U32)

    a = torch.fmax(vp.attack, zero)
    d = torch.fmax(vp.decay, zero)
    r = torch.fmax(vp.release, zero)
    gate = vp.gate.to(f32) * sr_r
    s = torch.fmax(gate - a - d, zero)
    t2 = a + d
    t3 = t2 + s
    t4 = t3 + r

    # pluck (the twin of render_block's _pluck)
    ratio = inc.to(f32) * _TWO_NEG32
    ks = torch.arange(1, K + 1, dtype=torch.int64, device=dev)[None, :]
    u = _noise(ks.expand(V, K), vp.seed)
    lim = torch.tensor([(2 ** 31 - 1) // k for k in range(1, K + 1)],
                       dtype=torch.int64, device=dev)[None, :]
    active = (inc[:, None] <= lim) & (inc[:, None] > 0)
    denom = torch.zeros_like(ratio)
    for j in range(K):
        denom = denom + torch.where(active[:, j], u[:, j].abs(), zero)
    denom = torch.fmax(denom, eps)
    phi = _noise_u32((ks + K).expand(V, K), vp.seed)
    g = cos_turns(ks.to(f32) * ratio[:, None] * 0.5)
    alpha = (vp.damping[:, None] * ratio[:, None]
             * log_f32(torch.fmax(g, eps)))
    izero = torch.zeros((), dtype=torch.int32, device=dev)
    partials = torch.stack([
        torch.where(active, _f32_bits(u / denom[:, None]), izero),
        torch.where(active, _u32_bits(phi), izero),
        torch.where(active, _f32_bits(alpha), izero)], dim=2)

    def within(x):
        return x.abs() <= CULL_MAX                  # False for NaN and inf

    def row_sorted(st):
        return (st[:, 1:] >= st[:, :-1]).all(dim=1)

    # an amplitude curve keeps its voice cull-safe only if every gain its
    # segments reach -- each ramp's ends g0 and g0 + f32(L) * dg, L the
    # distance to the next start (to INT32_MAX for the last) -- is within
    # +-2^32, and its starts are sorted
    ast = vp.acurve_start.to(torch.int64)
    nxt = torch.cat([ast[:, 1:], torch.full_like(ast[:, :1], _I32_MAX)], 1)
    g1 = vp.acurve_g0 + (nxt - ast).to(f32) * vp.acurve_dg
    has_amp = vp.acurve_start[:, 0] == 0
    amp_ok = (row_sorted(vp.acurve_start) & within(vp.acurve_g0).all(dim=1)
              & within(g1).all(dim=1))
    safe = (within(vp.amp) & within(vp.bias) & within(vp.pan)
            & within(vp.harm_amps[:, :H]).all(dim=1)
            & within(vp.table).all(dim=1) & (~has_amp | amp_ok))
    pluck_safe = (vp.damping >= 0.0) & (vp.damping <= CULL_MAX)
    fm_on = (vp.fm_depth != 0.0) & (vp.fm_inc != 0)
    bits = (
        (safe, FLAG_SAFE), (pluck_safe, FLAG_PLUCK_SAFE), (fm_on, FLAG_FM_ON),
        (vp.bend_start[:, 0] == 0, FLAG_BEND), (has_amp, FLAG_AMP),
        ((vp.dcurve_start[:, 0] == 0) & (vp.fm_inc != 0), FLAG_DC),
        (row_sorted(vp.bend_start), FLAG_BEND_SORTED),
        (row_sorted(vp.acurve_start), FLAG_AMP_SORTED),
        (row_sorted(vp.dcurve_start), FLAG_DC_SORTED))
    flags = sum(b.to(torch.int32) * bit for b, bit in bits)

    words = dict(
        wave=vp.wave, inc=_u32_bits(inc), phase0=_u32_bits(vp.phase0),
        start=vp.start, fm_inc=_u32_bits(vp.fm_inc),
        fm_phase0=_u32_bits(vp.fm_phase0), seed=_u32_bits(vp.seed),
        noise_hold=vp.noise_hold, glide_inc0=_u32_bits(vp.glide_inc0),
        glide_d=_u32_bits(vp.glide_d), glide_frames=vp.glide_frames,
        phase_g=_u32_bits(phase_g), inc_g=_u32_bits(inc_g),
        pulse_wu=_u32_bits(wu), flags=flags,
        pluck_ka=active.sum(dim=1).to(torch.int32),
        amp=_f32_bits(vp.amp), bias=_f32_bits(vp.bias),
        lg=_f32_bits(torch.fmin(1.0 - vp.pan, one)),
        rg=_f32_bits(torch.fmin(1.0 + vp.pan, one)),
        a=_f32_bits(a), t2=_f32_bits(t2), t3=_f32_bits(t3), t4=_f32_bits(t4),
        sl=_f32_bits(vp.sustain_level),
        a_r=_f32_bits(1.0 / torch.fmax(a, eps)),
        d_r=_f32_bits(1.0 / torch.fmax(d, eps)),
        r_r=_f32_bits(1.0 / torch.fmax(r, eps)),
        fm_c0=_f32_bits(vp.fm_c0), fm_r=_f32_bits(vp.fm_r),
        fm_scale=_f32_bits(inc.to(f32) * vp.fm_depth))
    base = torch.stack([words[name] for name in CONST_COLUMNS], dim=1)
    return torch.cat([base, partials.reshape(V, 3 * K)], dim=1).contiguous()


def _tile_ends(start: torch.Tensor, n0: int, nframes: int, tile: int):
    """-> (i0 [ntiles], m_first, m_last [V, ntiles]): each tile's first
    window-relative frame, and the note-relative frames int32(n - start) of
    its first and last frame, wrapped as the kernel's u32 subtraction."""
    ntiles = -(-nframes // tile)
    i0 = torch.arange(ntiles, dtype=torch.int64, device=start.device) * tile
    ilast = torch.clamp_max(i0 + tile, nframes) - 1
    start = start.to(torch.int64)[:, None]
    return (i0, _wrap_i32((n0 + i0)[None, :] - start),
            _wrap_i32((n0 + ilast)[None, :] - start))


def active_voice_tiles(vp: VoiceParams, n0: int, nframes: int, *,
                       samplerate: int, layout: BankLayout,
                       tile: int = TILE, idx=None,
                       chunk_frames: int = 0) -> torch.Tensor:
    """The render kernel's culling test as plain PyTorch -> bool [V, ntiles]:
    True where the kernel evaluates voice v on tile j (frames
    [n0 + j*tile, n0 + min((j+1)*tile, nframes))).  A voice that no group
    walks is never evaluated; a voice is tested with the waveform of the
    group that holds it (per-voice in a mixed group).  With sparse rows
    (``idx``, ``chunk_frames``) a voice is a candidate only on the tiles of
    the chunks whose row lists it.  Same f32 operations as the kernel's
    test, so its sum is the kernel's voice-tile count for a layout whose
    groups do not overlap and rows that list a voice at most once."""
    dev = vp.device
    V = vp.wave.shape[0]
    c = voice_constants(vp, samplerate, layout.num_harmonics)
    col = {name: c[:, j] for j, name in enumerate(CONST_COLUMNS)}
    i0, m_first, m_last = _tile_ends(col["start"], n0, nframes, tile)
    ntiles = i0.shape[0]
    sr_r = _sr_r(samplerate)
    t4 = col["t4"].view(torch.float32)[:, None]
    flags = col["flags"][:, None]
    wid = torch.full((V,), -2, dtype=torch.int32, device=dev)
    for (gw, _, start, count) in layout.groups:
        wid[start:start + count] = vp.wave[start:start + count] if gw < 0 else gw
    safe = ((flags & FLAG_SAFE) != 0) & (
        (wid[:, None] != 12) | ((flags & FLAG_PLUCK_SAFE) != 0))
    silent = safe & (m_first <= m_last) & (
        (m_last.to(torch.float32) * sr_r < 0.0)
        | (m_first.to(torch.float32) * sr_r >= t4))
    walked = (wid != -2)[:, None].expand(V, ntiles)
    if idx is not None:
        rows = idx.to(torch.int64)[(n0 + i0) // chunk_frames]  # [ntiles, K]
        ok = (rows >= 0) & (rows < V)
        cand = torch.zeros((V, ntiles), dtype=torch.bool, device=dev)
        tiles = torch.arange(ntiles, device=dev)[:, None].expand_as(rows)
        cand[rows[ok], tiles[ok]] = True
        walked = walked & cand
    return ~silent & walked


def span_tiles(nframes: int, nslots: int) -> int:
    """Tiles in a span of the bus render's candidate lists for a window of
    nframes and a layout of nslots voices: SPAN_TILES, doubled while the
    lists ([spans, nslots] entries) would exceed SPAN_ENTRIES."""
    tiles = -(-nframes // TILE)
    span = SPAN_TILES
    while span < tiles and -(-tiles // span) * nslots > SPAN_ENTRIES:
        span *= 2
    return span


def _bus_slots(vp: VoiceParams, samplerate: int, layout: BankLayout, seg,
               nseg: int):
    """The layout's slots in walk order with what the span pass reads ->
    (entries int64 [nslots, 4]: voice, key, start, t4's bits; safe, on a
    bus in [0, nseg), start, t4 [nslots])."""
    c = voice_constants(vp, samplerate, layout.num_harmonics)
    col = {name: c[:, j].to(torch.int64) for j, name in
           enumerate(CONST_COLUMNS)}
    dev = vp.device
    voice, wid, code = [], [], []
    for (gw, fm, start, count) in layout.groups:
        v = torch.arange(start, start + count, dtype=torch.int64, device=dev)
        w = vp.wave.to(torch.int64)[v] if gw < 0 else torch.full_like(v, gw)
        voice.append(v)
        wid.append(w)
        code.append(w | (0x100 if fm else 0))
    voice, wid, code = torch.cat(voice), torch.cat(wid), torch.cat(code)
    flags = col["flags"][voice]
    safe = ((flags & FLAG_SAFE) != 0) & ((wid != 12)
                                         | ((flags & FLAG_PLUCK_SAFE) != 0))
    bus = torch.as_tensor(seg, device=dev).to(torch.int64)[voice]
    on_bus = (bus >= 0) & (bus < nseg)
    key = (bus & 0xffff) | ((code & 0x1ff) << KEY_CODE_SHIFT) | torch.where(
        safe, 0, KEY_UNSAFE)
    start, t4 = col["start"][voice], col["t4"][voice]
    entries = torch.stack([voice, key, start, t4], dim=1)
    return entries, safe, on_bus, start, t4.to(torch.int32).view(torch.float32)


def _silent_on(safe, start, t4, n0: int, nframes: int, frames: int,
               sr_r: float):
    """The kernels' exact test over windows of ``frames`` frames -> bool
    [nslots, nwindows]: True where a voice is silent on the window."""
    _, m_first, m_last = _tile_ends(start, n0, nframes, frames)
    return safe[:, None] & (m_first <= m_last) & (
        (m_last.to(torch.float32) * sr_r < 0.0)
        | (m_first.to(torch.float32) * sr_r >= t4[:, None]))


def bus_span_candidates(vp: VoiceParams, n0: int, nframes: int, *,
                        samplerate: int, layout: BankLayout, seg, nseg: int,
                        span: Optional[int] = None):
    """The bus render's span pass (``span_kernel``) as plain PyTorch ->
    (entries int32 [spans, nslots, 4], counts int32 [spans]).  Span s
    covers window frames [s * span * TILE, (s+1) * span * TILE) (``span``
    tiles, by default ``span_tiles``); its first counts[s] entries are the
    layout's slots, in walk (packed) order, that may sound on the span on
    a bus in [0, nseg) -- every voice that is not cull-safe, and a
    cull-safe one unless the exact tile test over the span's first and
    last frame finds it silent -- as (voice, key, start, t4's bits); the
    rest is zero."""
    nslots = sum(g[3] for g in layout.groups)
    span = span or span_tiles(nframes, nslots)
    entries, safe, on_bus, start, t4 = _bus_slots(vp, samplerate, layout,
                                                  seg, nseg)
    keep = on_bus[:, None] & ~_silent_on(safe, start, t4, n0, nframes,
                                         span * TILE, _sr_r(samplerate))
    nspans = keep.shape[1]
    out = torch.zeros((nspans, nslots, 4), dtype=torch.int32,
                      device=vp.device)
    counts = keep.sum(dim=0).to(torch.int32)
    for s in range(nspans):
        rows = entries[keep[:, s]]
        out[s, :rows.shape[0]] = rows.to(torch.int32)
    return out, counts


def bus_tile_lists(vp: VoiceParams, n0: int, nframes: int, *,
                   samplerate: int, layout: BankLayout, seg, nseg: int,
                   span: Optional[int] = None) -> list:
    """What the bus render kernel evaluates on each tile, in its order, as
    plain PyTorch -> one int64 [k, 3] tensor a tile of (voice, bus, wave
    code): the entries of the tile's span list (``bus_span_candidates``)
    that the exact tile test admits, bucketed stably by bus (bus order,
    packed order within a bus).  A tile's buses summed over these lists
    are the render, bit for bit."""
    cand, counts = bus_span_candidates(vp, n0, nframes, samplerate=samplerate,
                                       layout=layout, seg=seg, nseg=nseg,
                                       span=span)
    span = span or span_tiles(nframes, sum(g[3] for g in layout.groups))
    sr_r = _sr_r(samplerate)
    ntiles = -(-nframes // TILE)
    out = []
    for j in range(ntiles):
        e = cand[j // span, :int(counts[j // span])].to(torch.int64)
        key = e[:, 1]
        a, b = j * TILE, min((j + 1) * TILE, nframes)
        silent = _silent_on(~((key & KEY_UNSAFE) != 0), e[:, 2],
                            e[:, 3].to(torch.int32).view(torch.float32),
                            n0 + a, b - a, TILE, sr_r)[:, 0]
        e, key = e[~silent], key[~silent]
        bus = key & 0xffff
        order = torch.sort(bus, stable=True).indices
        out.append(torch.stack([e[order, 0], bus[order],
                                (key[order] >> KEY_CODE_SHIFT) & 0x1ff], 1))
    return out


class CurveSegments(NamedTuple):
    """The per-segment constants of a bank's curves, int32 words (u32 and
    f32 values as their bit patterns); rows of voices without the curve's
    flag hold nothing the render reads.

    bend [V, S, 4]: start, bend_phase, bend_inc, bend_d.
    amp [V, KA, 4]: start, g0, dg, 0.
    depth [V, KD, 8]: start, c, a, b, then the LFO phase ph_j at the
    segment's first frame, cos_turns(x(ph_j - fm_inc // 2)), sin_turns(x(ph_j))
    and cos_turns(x(ph_j)): the three trig values of the depth integral that
    do not depend on the frame."""
    bend: torch.Tensor
    amp: torch.Tensor
    depth: torch.Tensor


def segment_views(buf: torch.Tensor, V: int, S: int, KA: int,
                  KD: int) -> CurveSegments:
    """The setup kernel's flat per-segment buffer as ``CurveSegments``."""
    sizes = [V * k * w for k, w in zip((S, KA, KD), SEGMENT_WORDS)]
    parts = torch.split(buf[:sum(sizes)], sizes)
    return CurveSegments(*(p.view(V, k, w) for p, k, w in
                           zip(parts, (S, KA, KD), SEGMENT_WORDS)))


def curve_constants(vp: VoiceParams) -> CurveSegments:
    """The plain version of the setup kernel's per-segment pass: every
    value is the same expression in the same order as the per-frame code of
    ``_phases`` / ``_dmod_delta`` evaluated at the segment's first frame.
    Rows of voices without the curve's flag are zero."""
    zero = torch.zeros((), dtype=torch.int32, device=vp.device)

    def rows(has, *words):
        return torch.where(has[:, None, None], torch.stack(words, dim=2), zero)

    bend = rows(vp.bend_start[:, 0] == 0, vp.bend_start,
                _u32_bits(vp.bend_phase), _u32_bits(vp.bend_inc),
                _u32_bits(vp.bend_d))
    amp = rows(vp.acurve_start[:, 0] == 0, vp.acurve_start,
               _f32_bits(vp.acurve_g0), _f32_bits(vp.acurve_dg),
               torch.zeros_like(vp.acurve_start))
    inc = vp.fm_inc[:, None]
    half = inc >> 1
    st = vp.dcurve_start.to(torch.int64)
    ph_j = (vp.fm_phase0[:, None] + ((vp.start[:, None] + st) & _U32) * inc) & _U32
    xj = _phase_x(ph_j)
    depth = rows((vp.dcurve_start[:, 0] == 0) & (vp.fm_inc != 0),
                 vp.dcurve_start, _f32_bits(vp.dcurve_c),
                 _f32_bits(vp.dcurve_a), _f32_bits(vp.dcurve_b),
                 _u32_bits(ph_j),
                 _f32_bits(cos_turns(_phase_x((ph_j - half) & _U32))),
                 _f32_bits(sin_turns(xj)), _f32_bits(cos_turns(xj)))
    return CurveSegments(bend, amp, depth)


def curve_voices(vp: VoiceParams, layout: BankLayout, *,
                 use_bend: bool = False, use_amp: bool = False,
                 use_dmod: bool = False) -> torch.Tensor:
    """bool [3, V] in the order of ``CURVES``: the voices whose bend,
    amplitude and depth curve the render evaluates (the bank's flag, the
    voice's flag, and for bend a waveform that is not pluck, tested with
    the waveform of the group that holds the voice)."""
    V = vp.wave.shape[0]
    wid = vp.wave.clone()
    for (gw, _, start, count) in layout.groups:
        if gw >= 0:
            wid[start:start + count] = gw
    pitched = (vp.wave != 12) | (wid == 9) | (wid == 10)
    return torch.stack([
        (vp.bend_start[:, 0] == 0) & pitched & bool(use_bend),
        (vp.acurve_start[:, 0] == 0) & torch.full((V,), bool(use_amp),
                                                  device=vp.device),
        (vp.dcurve_start[:, 0] == 0) & (vp.fm_inc != 0) & bool(use_dmod)])


def tile_segment_windows(vp: VoiceParams, n0: int, nframes: int, *,
                         tile: int = TILE, window: int = WINDOW) -> dict:
    """The render kernel's per-tile segment windows as plain PyTorch ->
    {curve: (first, last, fallback)}, each [V, ntiles] (int64, int64,
    bool), for the curves of ``CURVES``.  On tile j (frames [n0 + j*tile,
    n0 + min((j+1)*tile, nframes))) the active segment of every frame of
    voice v lies in [first, last]: ``_seg_idx`` at the tile's first and
    last note-relative frame.  ``fallback`` is True where the kernel
    searches the whole row per frame instead of its shared-memory window:
    the window holds more than ``window`` segments, the row's starts are
    not sorted, or the note-relative frames wrap i32 inside the tile
    (there first..last is the whole row)."""
    _, m_first, m_last = _tile_ends(vp.start, n0, nframes, tile)
    out = {}
    for name, st in zip(CURVES, (vp.bend_start, vp.acurve_start,
                                 vp.dcurve_start)):
        whole = (~(st[:, 1:] >= st[:, :-1]).all(dim=1)[:, None]
                 | (m_first > m_last))
        first = torch.where(whole, 0, _seg_idx(st, m_first))
        last = torch.where(whole, st.shape[1] - 1, _seg_idx(st, m_last))
        out[name] = (first, last, whole | (last - first >= window))
    return out
