"""Device-resident ``Sample`` PCM buffer and ``LevelMeter`` (port of
``synthesizer_tpu.sample``).

A PCM sample with immutable metadata and a rebindable buffer whose
chainable ops run on an int tensor [nframes, nchannels] held in device
memory.  The numeric contract for every op is defined by
``goldref.sample.Sample``.

**Lazy op capture.**  The original chainable API mutates eagerly; here
each op *stages* a node of a tiny IR instead, and the whole pending chain
runs as ONE device program when the data is actually needed
(``get_frame_array`` / ``write_wav`` / ``torch_frames`` / mixing into
another sample without fusing / ...).  Users keep the chainable API, the
device sees a single program per chain shape (a ``utils.program.Program``:
captured once as a CUDA graph, cached by structure), and a chain costs one
dispatch instead of one per op.  Knob values travel as device scalars, so a
chain that differs only in its knobs reuses its program.  Even
data-dependent scaling (``amplify_max``, ``make_16bit``) stages, because
the peak factor is computed in the program.  A mixed-in, modulating,
key or impulse-response sample with a pending chain fuses in as a
sub-program.  A reverb whose comb stage outgrows one program
(``ops.effects.WHOLE_STEPS`` steps, about 26 s at 44.1 kHz) does not
stage: it runs after the staged chain, replaying programs of its own.  On
the CPU the chain runs eagerly when it materialises.

Shape/format metadata is tracked eagerly through staged ops, so
``nframes``/``duration``/format queries never force materialization.
Each staged op's executor (``_x_<op>``) holds the op's PyTorch body; ops
that the JAX package does not stage (the loudness meters, the writers)
run eagerly on the materialised buffer.

**Tensors are mutable, so no op writes in place.**  Every program builds
new tensors and the sample rebinds its buffer to the result; ``copy``
shares the buffer and the pending chain.  What another ``Sample`` holds is
therefore never changed by an op on this one.  A tensor handed to
``from_torch`` is wrapped without a copy: the caller must not write into
it afterwards.

**The host copy.**  ``get_frame_array`` is where a result crosses to the
host.  On a CUDA sample it copies into pinned host memory
(``utils.device.to_host``) and caches the read-only view until the buffer
is rebound; on a CPU sample it is a view of the tensor.

**File output.**  WAV goes through ``utils.wavio``, FLAC through the
port's own encoder (``utils.flac``), MP3, Ogg Vorbis, Opus and AAC through
the system codec libraries (``utils.codecs``, ``utils.libav``), which
raise where a library is missing.
"""

from __future__ import annotations

import math
import os
from typing import Iterator, List, NamedTuple, Optional, Tuple

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
from .utils.program import Program, program

_DTYPES = dpcm.DTYPES
_NPDT = {1: np.int8, 2: np.int16, 4: np.int32}
MAXVAL = dpcm.MAXVAL
MINVAL = dpcm.MINVAL

#: auto-materialize when a chain grows beyond this many staged ops
_MAX_PENDING = 160


class _Op(NamedTuple):
    name: str
    static: Tuple       # hashable static params
    ndyn: int           # f32 scalars consumed from the dyn vector
    nleaf: int          # leaf tensors consumed


def _pan_gains(amt: torch.Tensor) -> torch.Tensor:
    """Per-frame pan amounts [n] -> per-channel gains [n, 2]."""
    la = torch.clamp_max(1.0 - amt, 1.0)
    ra = torch.clamp_max(1.0 + amt, 1.0)
    return torch.stack([la, ra], dim=-1)


def _fit(g: torch.Tensor, n: int, fill: float) -> torch.Tensor:
    """``g`` [m] cut or continued with ``fill`` to [n]."""
    if g.shape[0] < n:
        g = torch.cat([g, torch.full((n - g.shape[0],), fill,
                                     dtype=torch.float32, device=g.device)])
    return g[:n]


# ---------------------------------------------------------------------------
# Staged-op executors.  Each runs inside the chain's program:
#   exec(x, static, dyn: list of 0-dim f32 tensors, leaves: list) -> x
# ---------------------------------------------------------------------------

def _x_amplify(x, st, dyn, leaves):
    return dpcm.mul_floor(x, dyn[0])


def _x_amplify_max(x, st, dyn, leaves):
    pk = dpcm.peak(x)
    full = W.scalar(MAXVAL[dpcm.width_of(x)], x.device)
    factor = torch.where(pk == 0, torch.ones_like(full),
                         full / pk.to(torch.float32))
    return dpcm.mul_floor(x, factor)


def _x_bias(x, st, dyn, leaves):
    return dpcm.bias_wrap(x, st[0])


def _x_slice(x, st, dyn, leaves):
    a, b = st
    return x[a:b]


def _x_cut(x, st, dyn, leaves):
    a, b = st
    return torch.cat([x[:a], x[b:]], dim=0)


def _silence(x, n: int) -> torch.Tensor:
    return torch.zeros((n, x.shape[1]), dtype=x.dtype, device=x.device)


def _x_pad(x, st, dyn, leaves):
    n, at_start = st
    z = _silence(x, n)
    return torch.cat([z, x] if at_start else [x, z], dim=0)


def _x_join(x, st, dyn, leaves):
    other = _run_ops(leaves[0], st[0], dyn, leaves[1:])
    return torch.cat([x, other], dim=0)


def _x_reverse(x, st, dyn, leaves):
    return torch.flip(x, [0])


def _ramp(x, n: int) -> torch.Tensor:
    return torch.arange(n, dtype=torch.float32, device=x.device)


def _x_fadein(x, st, dyn, leaves):
    (n,) = st
    start = dyn[0]
    g = start + (1.0 - start) * W.div(_ramp(x, n), n)
    head = dpcm.gain_apply(x[:n], g[:, None])
    return torch.cat([head, x[n:]], dim=0)


def _x_fadeout(x, st, dyn, leaves):
    (n, total) = st
    target = dyn[0]
    g = target + (1.0 - target) * W.div(
        float(np.float32(n) - np.float32(1.0)) - _ramp(x, n), n)
    tail = dpcm.gain_apply(x[total - n:], g[:, None])
    return torch.cat([x[:total - n], tail], dim=0)


def _x_envelope(x, st, dyn, leaves):
    """ADSR gain curve over the whole buffer (goldref.sample.adsr_gains)."""
    (n, samplerate) = st
    a = torch.clamp_min(dyn[0], 0.0)
    d = torch.clamp_min(dyn[1], 0.0)
    sl = dyn[2]
    r = torch.clamp_min(dyn[3], 0.0)
    t = W.div(_ramp(x, n), samplerate)
    dur = float(np.float32(n / samplerate))
    eps = W.scalar(1e-30, x.device)
    g = torch.ones_like(t)
    g = torch.where(a > 0, torch.minimum(g, t / torch.maximum(a, eps)), g)
    ad = a + d
    in_decay = (t >= a) & (t < ad)
    g = torch.where(in_decay,
                    1.0 + ((sl - 1.0) * (t - a)) / torch.maximum(d, eps), g)
    g = torch.where(t >= ad, sl, g)
    rel_gain = (g * (dur - t)) / torch.maximum(r, eps)
    g = torch.where((r > 0) & (t >= dur - r), rel_gain, g)
    return dpcm.gain_apply(x, torch.clamp_min(g, 0.0)[:, None])


def _x_modulate(x, st, dyn, leaves):
    return dpcm.gain_apply(x, leaves[0][:, None])


def _x_modulate_sample(x, st, dyn, leaves):
    maxval, sub_ops = st
    mod = _run_ops(leaves[0], sub_ops, dyn, leaves[1:])
    g = _fit(W.div(mod[:, 0].to(torch.float32), maxval), x.shape[0], 1.0)
    return dpcm.gain_apply(x, g[:, None])


def _x_mix_at(x, st, dyn, leaves):
    start, m, out_len, sub_ops = st
    other = _run_ops(leaves[0], sub_ops, dyn, leaves[1:])[:m]
    if out_len > x.shape[0]:
        x = torch.cat([x, _silence(x, out_len - x.shape[0])], dim=0)
    mixed = dpcm.sat_add(x[start:start + m], other)
    return torch.cat([x[:start], mixed, x[start + m:]], dim=0)


def _x_echo(x, st, dyn, leaves):
    total, offsets = st                 # offsets: exact per-echo start frames
    decay = dyn[0]
    orig = x
    cur = x.shape[0]
    if total > cur:
        x = torch.cat([x, _silence(x, total - cur)], dim=0)
    else:
        x = x[:total]
    gain = W.scalar(1.0, x.device)
    for dk in offsets:
        gain = gain * decay
        if dk >= total:
            continue
        m = min(orig.shape[0], total - dk)
        copy_k = dpcm.mul_floor(orig[:m], gain)
        mixed = dpcm.sat_add(x[dk:dk + m], copy_k)
        x = torch.cat([x[:dk], mixed, x[dk + m:]], dim=0)
    return x


def _x_lin2lin(x, st, dyn, leaves):
    return dpcm.lin2lin(x, st[0])


def _x_astype_i32(x, st, dyn, leaves):
    return x.to(torch.int32)


def _x_tomono(x, st, dyn, leaves):
    return dpcm.to_mono(x, dyn[0], dyn[1])


def _x_tostereo(x, st, dyn, leaves):
    return dpcm.to_stereo(x, dyn[0], dyn[1])


def _x_stereo_mix(x, st, dyn, leaves):
    ch, m, sub_ops = st
    other = _run_ops(leaves[0], sub_ops, dyn[1:], leaves[1:])
    scaled = dpcm.mul_floor(other[:m, 0], dyn[0])
    mixed = dpcm.sat_add(x[:m, ch], scaled)
    # the write goes into a fresh tensor that nobody else holds
    y = x.clone()
    y[:m, ch] = mixed
    return y


def _x_pan_const(x, st, dyn, leaves):
    return dpcm.gain_apply(x, _pan_gains(dyn[0])[None, :])


def _x_pan_lfo(x, st, dyn, leaves):
    return dpcm.gain_apply(x, _pan_gains(leaves[0]))


def _x_gen_patch(x, st, dyn, leaves):
    """A Sample's data from an oscillator patch, rendered in the program:
    the patch's block loop and the int quantization fuse into whatever
    program consumes the sample, so a mixdown of synthesized tracks is ONE
    device program."""
    node, n, sr, width, blocksize = st
    from .models import graph as G
    vals = G.patch_values(node, n, sr, blocksize, x.device)
    return G.to_int_device(vals, width)[:, None]


def _x_modulate_patch(x, st, dyn, leaves):
    node, n, sr = st
    from .models import graph as G
    return dpcm.gain_apply(x, G.patch_values(node, n, sr,
                                             device=x.device)[:, None])


def _x_pan_patch(x, st, dyn, leaves):
    node, n, sr = st
    from .models import graph as G
    return dpcm.gain_apply(x, _pan_gains(G.patch_values(node, n, sr,
                                                        device=x.device)))


def _x_pan_sample(x, st, dyn, leaves):
    maxval, n, sub_ops = st
    mod = _run_ops(leaves[0], sub_ops, dyn, leaves[1:])
    amt = _fit(W.div(mod[:, 0].to(torch.float32), maxval), n, 1.0)
    return dpcm.gain_apply(x, _pan_gains(amt))


def _x_tremolo(x, st, dyn, leaves):
    return dfx.tremolo(x, leaves[0])


def _x_autopan(x, st, dyn, leaves):
    return dfx.autopan(x, leaves[0])


def _x_compress(x, st, dyn, leaves):
    # st = (has_knee,): a static flag, so the hard-knee program's
    # arithmetic is untouched when knee_db == 0 (the knee value itself
    # stays dyn: tweaking a nonzero knee reuses the program)
    knee = dyn[5] if st[0] else None
    g = dfx.compressor_gains_from_coeffs(x, dyn[0], dyn[1], dyn[2], dyn[3],
                                         knee=knee)
    return dpcm.gain_apply(x, (g * dyn[4])[:, None])


def _x_compress_sc(x, st, dyn, leaves):
    """Sidechain compression: the detector listens to the fused key
    sub-program; the gain applies to x (goldref.effects.sidechain_level)."""
    key_maxval, sub_ops, has_knee = st
    nk = 6 if has_knee else 5
    key = _run_ops(leaves[0], sub_ops, dyn[nk:], leaves[1:])
    a = torch.amax(torch.abs(W.div(key.to(torch.float32), key_maxval)),
                   dim=1)
    a = _fit(a, x.shape[0], 0.0)
    g = dfx.compressor_gains_from_level(a, dyn[0], dyn[1], dyn[2], dyn[3],
                                        knee=dyn[5] if has_knee else None)
    return dpcm.gain_apply(x, (g * dyn[4])[:, None])


def _x_reverb(x, st, dyn, leaves):
    samplerate, tail_frames = st
    return dfx.reverb_from_params(x, samplerate, dyn[0], dyn[1], dyn[2],
                                  dyn[3], dyn[4], tail_frames)


def _x_chorus(x, st, dyn, leaves):
    samplerate, rate, depth, delay, voices = st
    return dfx.chorus(x, samplerate, rate, depth, delay, voices, dyn[0],
                      dyn[1])


def _x_biquad(x, st, dyn, leaves):
    w = dpcm.width_of(x)
    y, _ = dfx.biquad_apply(W.div(x.to(torch.float32), MAXVAL[w]),
                            tuple(dyn[:5]))
    return dfx.to_int_samples(y, w)


def _x_biquad_ff(x, st, dyn, leaves):
    # badly conditioned coefficients (ops.coeffs.wants_ff_scan): the
    # float-float scan with (hi, lo) coefficient pairs in the dyn vector
    w = dpcm.width_of(x)
    pairs = tuple((dyn[2 * i], dyn[2 * i + 1]) for i in range(5))
    y, _ = dfx.biquad_apply_ff(W.div(x.to(torch.float32), MAXVAL[w]), pairs)
    return dfx.to_int_samples(y, w)


def _x_gate(x, st, dyn, leaves):
    g = dfx.gate_gains_from_coeffs(x, dyn[0], dyn[1], dyn[2], dyn[3],
                                   e0=0.0, z0=dyn[1])
    return dpcm.gain_apply(x, g[:, None])


def _x_convolve(x, st, dyn, leaves):
    ir_maxval, sub_ops = st
    ir_int = _run_ops(leaves[0], sub_ops, dyn[2:], leaves[1:])
    ir_norm = W.div(ir_int.to(torch.float32), ir_maxval)
    return dfx.convolve(x, ir_norm, dyn[0], dyn[1])


def _x_granulate(x, st, dyn, leaves):
    samplerate, duration, grain, density, jitter, seed = st
    return dfx.granulate(x, samplerate, duration, grain, density, jitter,
                         dyn[0], seed)


def _x_stretch(x, st, dyn, leaves):
    factor, frame, hop = st
    return dfx.stretch(x, factor, frame, hop)


def _x_fb_echo(x, st, dyn, leaves):
    D, tail_frames = st
    return dfx.feedback_echo(x, D, dyn[0], dyn[1], dyn[2], tail_frames)


def _x_width(x, st, dyn, leaves):
    return dfx.stereo_width(x, dyn[0])


def _x_limit(x, st, dyn, leaves):
    samplerate, L, cint = st
    return dfx.limiter(x, dyn[0], dyn[1], L, cint)


def _x_phaser(x, st, dyn, leaves):
    stages, ff = st
    w = dpcm.width_of(x)
    z = torch.zeros(x.shape[1], dtype=torch.float32, device=x.device)
    if ff:
        grids = tuple((leaves[2 * i], leaves[2 * i + 1]) for i in range(5))
        states = tuple((z,) * 6 for _ in range(stages))
    else:
        grids = tuple(leaves)
        states = tuple((z,) * 4 for _ in range(stages))
    s = W.div(x.to(torch.float32), MAXVAL[w])
    y, _ = dfx.phaser_apply(s, grids, states, ff)
    return dfx.to_int_samples(dyn[1] * s + dyn[0] * y, w)


def _x_ratecv(x, st, dyn, leaves):
    inr, outr = st
    return dresample.resample_tensor(x, inr, outr)


def _x_hq_resample(x, st, dyn, leaves):
    L, M, nout = st
    return dresample.hq_resample(x, L, M, nout)


_EXEC = {
    "amplify": _x_amplify, "amplify_max": _x_amplify_max, "bias": _x_bias,
    "slice": _x_slice, "cut": _x_cut, "pad": _x_pad, "join": _x_join,
    "reverse": _x_reverse, "fadein": _x_fadein, "fadeout": _x_fadeout,
    "envelope": _x_envelope, "modulate": _x_modulate,
    "modulate_sample": _x_modulate_sample, "mix_at": _x_mix_at,
    "echo": _x_echo, "lin2lin": _x_lin2lin, "astype_i32": _x_astype_i32,
    "tomono": _x_tomono, "tostereo": _x_tostereo, "stereo_mix": _x_stereo_mix,
    "pan_const": _x_pan_const, "pan_lfo": _x_pan_lfo, "ratecv": _x_ratecv,
    "hq_resample": _x_hq_resample,
    "gen_patch": _x_gen_patch, "modulate_patch": _x_modulate_patch,
    "pan_patch": _x_pan_patch, "pan_sample": _x_pan_sample,
    "compress": _x_compress, "reverb": _x_reverb, "chorus": _x_chorus,
    "convolve": _x_convolve, "stretch": _x_stretch,
    "biquad": _x_biquad, "biquad_ff": _x_biquad_ff,
    "gate": _x_gate, "compress_sc": _x_compress_sc,
    "granulate": _x_granulate,
    "fb_echo": _x_fb_echo, "width": _x_width, "limit": _x_limit,
    "phaser": _x_phaser, "tremolo": _x_tremolo, "autopan": _x_autopan,
}

def _run_ops(x, ops: Tuple[_Op, ...], dyn, leaves):
    """Execute a (sub-)program inside the chain's program.

    ``dyn``/``leaves`` are flat sequences consumed in op order —
    sub-programs (a mixed-in sample's own staged chain) nest recursively
    via an op's trailing dyn/leaf slices.
    """
    di = li = 0
    for op in ops:
        d = [dyn[di + j] for j in range(op.ndyn)]
        lv = [leaves[li + j] for j in range(op.nleaf)]
        x = _EXEC[op.name](x, op.static, d, lv)
        di += op.ndyn
        li += op.nleaf
    return x


def _compile_program(ops: Tuple[_Op, ...], device) -> Program:
    """The chain's program, cached by its ops and device, with one key a
    shape of the base and the leaves: the JAX package's
    ``_program_cache``."""
    def build():
        def run(base, leaves, f, i):
            return _run_ops(base, ops, f, leaves)
        return run
    return program("sample_chain", ops, build, device)


class Sample:
    """A device-resident PCM sample with chainable, lazily fused DSP ops.

    API-compatible with the original ``Sample``: ops mutate in place (they
    stage onto this sample's chain) and return ``self`` for chaining; the
    chain runs as one device program on demand (module docstring).  The
    constructors put the frames on the card unless the caller passes
    ``device="cpu"``; a sample made from another sample or from a tensor
    stays on that tensor's device.
    """

    def __init__(self, wave_file=None, name: str = "", device="cuda"):
        dev = _device(device)
        self.name = name
        self._ops: List[_Op] = []
        self._dyn: List[float] = []
        self._leaves: List[torch.Tensor] = []
        self._host_cache: Optional[np.ndarray] = None
        self._host_base: Optional[torch.Tensor] = None
        if wave_file is not None:
            frames, rate, width, nch = wavio.read_wav(wave_file)
            self._base = torch.from_numpy(
                np.require(frames, requirements=("C", "W"))).to(dev)
            self._samplerate = rate
            self._samplewidth = width
            if isinstance(wave_file, str) and not name:
                self.name = wave_file
        else:
            self._base = torch.zeros(
                (0, params.norm_nchannels),
                dtype=_DTYPES[params.norm_samplewidth], device=dev)
            self._samplerate = params.norm_samplerate
            self._samplewidth = params.norm_samplewidth
        self._nframes, self._nchannels = (int(v) for v in self._base.shape)

    # -- staging machinery -----------------------------------------------------

    def _stage(self, name: str, static: Tuple = (), dyn: Tuple = (),
               leaves: Tuple = ()) -> None:
        self._ops.append(_Op(name, static, len(dyn), len(leaves)))
        self._dyn.extend(float(d) for d in dyn)
        dev = self._base.device
        self._leaves.extend(t.to(dev) for t in leaves)
        if len(self._ops) > _MAX_PENDING:
            self._materialize()

    def _materialize(self) -> torch.Tensor:
        if self._ops:
            prog = _compile_program(tuple(self._ops), self._base.device)
            self._base = prog(self._base, tuple(self._leaves), f=self._dyn)
            self._ops, self._dyn, self._leaves = [], [], []
        return self._base

    def _as_subprogram(self):
        """(sub_ops, dyn, leaves) for fusing this sample into another's
        program without materializing it (very long chains materialize
        first to bound program sizes)."""
        if len(self._ops) > 48:
            self._materialize()
        return (tuple(self._ops), tuple(self._dyn),
                (self._base, *self._leaves))

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
        s._ops, s._dyn, s._leaves = [], [], []
        s._host_cache = s._host_base = None
        s._base = data
        s._samplerate, s._samplewidth = int(samplerate), int(samplewidth)
        s._nframes, s._nchannels = (int(v) for v in data.shape)
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
        """A mono Sample whose data is a *staged* oscillator-patch render:
        nothing runs at construction; the patch's block loop is an IR node
        like any other op, so downstream chains (and cross-sample mixes)
        fuse the synthesis itself into one device program."""
        from .models import graph as G
        G.check_inline(node)
        data = torch.zeros((0, 1), dtype=_DTYPES[int(samplewidth)],
                           device=_device(device))
        s = cls.from_torch(data, samplerate, samplewidth, name)
        s._stage("gen_patch", static=(node, int(nframes), int(samplerate),
                                      int(samplewidth), int(blocksize)))
        s._nframes = int(nframes)
        return s

    def _replace_frames(self, data: torch.Tensor) -> "Sample":
        """Swap in new frames of the same format, in place (the eager
        fx-automation path computes outside the chain: any staged ops are
        materialized first by the caller)."""
        if data.ndim != 2 or data.dtype != _DTYPES[self._samplewidth]:
            raise ValueError("replacement frames must be [n, ch] of the "
                             "sample's own dtype")
        if self._ops:
            raise ValueError("materialize the staged ops before replacing "
                             "the frames")
        self._base = data
        self._nframes, self._nchannels = (int(v) for v in data.shape)
        return self

    def copy(self) -> "Sample":
        # shares the buffer and the pending chain: no op writes into either
        s = Sample.from_torch(self._base, self._samplerate,
                              self._samplewidth, self.name)
        s._ops, s._dyn, s._leaves = (list(self._ops), list(self._dyn),
                                     list(self._leaves))
        s._nframes, s._nchannels = self._nframes, self._nchannels
        return s

    dup = copy

    # -- introspection (never materializes) ---------------------------------------

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
        return self._nchannels

    @property
    def nframes(self) -> int:
        return self._nframes

    @property
    def duration(self) -> float:
        return self._nframes / self._samplerate

    @property
    def maxvalue(self) -> int:
        return MAXVAL[self._samplewidth]

    @property
    def device(self) -> torch.device:
        return self._base.device

    @property
    def torch_frames(self) -> torch.Tensor:
        """The [nframes, nchannels] int tensor on the sample's device
        (materializes).  Do not write into it."""
        return self._materialize()

    def __len__(self) -> int:
        return self._nframes

    def __repr__(self) -> str:
        return (f"<Sample '{self.name}' {self.duration:.3f}s "
                f"{self._samplerate}Hz {8 * self._samplewidth}bit "
                f"{self._nchannels}ch>")

    def __eq__(self, other) -> bool:
        if not isinstance(other, Sample):
            return NotImplemented
        return (self._samplerate, self._samplewidth, self._nchannels) == \
               (other._samplerate, other._samplewidth, other._nchannels) and \
               self._nframes == other._nframes and \
               bool(torch.equal(self._materialize(),
                                other._materialize().to(self.device)))

    def view_frame_data(self) -> bytes:
        """Raw interleaved little-endian frame bytes (device -> host copy)."""
        return self.get_frame_array().tobytes()

    def get_frame_array(self, out: Optional[torch.Tensor] = None
                        ) -> np.ndarray:
        """Frames as a read-only host numpy array [nframes, nchannels]
        (materializes).

        On a CUDA sample the frames are copied into a pinned host buffer
        that this sample owns (``copy_(non_blocking=True)``, then the
        stream is synchronised), and the view of it is cached until an op
        rebinds the frames, so repeated calls copy nothing and the view
        never aliases a later render.  A caller that renders repeatedly
        can pass ``out=``, a pinned tensor of the frames' shape and dtype,
        to reuse one buffer; the view of a caller's buffer is not cached.
        On a CPU sample the array is a view of the tensor.  Copy before
        writing."""
        base = self._materialize()
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

    # -- file output --------------------------------------------------------------

    def write_wav(self, file) -> "Sample":
        wavio.write_wav(file, self.get_frame_array(), self._samplerate,
                        self._samplewidth, self._nchannels)
        return self

    def write_flac(self, file) -> "Sample":
        """Write the sample losslessly as FLAC (``utils.flac`` encoder:
        fixed predictors and native Rice coding; decode is bit-identical)."""
        from .utils.flac import write_flac
        write_flac(file, self.get_frame_array(), self._samplerate,
                   self._samplewidth, self._nchannels)
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
                  self._nchannels, bitrate=bitrate)
        return self

    def write_ogg(self, file, quality: float = 0.4) -> "Sample":
        """Encode to Ogg Vorbis (VBR quality -0.1..1.0) through the system
        libvorbisenc (``utils.codecs``).  Lossy: 16-bit input."""
        from .utils.codecs import write_vorbis
        write_vorbis(file, self._frames_16bit(), self._samplerate,
                     self._nchannels, quality=quality)
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
                   smp._nchannels, bitrate=bitrate)
        return self

    def write_m4a(self, file, bitrate: int = 128000) -> "Sample":
        """Encode to AAC in MP4 (.m4a), or raw ADTS when the name ends in
        .aac, through the libav shim (``utils.libav``).  Lossy: 16-bit."""
        from .utils.libav import write_with_libav
        write_with_libav(os.fspath(file), self._frames_16bit(),
                         self._samplerate, self._nchannels, bitrate=bitrate)
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
        self._stage("amplify", dyn=(factor,))
        return self

    def amplify_max(self) -> "Sample":
        """Amplify to full scale; the f32 factor maxval/peak is computed in
        the program on the device (no host copy)."""
        self._stage("amplify_max")
        return self

    def invert(self) -> "Sample":
        return self.amplify(-1.0)

    def bias(self, amount: int) -> "Sample":
        """Wrapping DC offset (audioop.bias)."""
        self._stage("bias", static=(int(amount),))
        return self

    # -- arrangement ----------------------------------------------------------------------

    def clip(self, start_seconds: float, end_seconds: float) -> "Sample":
        a = min(self._n(start_seconds), self._nframes)
        b = min(max(self._n(end_seconds), a), self._nframes)
        self._stage("slice", static=(a, b))
        self._nframes = b - a
        return self

    def cut(self, start_seconds: float, end_seconds: float) -> "Sample":
        a = min(self._n(start_seconds), self._nframes)
        b = min(max(self._n(end_seconds), a), self._nframes)
        self._stage("cut", static=(a, b))
        self._nframes -= (b - a)
        return self

    def split(self, seconds: float) -> "Sample":
        n = min(self._n(seconds), self._nframes)
        tail = self.copy()
        tail._stage("slice", static=(n, tail._nframes))
        tail._nframes = self._nframes - n
        self._stage("slice", static=(0, n))
        self._nframes = n
        return tail

    def add_silence(self, seconds: float, at_start: bool = False) -> "Sample":
        return self._pad(self._n(seconds), at_start)

    def _pad(self, n: int, at_start: bool) -> "Sample":
        n = max(int(n), 0)
        self._stage("pad", static=(n, bool(at_start)))
        self._nframes += n
        return self

    def pad_frames(self, nframes: int, at_start: bool = False) -> "Sample":
        """Frame-precise silence padding (no seconds round-trip)."""
        if nframes > 0:
            self._pad(int(nframes), bool(at_start))
        return self

    def truncate_frames(self, nframes: int) -> "Sample":
        """Keep only the first ``nframes`` frames (frame-precise clip)."""
        n = min(int(nframes), self._nframes)
        self._stage("slice", static=(0, n))
        self._nframes = n
        return self

    def join(self, other: "Sample") -> "Sample":
        self._check_format(other)
        sub_ops, dyn, leaves = other._as_subprogram()
        self._stage("join", static=(sub_ops,), dyn=dyn, leaves=leaves)
        self._nframes += other._nframes
        return self

    def reverse(self) -> "Sample":
        self._stage("reverse")
        return self

    def delay(self, seconds: float, keep_length: bool = False) -> "Sample":
        n = self._n(abs(seconds))
        if seconds >= 0:
            self.add_silence(abs(seconds), at_start=True)
            if keep_length and n > 0:
                end = max(self._nframes - n, 0)
                self._stage("slice", static=(0, end))
                self._nframes = end
        else:
            n = min(n, self._nframes)
            self._stage("slice", static=(n, self._nframes))
            self._nframes -= n
            if keep_length:
                self.add_silence(abs(seconds))
        return self

    # -- fades & envelopes ---------------------------------------------------------------

    def fadein(self, seconds: float, start_volume: float = 0.0) -> "Sample":
        n = min(self._n(seconds), self._nframes)
        if n > 0:
            self._stage("fadein", static=(n,), dyn=(start_volume,))
        return self

    def fadeout(self, seconds: float, target_volume: float = 0.0) -> "Sample":
        n = min(self._n(seconds), self._nframes)
        if n > 0:
            self._stage("fadeout", static=(n, self._nframes),
                        dyn=(target_volume,))
        return self

    def envelope(self, attack: float, decay: float, sustainlevel: float,
                 release: float) -> "Sample":
        """ADSR gain curve over the whole buffer (goldref.sample.adsr_gains)."""
        self._stage("envelope", static=(self._nframes, self._samplerate),
                    dyn=(attack, decay, sustainlevel, release))
        return self

    def modulate_amp(self, modulator) -> "Sample":
        """Per-sample amplitude modulation by a Sample, f32 array or
        tensor, or an object exposing ``gains(n)`` (oscillators).  A Sample
        modulator's own staged chain fuses in as a sub-program; an
        oscillator's patch renders in the program."""
        if isinstance(modulator, Sample):
            sub_ops, dyn, leaves = modulator._as_subprogram()
            self._stage("modulate_sample",
                        static=(MAXVAL[modulator._samplewidth], sub_ops),
                        dyn=dyn, leaves=leaves)
            return self
        if hasattr(modulator, "spec"):
            from .models import graph as G
            from .models import spec as S
            if S.has_host_source(modulator.spec):
                # a user-oscillator LFO cannot render in one pass: its
                # gains render now through the per-block hybrid loop
                g = G.render_patch(modulator.spec, self._nframes,
                                   modulator.samplerate, device=self.device)
                self._stage("modulate", leaves=(g,))
                return self
            self._stage("modulate_patch",
                        static=(modulator.spec, self._nframes,
                                modulator.samplerate))
            return self
        g = _modulator_gains(modulator, self._nframes, self.device)
        self._stage("modulate", leaves=(g,))
        return self

    # -- mixing -------------------------------------------------------------------------------

    def mix(self, other: "Sample", other_seconds: Optional[float] = None,
            pad_shortest: bool = True) -> "Sample":
        return self.mix_at(0.0, other, other_seconds, pad_shortest=pad_shortest)

    def mix_at(self, seconds: float, other: "Sample",
               other_seconds: Optional[float] = None,
               pad_shortest: bool = True) -> "Sample":
        """Saturating add of ``other`` at a frame offset (the trackmixer
        hot loop), staged; ``other``'s own pending chain fuses in as a
        sub-program, so a whole multi-track mixdown of staged samples is
        ONE device program."""
        self._check_format(other)
        if seconds < 0:
            raise ValueError("mix_at offset must be >= 0")
        m = other._nframes
        if other_seconds is not None:
            m = min(m, other._n(other_seconds))
        start = self._n(seconds)
        if start + m > self._nframes and not pad_shortest:
            m = max(0, self._nframes - start)
        if m == 0:
            return self
        out_len = max(self._nframes, start + m)
        sub_ops, dyn, leaves = other._as_subprogram()
        self._stage("mix_at", static=(start, m, out_len, sub_ops),
                    dyn=dyn, leaves=leaves)
        self._nframes = out_len
        return self

    def echo(self, length: float, amount: int, delay: float,
             decay: float) -> "Sample":
        """Feed-forward echo (spec: goldref.sample.Sample.echo).  Per-echo
        offsets are rounded from seconds individually (int(k*delay*sr)),
        matching the oracle's per-copy mix_at exactly."""
        total = self._n(length)
        offsets = tuple(self._n(k * delay) for k in range(1, int(amount) + 1))
        self._stage("echo", static=(total, offsets), dyn=(decay,))
        self._nframes = total
        return self

    # -- effects rack (beyond the reference; contract: goldref.effects) --------------------------

    def compress(self, threshold_db: float = -20.0, ratio: float = 4.0,
                 attack: float = 0.005, release: float = 0.1,
                 makeup_db: float = 0.0, knee_db: float = 0.0,
                 sidechain: Optional["Sample"] = None) -> "Sample":
        """Peak compressor / limiter (``ratio=math.inf``): the detector and
        attack smoother are log-depth scans (ops.effects); spec/tolerance:
        goldref.effects.compressor_gains.  Knobs travel in the dyn vector,
        so tweaking them reuses the program.  ``knee_db`` > 0 softens the
        static curve over a knee_db-wide window (0 keeps the hard knee).
        With ``sidechain`` the detector listens to the KEY sample, whose
        own staged chain fuses in as a sub-program (ducking); past the
        key's end the gain releases to 1."""
        alpha, decay = C.compressor_coeffs(self._samplerate, attack, release)
        slope = 1.0 if math.isinf(ratio) else 1.0 - 1.0 / ratio
        makeup = float(np.exp2(np.float32(makeup_db) / np.float32(6.0206)))
        if not 0.0 <= knee_db <= 24.0:
            raise ValueError("compress knee_db must be in [0, 24]")
        has_knee = knee_db > 0.0
        knobs = (threshold_db, slope, alpha, decay, makeup)
        if has_knee:
            knobs = knobs + (knee_db,)
        if sidechain is None:
            self._stage("compress", static=(has_knee,), dyn=knobs)
            return self
        if sidechain._samplerate != self._samplerate:
            raise ValueError("sidechain samplerate mismatch")
        sub_ops, dyn, leaves = sidechain._as_subprogram()
        self._stage("compress_sc",
                    static=(MAXVAL[sidechain._samplewidth], sub_ops,
                            has_knee),
                    dyn=knobs + dyn, leaves=leaves)
        return self

    def reverb(self, roomsize: float = 0.7, damping: float = 0.5,
               wet: float = 0.33, dry: float = 0.7, width: float = 1.0,
               tail: float = 1.5) -> "Sample":
        """Freeverb-style reverb (lag-aligned comb stage, see ops.effects);
        extends the sample by ``tail`` seconds of decay.  Spec/tolerance:
        goldref.effects.reverb.  Knobs are dyn: no new program on a
        tweak."""
        feedback, damp, wet1, wet2 = C.reverb_params(roomsize, damping, wet,
                                                   width)
        tail_frames = self._n(tail)
        static = (self._samplerate, tail_frames)
        dyn = (feedback, damp, wet1, wet2, dry)
        nets = [C.reverb_delays(self._samplerate, ch)
                for ch in range(min(self._nchannels, 2))]
        if dfx.whole_reverb_route(self._nframes + tail_frames,
                                  nets) == "one":
            self._stage("reverb", static=static, dyn=dyn)
        else:
            # a longer comb stage replays programs of its own
            # (ops.effects._reverb_networks_whole), which no chain's
            # program can hold: it runs after the staged chain
            self._base = _x_reverb(self._materialize(), static, dyn, ())
        self._nframes += tail_frames
        return self

    def chorus(self, rate: float = 0.5, depth: float = 0.002,
               delay: float = 0.02, voices: int = 3, wet: float = 0.4,
               dry: float = 1.0) -> "Sample":
        """Multi-voice chorus (LFO-modulated fractional delays).
        Spec/tolerance: goldref.effects.chorus.  ``rate``, ``depth`` and
        ``delay`` are static (the LFO's DDS increment needs the host's
        exact f64 round), wet/dry dyn."""
        self._stage("chorus", static=(self._samplerate, float(rate),
                                      float(depth), float(delay),
                                      int(voices)),
                    dyn=(wet, dry))
        return self

    def filter(self, kind: str, cutoff: float, q: float = 0.7071,
               gain_db: float = 0.0) -> "Sample":
        """Resonant RBJ biquad on the PCM (parallel companion-matrix scan —
        ops.effects.companion_scan); spec/tolerance:
        goldref.effects.biquad_filter.  Kinds: lowpass/highpass/bandpass,
        plus the gain kinds lowshelf/highshelf/peaking (``gain_db``).
        Coefficients travel in the dyn vector."""
        if kind in ("lowshelf", "highshelf", "peaking"):
            coeffs = C.eq_band_coeffs(kind, cutoff, gain_db, q,
                                    self._samplerate)
        else:
            coeffs = C.biquad_coeffs(kind, cutoff, q, self._samplerate)
        self._stage_biquad(coeffs)
        return self

    def _stage_biquad(self, coeffs) -> None:
        """One biquad, routed by conditioning: coefficient sets with
        near-unit poles (ops.coeffs.wants_ff_scan) run the float-float scan
        with (hi, lo) coefficient pairs, the rest the plain f32 scan."""
        if C.wants_ff_scan(coeffs):
            self._stage("biquad_ff",
                        dyn=tuple(float(v) for c in coeffs
                                  for v in C.ff_split(c)))
        else:
            self._stage("biquad", dyn=coeffs)

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
                self._stage_biquad(C.eq_band_coeffs(kind, f, g, q,
                                                    self._samplerate))
        return self

    def loudness_lufs(self) -> float:
        """Integrated programme loudness (LUFS, ITU-R BS.1770-4):
        K-weighted hop energies on the device, the two-stage gate on the
        host (ops/loudness.py).  -inf for silence or programmes shorter
        than one 400 ms block.  Spec/tolerance:
        goldref.effects.loudness_lufs."""
        return dl.loudness_integrated(self._materialize(), self._samplerate)

    def loudness_stats(self) -> dict:
        """The EBU R128 meter set in one pass: ``integrated`` (LUFS),
        ``lra`` (LU), ``momentary_max`` and ``short_term_max`` (LUFS).
        Spec/tolerance: goldref.effects.loudness_stats."""
        return dl.loudness_stats(self._materialize(), self._samplerate)

    def true_peak_dbtp(self) -> float:
        """True peak (dBTP, BS.1770-4 Annex 2, 4x polyphase oversampling);
        -inf for silence.  Spec/tolerance: goldref.effects.true_peak_dbtp."""
        tp = dl.true_peak_norm(self._materialize())
        return float("-inf") if tp <= 0.0 else 20.0 * math.log10(tp)

    def normalize_lufs(self, target_lufs: float = -14.0,
                       true_peak_db: float = -1.0) -> "Sample":
        """Loudness-normalize to a target (default -14 LUFS): gain = target
        - measured, capped so that the true peak stays <= ``true_peak_db``
        dBTP, staged as one ``amplify``.  Silence is returned unchanged."""
        li = dl.loudness_integrated(self._materialize(), self._samplerate)
        if not math.isfinite(li):
            return self
        gain_db = target_lufs - li
        tp = dl.true_peak_norm(self._materialize())
        if tp > 0.0:
            gain_db = min(gain_db, true_peak_db - 20.0 * math.log10(tp))
        return self.amplify(float(10.0 ** (gain_db / 20.0)))

    def gate(self, threshold_db: float = -50.0, range_db: float = 80.0,
             attack: float = 0.001, release: float = 0.05) -> "Sample":
        """Noise gate (decaying-max detector + one-pole smoother as
        parallel scans); spec/tolerance: goldref.effects.gate_gains."""
        alpha, decay, floor_gain = C.gate_coeffs(self._samplerate, attack,
                                               release, range_db)
        self._stage("gate", dyn=(threshold_db, floor_gain, alpha, decay))
        return self

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
        self._stage("fb_echo", static=(D, tail_frames),
                    dyn=(feedback, wet, dry))
        self._nframes += tail_frames
        return self

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
        P = C.static_phase(int(start_frame), self._nframes, self._samplerate,
                         rate)
        self._stage("tremolo",
                    leaves=(self._lfo_grid(C.tremolo_gain_grid(P, depth)),))
        return self

    def autopan(self, rate: float = 0.5, depth: float = 1.0,
                start_frame: int = 0) -> "Sample":
        """LFO auto-panner: per-frame pan positions depth*sin through the
        house equal-gain pan law, derived on the host at absolute frames
        (ops.coeffs.autopan_pan_grid).  Stereo only.  Spec/budget:
        goldref.effects.autopan."""
        if self._nchannels != 2:
            raise ValueError("autopan needs a stereo sample")
        if not 0.0 <= depth <= 1.0:
            raise ValueError("autopan depth must be in [0, 1]")
        if not 0.0 < rate <= 20.0:
            raise ValueError("autopan rate must be in (0, 20] Hz")
        P = C.static_phase(int(start_frame), self._nframes, self._samplerate,
                         rate)
        self._stage("autopan",
                    leaves=(self._lfo_grid(C.autopan_pan_grid(P, depth)),))
        return self

    def stereo_width(self, amount: float) -> "Sample":
        """Mid/side stereo-width control (0 = mono, 1 = unity, up to 4 =
        wider).  Spec/budget: goldref.effects.stereo_width."""
        if self._nchannels != 2:
            raise ValueError("stereo_width needs a stereo sample")
        if not 0.0 <= amount <= 4.0:
            raise ValueError("width amount must be in [0, 4]")
        self._stage("width", dyn=(amount,))
        return self

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
        self._stage("limit", static=(self._samplerate, L, cint),
                    dyn=(ceiling_db, decay))
        return self

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
        grids = C.phaser_coeff_grids(
            0, self._nframes, self._samplerate, rate, depth, min_freq,
            max_freq, q, dtype=np.float64 if ff else np.float32)
        if ff:
            leaves = tuple(self._lfo_grid(part) for g in grids
                           for part in C.ff_split(g))
        else:
            leaves = tuple(self._lfo_grid(g) for g in grids)
        self._stage("phaser", static=(int(stages), ff), dyn=(wet, dry),
                    leaves=leaves)
        return self

    def convolve(self, ir: "Sample", wet: float = 1.0,
                 dry: float = 0.0) -> "Sample":
        """Convolve with an impulse-response sample (f32 FFT product; a
        mono IR applies to all channels); extends by len(ir)-1 frames.  The
        IR's own staged chain fuses in as a sub-program.  Spec/tolerance:
        goldref.effects.convolve."""
        if ir._samplerate != self._samplerate:
            raise ValueError("impulse response samplerate mismatch")
        if ir._nchannels not in (1, self._nchannels):
            raise ValueError("impulse response channel mismatch")
        if ir._nframes == 0:
            raise ValueError("empty impulse response")
        sub_ops, dyn, leaves = ir._as_subprogram()
        self._stage("convolve", static=(MAXVAL[ir._samplewidth], sub_ops),
                    dyn=(wet, dry) + dyn, leaves=leaves)
        self._nframes += ir._nframes - 1
        return self

    def granulate(self, duration: float, grain: float = 0.05,
                  density: float = 25.0, jitter: float = 0.02,
                  amplitude: float = 0.7, seed: int = 0) -> "Sample":
        """Granular resynthesis onto a ``duration``-second canvas (one
        gather, the grains added in a fixed order); spec/tolerance:
        goldref.effects.granulate.  Position/jitter params are static (the
        grain grid is host-computed)."""
        _, _, _, out_len = C.grain_grid(self._nframes, self._samplerate,
                                        float(duration), float(grain),
                                        float(density), float(jitter),
                                        int(seed))
        self._stage("granulate",
                    static=(self._samplerate, float(duration), float(grain),
                            float(density), float(jitter), int(seed)),
                    dyn=(amplitude,))
        self._nframes = out_len
        return self

    def stretch(self, factor: float, frame: int = 2048,
                hop: int = 512) -> "Sample":
        """Phase-vocoder time stretch (duration x factor, pitch kept);
        spec/tolerance: goldref.effects.stretch.  ``factor`` is static (the
        analysis grid is host-computed)."""
        _, target = C.stretch_grid(self._nframes, float(factor), int(frame),
                                   int(hop))
        self._stage("stretch", static=(float(factor), int(frame), int(hop)))
        self._nframes = target
        return self

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
        self._stage("lin2lin" if scale_amplitude else "astype_i32",
                    static=(4,) if scale_amplitude else ())
        self._samplewidth = 4
        return self

    def make_16bit(self, maximize_amplitude: bool = True) -> "Sample":
        if maximize_amplitude:
            self.amplify_max()
        if self._samplewidth != 2:
            self._stage("lin2lin", static=(2,))
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
                     snap: bool = False) -> None:
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
        nout = dresample.nframes_out(self._nframes, M, L)
        self._stage("hq_resample", static=(L, M, nout))
        self._nframes = nout

    def _ratecv(self, inrate: int, outrate: int) -> None:
        g = math.gcd(inrate, outrate)
        inr, outr = inrate // g, outrate // g
        self._stage("ratecv", static=(inr, outr))
        self._nframes = dresample.nframes_out(self._nframes, inr, outr)

    def mono(self, left_factor: float = 1.0, right_factor: float = 1.0) -> "Sample":
        if self._nchannels == 1:
            return self
        self._stage("tomono", dyn=(left_factor, right_factor))
        self._nchannels = 1
        return self

    def stereo(self, left_factor: float = 1.0, right_factor: float = 1.0) -> "Sample":
        if self._nchannels == 2:
            return self
        self._stage("tostereo", dyn=(left_factor, right_factor))
        self._nchannels = 2
        return self

    def stereo_mix(self, other: "Sample", other_channel: str,
                   other_mix_factor: float = 1.0) -> "Sample":
        if other_channel not in ("L", "R") or other._nchannels != 1:
            raise ValueError("stereo_mix needs a mono sample and channel "
                             "'L' or 'R'")
        if self._nchannels == 1:
            self.stereo()
        ch = 0 if other_channel == "L" else 1
        m = min(self._nframes, other._nframes)
        sub_ops, dyn, leaves = other._as_subprogram()
        self._stage("stereo_mix", static=(ch, m, sub_ops),
                    dyn=(other_mix_factor,) + dyn, leaves=leaves)
        return self

    def pan(self, amount: float = 0.0, lfo=None) -> "Sample":
        if self._nchannels == 1:
            self.stereo()
        if lfo is None:
            self._stage("pan_const", dyn=(amount,))
        elif isinstance(lfo, Sample):    # its chain fuses as a sub-program
            sub_ops, dyn, leaves = lfo._as_subprogram()
            self._stage("pan_sample",
                        static=(MAXVAL[lfo._samplewidth], self._nframes,
                                sub_ops),
                        dyn=dyn, leaves=leaves)
        elif hasattr(lfo, "spec"):       # Oscillator: render in the program
            from .models import graph as G
            G.check_inline(lfo.spec)
            self._stage("pan_patch",
                        static=(lfo.spec, self._nframes, lfo.samplerate))
        else:
            self._stage("pan_lfo", leaves=(_modulator_gains(
                lfo, self._nframes, self.device),))
        return self

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
                self._stage("lin2lin", static=(params.norm_samplewidth,))
                self._samplewidth = params.norm_samplewidth
        if self._nchannels == 1 and params.norm_nchannels == 2:
            self.stereo()
        elif self._nchannels == 2 and params.norm_nchannels == 1:
            self.mono()
        return self

    def _check_format(self, other: "Sample") -> None:
        if (other._samplerate, other._samplewidth, other._nchannels) != \
                (self._samplerate, self._samplewidth, self._nchannels):
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
    return _fit(g, n, 1.0)



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
