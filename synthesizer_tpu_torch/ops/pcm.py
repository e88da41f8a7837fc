"""Device PCM primitives (port of ``synthesizer_tpu.ops.pcm``).

PyTorch equivalents of the C ``audioop`` primitives the original's
``sample.py`` delegates all hot PCM arithmetic to.  Numeric contract,
tested against :mod:`goldref.pcm` and the JAX module:

* **Integer ops** (saturating add, wrapping bias, width conversion) are
  bit-exact to audioop.  They stay integer: sums are taken one width up
  (int32 for 8/16-bit data, int64 for 32-bit) and narrowed, so nothing
  relies on what an overflowing add does.
* **Float-factor ops** (mul/amplify, mono/stereo matrixing, gain ramps)
  follow the float32 spec: IEEE-f32 product, ``floor``, clamp.  The
  single-product ops are bit-identical to ``goldref.pcm.*_f32`` and to the
  JAX module; ``to_mono`` (two products and an add, which a compiler may
  contract) is specified to <= 1 LSB.

Tensors are plain integer tensors (int8/int16/int32 for widths 1/2/4), any
shape and device; channel layout is handled by callers.  Scalar factors
may be Python numbers or 0-dim tensors on the data's device (a factor that
was computed on the card never visits the host).
"""

from __future__ import annotations

import numpy as np
import torch

DTYPES = {1: torch.int8, 2: torch.int16, 4: torch.int32}
MINVAL = {1: -(1 << 7), 2: -(1 << 15), 4: -(1 << 31)}
MAXVAL = {1: (1 << 7) - 1, 2: (1 << 15) - 1, 4: (1 << 31) - 1}

_WIDTH_OF = {torch.int8: 1, torch.int16: 2, torch.int32: 4}


def width_of(x) -> int:
    return _WIDTH_OF[x.dtype]


def _f32(v, device) -> torch.Tensor:
    """A factor as an f32 tensor on ``device``, rounded once from what the
    caller gave."""
    if isinstance(v, torch.Tensor):
        return v.to(device=device, dtype=torch.float32)
    return torch.full((), float(np.float32(v)), dtype=torch.float32,
                      device=device)


# ---------------------------------------------------------------------------
# Saturating / wrapping integer arithmetic
# ---------------------------------------------------------------------------

def sat_add(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Element-wise saturating add (audioop.add). a and b share an int dtype."""
    w = width_of(a)
    wide = torch.int32 if w < 4 else torch.int64
    s = a.to(wide) + b.to(wide)
    return torch.clamp(s, MINVAL[w], MAXVAL[w]).to(a.dtype)


def bias_wrap(a: torch.Tensor, b) -> torch.Tensor:
    """Wrapping constant add (audioop.bias — no clamp): the sum wraps in
    the sample's own width, int8 and int16 included."""
    w = width_of(a)
    half = 1 << (8 * w - 1)
    if isinstance(b, torch.Tensor):
        b = b.to(device=a.device, dtype=torch.int64)
    else:
        b = ((int(b) + half) % (2 * half)) - half
    s = a.to(torch.int64) + b
    return (((s + half) & (2 * half - 1)) - half).to(a.dtype)


def lin2lin(a: torch.Tensor, newwidth: int) -> torch.Tensor:
    """Width conversion: widen = left shift, narrow = arithmetic right shift."""
    w = width_of(a)
    if newwidth == w:
        return a
    # a * 2^(32-8w) fills the int32 range exactly: a product, so that no
    # negative value is ever shifted left
    v32 = a.to(torch.int32) * (1 << (32 - 8 * w))
    return (v32 >> (32 - 8 * newwidth)).to(DTYPES[newwidth])


# ---------------------------------------------------------------------------
# Float32-spec scaling ops
# ---------------------------------------------------------------------------

def floor_clamp(v_f32: torch.Tensor, width: int, dtype) -> torch.Tensor:
    v = torch.floor(v_f32)
    if width < 4:
        out = torch.clamp(v, float(MINVAL[width]), float(MAXVAL[width]))
        return out.to(torch.int32).to(dtype)
    # width 4: INT32_MAX is not f32-representable; saturate explicitly, and
    # clip to 2^31 - 128 BEFORE the cast: a float -> int cast of an
    # out-of-range value differs between the CPU and CUDA.  Any f32 in
    # (-2^31, 2^31) is an exact integer after floor.
    hi = 2147483648.0   # 2^31, exactly representable
    inner = torch.clamp(v, -hi, hi - 128).to(torch.int32)
    out = torch.where(v >= hi, MAXVAL[4],
                      torch.where(v < -hi, MINVAL[4], inner))
    return out.to(dtype)


def mul_floor(a: torch.Tensor, factor) -> torch.Tensor:
    """audioop.mul under the f32 spec: floor(f32(a) * f32(factor)), clamp."""
    w = width_of(a)
    prod = a.to(torch.float32) * _f32(factor, a.device)
    return floor_clamp(prod, w, a.dtype)


def gain_apply(a: torch.Tensor, gains: torch.Tensor) -> torch.Tensor:
    """Per-sample gain (fades, envelopes, amplitude modulation, LFO pan):
    floor(f32(a) * f32(gain)), clamp.  ``gains`` broadcasts against ``a``."""
    w = width_of(a)
    prod = a.to(torch.float32) * gains.to(torch.float32)
    return floor_clamp(prod, w, a.dtype)


def to_mono(a: torch.Tensor, lfactor, rfactor) -> torch.Tensor:
    """[n, 2] -> [n, 1]: floor(L*lf + R*rf), clamp (audioop.tomono, f32 spec).

    Two products and an add, each rounded to f32 here; a backend that
    contracts them into an FMA (as XLA may) differs in the last bit, so
    this op is specified to <= 1 LSB of the host oracle rather than
    bit-exact.  Single-product ops (mul_floor/gain_apply/to_stereo) have no
    add to contract and remain bit-exact.
    """
    w = width_of(a)
    af = a.to(torch.float32)
    v = af[..., 0] * _f32(lfactor, a.device) \
        + af[..., 1] * _f32(rfactor, a.device)
    return floor_clamp(v, w, a.dtype)[..., None]


def to_stereo(a: torch.Tensor, lfactor, rfactor) -> torch.Tensor:
    """[n, 1] -> [n, 2]: per-channel floor(v*f), clamp (audioop.tostereo)."""
    w = width_of(a)
    af = a.to(torch.float32)[..., 0]
    l = floor_clamp(af * _f32(lfactor, a.device), w, a.dtype)
    r = floor_clamp(af * _f32(rfactor, a.device), w, a.dtype)
    return torch.stack([l, r], dim=-1)


# ---------------------------------------------------------------------------
# Metering reductions
# ---------------------------------------------------------------------------

def peak(a: torch.Tensor) -> torch.Tensor:
    """max(|x|) saturated to the width's max (audioop.max modulo INT_MIN
    edge), a 0-dim int32 tensor on ``a``'s device."""
    if a.numel() == 0:
        return torch.zeros((), dtype=torch.int32, device=a.device)
    hi = a.max().to(torch.int64)
    neg = -a.min().to(torch.int64)
    return torch.clamp_max(torch.maximum(hi, neg), MAXVAL[4]).to(torch.int32)


def rms_mean_square(a: torch.Tensor) -> torch.Tensor:
    """Mean of squares in f32 (callers take sqrt/int on host for the meter)."""
    af = a.to(torch.float32)
    return torch.mean(af * af)


def vu_levels(a2: torch.Tensor) -> torch.Tensor:
    """One stacked f32 [4] tensor (peak_l, peak_r, ms_l, ms_r) for [n, 2]
    int, so that a metering caller pays one host copy per chunk."""
    l, r = a2[..., 0], a2[..., 1]
    return torch.stack([peak(l).to(torch.float32), peak(r).to(torch.float32),
                        rms_mean_square(l), rms_mean_square(r)])
