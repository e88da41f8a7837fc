"""Device effects primitives (port of ``synthesizer_tpu.ops.effects``).

Only the two helpers the patch graph needs are here so far: the parallel
companion-matrix IIR scan and the house quantization.  The effects rack
itself (dynamics, reverb, chorus, convolution, ...) is not ported yet.
"""

from __future__ import annotations

import torch

from . import pcm as dpcm

MAXVAL = dpcm.MAXVAL
MINVAL = dpcm.MINVAL


def to_int_samples(values: torch.Tensor, width: int) -> torch.Tensor:
    """House synthesis quantization clip(rint(f32(v*maxval))), rounding
    half to even — the same formula as ``models.graph.to_int_device``."""
    v = torch.round(values * float(MAXVAL[width]))
    if width == 4:
        # clip before the cast: see ops.pcm.floor_clamp
        hi = 2147483648.0
        inner = torch.clamp(v, -hi, hi - 128).to(torch.int32)
        return torch.where(v >= hi, MAXVAL[4],
                           torch.where(v < -hi, MINVAL[4], inner))
    return torch.clamp(v, float(MINVAL[width]),
                       float(MAXVAL[width])).to(torch.int32).to(
                           dpcm.DTYPES[width])


def _compose(l, r):
    """The affine map l followed by r: (Mr Ml, Mr cl + cr).  2x2 products
    as elementwise f32 multiplies and adds — no matmul, so TF32 can never
    touch the recurrence.  M [n, 2, 2], c [n, 2]."""
    (Ml, cl), (Mr, cr) = l, r
    M = Mr[:, :, 0:1] * Ml[:, 0:1, :] + Mr[:, :, 1:2] * Ml[:, 1:2, :]
    c = Mr[:, :, 0] * cl[:, 0:1] + Mr[:, :, 1] * cl[:, 1:2] + cr
    return M, c


def _interleave(even: torch.Tensor, odd: torch.Tensor) -> torch.Tensor:
    """even[0], odd[0], even[1], odd[1], ... (even is as long as odd or one
    longer)."""
    n = even.shape[0] + odd.shape[0]
    out = torch.empty((n,) + even.shape[1:], dtype=even.dtype,
                      device=even.device)
    out[0::2] = even
    out[1::2] = odd
    return out


def _affine_prefix(M: torch.Tensor, c: torch.Tensor):
    """Inclusive scan of affine maps under ``_compose``, log-depth and
    work-efficient: combine adjacent pairs, scan the half-length sequence
    recursively, and fill in the elements between.  The grouping is that of
    ``jax.lax.associative_scan``, so the f32 rounding takes the same path
    as the reference's scan."""
    n = M.shape[0]
    if n < 2:
        return M, c
    reduced = _compose((M[0:-1:2], c[0:-1:2]), (M[1::2], c[1::2]))
    odd = _affine_prefix(*reduced)
    if n % 2 == 0:
        left = (odd[0][:-1], odd[1][:-1])
    else:
        left = odd
    even = _compose(left, (M[2::2], c[2::2]))
    return (_interleave(torch.cat([M[0:1], even[0]]), odd[0]),
            _interleave(torch.cat([c[0:1], even[1]]), odd[1]))


def companion_scan(u: torch.Tensor, a1, a2, y1, y2) -> torch.Tensor:
    """y_n = u_n - a1_n y_{n-1} - a2_n y_{n-2} as a PARALLEL affine scan
    over 2x2 companion matrices: log2(B) levels, each a handful of
    elementwise launches over a half-length sequence, instead of a
    per-sample loop.  ``a1``/``a2`` may be scalars (constant-coefficient
    biquads) or [B] tensors (swept filters); ``y1``/``y2`` carry state
    across blocks (numbers or 0-dim tensors).

    The one approximate primitive of the graph: the f32 rounding depends on
    how the scan groups its products, so the result agrees with the
    sequential f64 recurrence within the budgets of the reference's filter
    tests (a few LSB at 16 bit, more as the poles approach the unit
    circle), not bit for bit, and block-size invariance holds to the same
    tolerance."""
    dev = u.device
    ones = torch.ones_like(u)
    zeros = torch.zeros_like(u)
    a1 = torch.as_tensor(a1, dtype=torch.float32, device=dev)
    a2 = torch.as_tensor(a2, dtype=torch.float32, device=dev)
    row0 = torch.stack([-a1 * ones, -a2 * ones], dim=-1)      # [B, 2]
    row1 = torch.stack([ones, zeros], dim=-1)
    M = torch.stack([row0, row1], dim=-2)                     # [B, 2, 2]
    c = torch.stack([u, zeros], dim=-1)                       # [B, 2]
    M, c = _affine_prefix(M, c)
    y1 = torch.as_tensor(y1, dtype=torch.float32, device=dev)
    y2 = torch.as_tensor(y2, dtype=torch.float32, device=dev)
    return M[:, 0, 0] * y1 + M[:, 0, 1] * y2 + c[:, 0]
