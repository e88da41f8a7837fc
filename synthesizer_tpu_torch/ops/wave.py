"""Waveform primitives shared by the voice bank and the patch graph.

Both evaluators (``models.voicebank.render_block`` and
``models.graph.lower``) compute the same waveforms from the same 32-bit
DDS phase, so the formulas live once, here.

u32 on the CPU: PyTorch has no ``+``, ``>>``, ``<`` or ``//`` for
``uint32`` there, so u32 quantities are int64 tensors in [0, 2^32),
masked with ``& U32`` after every add and multiply.  A product of two such
values can overflow int64; only its low 32 bits are kept, and those
survive the two's-complement wrap.  Mask before every ``>>`` so that the
shift is logical.  int64 -> f32 rounds like the reference's u32 -> f32.

Division by a constant: PyTorch on CUDA multiplies by the reciprocal when
the divisor is a Python number, which is not the correctly rounded
quotient.  ``div`` divides by a 0-dim tensor on the device instead, so
the CPU and the card agree bit for bit.
"""

from __future__ import annotations

import math

import numpy as np
import torch

from ..utils.program import constant

TWO_NEG32 = float(np.float32(2.0 ** -32))
U32 = 0xFFFFFFFF


def scalar(value, device) -> torch.Tensor:
    """``value`` rounded to f32 as a 0-dim tensor on ``device`` (a fill,
    not a host -> device copy)."""
    return torch.full((), float(np.float32(value)), dtype=torch.float32,
                      device=device)


def div(x: torch.Tensor, c) -> torch.Tensor:
    """x / f32(c), correctly rounded on every device; ``c`` may also be an
    f32 tensor on ``x``'s device (a program's device scalar)."""
    if isinstance(c, torch.Tensor):
        return x / c
    return x / scalar(c, x.device)


#: jnp.interp's guard against a zero-width breakpoint interval:
#: np.spacing(np.finfo(f32).eps)
_INTERP_EPS = float(np.spacing(np.finfo(np.float32).eps))


def fma_f32(a: torch.Tensor, b: torch.Tensor, c: torch.Tensor) -> torch.Tensor:
    """a * b + c for f32 tensors with ONE rounding, as a fused multiply-add
    computes it, on every device.  The product of two f32 values is exact
    in f64; the f64 sum rounds once more, and where that sum lands exactly
    on the midpoint of two f32 neighbours its exact error (TwoSum) decides
    the direction, so the result is the correctly rounded f32 of the exact
    a*b + c."""
    p = a.to(torch.float64) * b.to(torch.float64)
    c64 = c.to(torch.float64)
    s = p + c64
    bb = s - p
    err = (p - (s - bb)) + (c64 - bb)
    r = s.to(torch.float32)
    r64 = r.to(torch.float64)
    hi = torch.nextafter(r, torch.full_like(r, math.inf)).to(torch.float64)
    lo = torch.nextafter(r, torch.full_like(r, -math.inf)).to(torch.float64)
    up = (s == (r64 + hi) * 0.5) & (err > 0)
    down = (s == (r64 + lo) * 0.5) & (err < 0)
    return torch.where(up, hi, torch.where(down, lo, r64)).to(torch.float32)


def interp(x: torch.Tensor, xp, fp) -> torch.Tensor:
    """``jnp.interp(x, xp, fp)`` in f32, bit for bit with the JAX package on
    the CPU: the interval from a right-sided search, ``fp[i-1] + (delta /
    dx) * df`` with XLA's contraction of the last multiply and add into one
    fused multiply-add (``fma_f32``), ``fp[i-1]`` where the interval is
    narrower than the guard, and the end values held outside ``[xp[0],
    xp[-1]]``.  ``xp`` and ``fp`` are 1-D breakpoints (host lists or
    arrays, or f32 tensors on ``x``'s device), ``x`` an f32 tensor."""
    if not isinstance(xp, torch.Tensor):
        xp = constant(np.asarray(xp, np.float32), x.device)
    if not isinstance(fp, torch.Tensor):
        fp = constant(np.asarray(fp, np.float32), x.device)
    if xp.ndim != 1 or xp.shape != fp.shape or xp.shape[0] == 0:
        raise ValueError("xp and fp must be one-dimensional arrays of equal "
                         "size")
    if xp.shape[0] == 1:
        return fp[0].expand(x.shape).clone()
    i = torch.searchsorted(xp, x.contiguous(), right=True).clamp(
        1, xp.shape[0] - 1)
    lo_x, lo_f = xp[i - 1], fp[i - 1]
    df = fp[i] - lo_f
    dx = xp[i] - lo_x
    delta = x - lo_x
    dx0 = torch.abs(dx) <= _INTERP_EPS
    q = delta / torch.where(dx0, torch.ones_like(dx), dx)
    f = torch.where(dx0, lo_f, fma_f32(q, df, lo_f))
    f = torch.where(x < xp[0], fp[0], f)
    return torch.where(x > xp[-1], fp[-1], f)


def phase_x(p: torch.Tensor) -> torch.Tensor:
    return p.to(torch.float32) * TWO_NEG32


def f32_to_i32(x: torch.Tensor) -> torch.Tensor:
    """f32 -> i32 truncating toward zero and saturating at the i32 range,
    as XLA converts (a plain ``.to(torch.int32)`` wraps out-of-range
    values on the CPU).  Returned as int64."""
    return x.to(torch.int64).clamp(-2 ** 31, 2 ** 31 - 1)


def sqrt_f32(x: torch.Tensor) -> torch.Tensor:
    """Correctly rounded f32 sqrt on every device.  PyTorch's vectorized
    f32 sqrt on the CPU is not (it differs in the last bit on about 0.5%
    of inputs); the f64 square root rounded once to f32 is, and matches
    CUDA's sqrtf."""
    return torch.sqrt(x.to(torch.float64)).to(torch.float32)


def triangle(x):
    return torch.where(x < 0.25, 4.0 * x,
                       torch.where(x < 0.75, 2.0 - 4.0 * x, 4.0 * x - 4.0))


def semicircle(x):
    y_up = 4.0 * x - 1.0
    y_dn = 4.0 * x - 3.0
    up = sqrt_f32(torch.clamp_min(1.0 - y_up * y_up, 0.0))
    dn = -sqrt_f32(torch.clamp_min(1.0 - y_dn * y_dn, 0.0))
    return torch.where(x < 0.5, up, dn)


def noise_u32(idx, seed):
    """Counter hash (u32).  ``idx`` is a u32 tensor; ``seed`` a u32 value
    (Python int or tensor) that broadcasts against it."""
    x = (idx * 0x9E3779B9 + seed) & U32
    x = x ^ (x >> 16)
    x = (x * 0x7FEB352D) & U32
    x = x ^ (x >> 15)
    x = (x * 0x846CA68B) & U32
    return x ^ (x >> 16)


def noise_values(idx, seed):
    x = noise_u32(idx, seed)
    return (x >> 8).to(torch.float32) * float(2.0 ** -23) - 1.0


def blep(t, dt):
    """polyBLEP residual (formula: goldref.osc.poly_blep).  ``dt`` is an
    f32 tensor (0-dim or broadcastable), never a Python number: see
    ``div``."""
    u0 = t / dt
    lo = (u0 + u0) - u0 * u0 - 1.0
    u1 = (t - 1.0) / dt
    hi = u1 * u1 + (u1 + u1) + 1.0
    return torch.where(t < dt, lo,
                       torch.where(t > 1.0 - dt, hi, torch.zeros_like(t)))
