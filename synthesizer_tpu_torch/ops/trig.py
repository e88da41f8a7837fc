"""Fast trig in turn units (no argument reduction), and the exp and log
of the pluck waveform.

Port of ``synthesizer_tpu.ops.trig``: the DDS phase is an exact binary
fraction of a turn, so ``sin(2*pi*x)`` folds x to v = x - rint(x) in
[-0.5, 0.5] and evaluates a minimax odd polynomial (max error 7.8e-7 in
f32).  Same f32 coefficients and Horner order as the reference; the CUDA
kernel (``csrc/voicebank_render.cu``) carries the same constants.

``exp_f32`` and ``log_f32`` are f32 polynomials in a fixed order of
separately rounded multiplies and adds, which the kernel carries too: the
libraries' expf/logf/cosf differ in the last bit between the CPU and the
card, so a voice bank with pluck voices would otherwise render 1 LSB apart
on the two devices.  Each is within a few f32 ulps of the exact function.
"""

from __future__ import annotations

import math

import numpy as np
import torch

_C = tuple(np.float32(c) for c in (
    6.2831852587e+00, -4.1341695438e+01, 8.1604970593e+01,
    -7.6700787441e+01, 4.2010936730e+01, -1.4851475811e+01,
    3.1781489795e+00,
))


def sin_turns(x: torch.Tensor) -> torch.Tensor:
    """sin(2*pi*x) for f32 x in turns (any magnitude; folded mod 1)."""
    v = x - torch.round(x)          # round-half-even, like jnp.rint
    v2 = v * v
    acc = torch.full_like(v, float(_C[-1]))
    for c in _C[-2::-1]:
        acc = acc * v2 + float(c)
    return acc * v


def cos_turns(x: torch.Tensor) -> torch.Tensor:
    """cos(2*pi*x) = sin(2*pi*(x + 0.25))."""
    return sin_turns(x + 0.25)


#: 2^f on [-0.5, 0.5]: the Taylor coefficients (ln 2)^k / k!, k = 7..0
_E = tuple(np.float32(math.log(2.0) ** k / math.factorial(k))
           for k in range(7, -1, -1))
_LOG2E = float(np.float32(1.0 / math.log(2.0)))
#: ln 2 split so that e * _LN2_HI is exact for |e| < 2^12
_LN2_HI = float(np.float32(0.693145751953125))
_LN2_LO = float(np.float32(math.log(2.0) - 0.693145751953125))
_SQRT_HALF = float(np.float32(math.sqrt(0.5)))


def exp_f32(x: torch.Tensor) -> torch.Tensor:
    """e^x for f32 x: t = x*log2(e), 2^(t - rint(t)) by a degree-7
    polynomial, scaled by 2^rint(t) through the exponent bits; 0 for
    t < -125 and +inf for t > 128."""
    t = x * _LOG2E
    nf = torch.round(t)
    f = t - nf
    acc = torch.full_like(f, float(_E[0]))
    for c in _E[1:]:
        acc = acc * f + float(c)
    e = nf.clamp(-125.0, 127.0).to(torch.int32)
    scale = ((e + 127) << 23).view(torch.float32)
    out = torch.where(t < -125.0, torch.zeros_like(acc), acc * scale)
    return torch.where(t > 128.0, torch.full_like(acc, math.inf), out)


def log_f32(x: torch.Tensor) -> torch.Tensor:
    """ln(x) for positive normal f32 x: x = m * 2^e with m in [sqrt(1/2),
    sqrt(2)), s = (m-1)/(m+1), ln m = 2s(1 + z/3 + ... + z^5/11) with z =
    s*s, then + e*ln 2 in two parts."""
    m, e = torch.frexp(x)                       # m in [0.5, 1)
    low = m < _SQRT_HALF
    m = torch.where(low, m * 2.0, m)
    e = torch.where(low, e - 1, e).to(torch.float32)
    s = (m - 1.0) / (m + 1.0)
    z = s * s
    acc = torch.full_like(z, float(np.float32(1.0 / 11.0)))
    for k in (9, 7, 5, 3):
        acc = acc * z + float(np.float32(1.0 / k))
    acc = acc * z + 1.0
    r = (s * 2.0) * acc
    return (r + e * _LN2_LO) + e * _LN2_HI
