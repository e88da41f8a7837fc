"""Fast trig in turn units (no argument reduction).

Port of ``synthesizer_tpu.ops.trig``: the DDS phase is an exact binary
fraction of a turn, so ``sin(2*pi*x)`` folds x to v = x - rint(x) in
[-0.5, 0.5] and evaluates a minimax odd polynomial (max error 7.8e-7 in
f32).  Same f32 coefficients and Horner order as the reference; the CUDA
kernel (``csrc/voicebank_render.cu``) carries the same constants.
"""

from __future__ import annotations

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
