"""Where the port's tensors live, and how a result crosses to the host.

``resolve`` turns the ``device=`` argument of an entry point into a
``torch.device``; the default of every entry point is the card, and without
one a call raises rather than run on the CPU unasked.

``to_host`` is the one device -> host copy of the port.  A CUDA tensor is
copied into *pinned* host memory (``copy_(non_blocking=True)``, then the
stream is synchronised): a copy to pageable memory goes through the CUDA
runtime's staging buffer at a fraction of the link's rate.  The buffer
comes from PyTorch's caching pinned allocator unless the caller passes one
to reuse (``out=``); allocating pinned memory can cost more than the copy
saves, so a caller that renders repeatedly allocates once.  If pinning
fails the call raises: nothing falls back to a pageable copy.
"""

from __future__ import annotations

import numpy as np
import torch

from . import profiling


def resolve(device) -> torch.device:
    """``device`` as a torch.device.  The port's entry points default to the
    card; without one they raise rather than run on the CPU unasked."""
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("no CUDA device: pass device='cpu' to run on "
                           "the CPU")
    return dev


def pinned_like(t: torch.Tensor) -> torch.Tensor:
    """An uninitialised pinned host tensor of ``t``'s shape and dtype."""
    return torch.empty(t.shape, dtype=t.dtype, device="cpu", pin_memory=True)


@profiling.spanned("device.to_host")
def to_host(t: torch.Tensor, out: torch.Tensor = None) -> np.ndarray:
    """``t`` as a numpy array on the host.

    A CPU tensor is viewed in place (the device the caller asked for, not a
    fallback).  A CUDA tensor is copied into ``out`` (a pinned host tensor
    of the same shape and dtype) or into a fresh pinned buffer, and the
    returned array is a view of that buffer, which it keeps alive."""
    if t.device.type == "cpu":
        if out is not None:
            out.copy_(t)
            return out.numpy()
        return t.detach().contiguous().numpy()
    if out is None:
        out = pinned_like(t)
    else:
        if out.device.type != "cpu" or not out.is_pinned():
            raise ValueError("out= must be a pinned host tensor")
        if out.shape != t.shape or out.dtype != t.dtype:
            raise ValueError(
                f"out= is {tuple(out.shape)} {out.dtype}, the frames are "
                f"{tuple(t.shape)} {t.dtype}")
    out.copy_(t, non_blocking=True)
    with profiling.span("device.wait"):
        torch.cuda.current_stream(t.device).synchronize()
    return out.numpy()
