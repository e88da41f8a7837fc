"""The check that nothing of JAX or of the JAX package is loaded."""

from __future__ import annotations

import sys

#: top-level module names that a run may not hold
FORBIDDEN = ("jax", "jaxlib", "flax", "synthesizer_tpu")


def forbidden_modules(modules=None) -> list:
    """The loaded modules whose top-level name (the part before the first
    dot, compared whole) is forbidden."""
    mods = sys.modules if modules is None else modules
    return sorted(m for m in list(mods) if m.split(".")[0] in FORBIDDEN)
