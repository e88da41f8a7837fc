"""Port's turn-unit trig (synthesizer_tpu_torch.ops.trig) vs the JAX
reference on the same seeded f32 inputs."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from synthesizer_tpu.ops import trig as jtrig
from synthesizer_tpu_torch.ops import trig as ttrig


@pytest.mark.parametrize("name", ["sin_turns", "cos_turns"])
def test_trig_matches_jax(name):
    x = np.random.default_rng(20).uniform(-4, 4, 100_000).astype(np.float32)
    want = np.asarray(getattr(jtrig, name)(jnp.asarray(x)))
    got = getattr(ttrig, name)(torch.from_numpy(x)).numpy()
    assert got.dtype == np.float32
    # same coefficients and Horner order: only the backends' rounding of
    # the fold can differ, far inside the polynomial's own 7.8e-7 error
    assert np.abs(got - want).max() <= 4e-7


def test_trig_coefficients_are_the_references():
    assert ttrig._C == jtrig._C
    assert all(c.dtype == np.float32 for c in ttrig._C)
