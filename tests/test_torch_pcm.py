"""The port's PCM primitives (``synthesizer_tpu_torch.ops.pcm``) against the
JAX module (``synthesizer_tpu.ops.pcm``) and the numpy oracle
(``goldref.pcm``), on the CPU.

The same seeded inputs, extremes included, go through both packages.
Tolerances: the integer ops and the single-product float ops are
bit-exact; ``to_mono`` (two products and an add, which XLA may contract to
an FMA) is within 1 LSB, which at width 4 is one f32 ulp at the top of the
int32 range (256); ``rms_mean_square`` (an f32 mean whose order of
summation differs) is within a relative 1e-6.
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

import goldref.pcm as gp
from synthesizer_tpu.ops import pcm as J
from synthesizer_tpu_torch.ops import pcm as T

torch.set_num_threads(2)

NPDT = {1: np.int8, 2: np.int16, 4: np.int32}
WIDTHS = (1, 2, 4)
FACTORS = (0.0, 1.0, -1.0, 0.5, 0.3333, -0.75, 1.7, 2.5, 1e-3, 100.0, -3.0e9)


def _data(width, n=4096, seed=0):
    """Seeded samples of one width, with every extreme in them."""
    rng = np.random.default_rng(seed + width)
    lo, hi = T.MINVAL[width], T.MAXVAL[width]
    a = rng.integers(lo, hi + 1, size=n, dtype=np.int64)
    a[:8] = [lo, hi, -1, 0, 1, lo + 1, hi - 1, lo // 2]
    return a.astype(NPDT[width])


def _t(a):
    return torch.from_numpy(np.ascontiguousarray(a))


def _same(got: torch.Tensor, want):
    want = np.asarray(want)
    assert got.numpy().dtype == want.dtype
    assert got.shape == want.shape
    np.testing.assert_array_equal(got.numpy(), want)


@pytest.mark.parametrize("width", WIDTHS)
def test_width_of_and_tables(width):
    a = _data(width)
    assert T.width_of(_t(a)) == J.width_of(jnp.asarray(a)) == width
    assert T.MINVAL == J.MINVAL and T.MAXVAL == J.MAXVAL
    assert T.DTYPES[width] == _t(a).dtype


@pytest.mark.parametrize("width", WIDTHS)
def test_sat_add(width):
    a, b = _data(width, seed=1), _data(width, seed=2)
    # every pair of extremes meets: overflow in both directions
    ext = np.array([T.MINVAL[width], T.MAXVAL[width], -1, 0, 1],
                   NPDT[width])
    a[8:33], b[8:33] = np.repeat(ext, 5), np.tile(ext, 5)
    got = T.sat_add(_t(a), _t(b))
    _same(got, J.sat_add(jnp.asarray(a), jnp.asarray(b)))
    want = gp.frombytes(gp.add(a.tobytes(), b.tobytes(), width), width)
    np.testing.assert_array_equal(got.numpy(), want)


@pytest.mark.parametrize("bias", [0, 1, -1, 100, -100, 127, 128, 32767,
                                  -32768, 40000, 2 ** 31 - 1, -2 ** 31])
@pytest.mark.parametrize("width", WIDTHS)
def test_bias_wrap(width, bias):
    a = _data(width, seed=3)
    got = T.bias_wrap(_t(a), bias)
    # the sample layer wraps the amount into the width before the add
    b = np.asarray(bias).astype(NPDT[width])
    _same(got, J.bias_wrap(jnp.asarray(a), b))
    want = gp.frombytes(gp.bias(a.tobytes(), width, int(b)), width)
    np.testing.assert_array_equal(got.numpy(), want)


@pytest.mark.parametrize("new", WIDTHS)
@pytest.mark.parametrize("width", WIDTHS)
def test_lin2lin(width, new):
    a = _data(width, seed=4)
    got = T.lin2lin(_t(a), new)
    _same(got, J.lin2lin(jnp.asarray(a), new))
    want = gp.frombytes(gp.lin2lin(a.tobytes(), width, new), new)
    np.testing.assert_array_equal(got.numpy(), want)
    # MINVAL, MAXVAL, -1 and 0 by hand: widen = shift left, narrow = floor
    shift = 8 * (new - width)
    for v, g in zip(a[:4].astype(np.int64), got.numpy()[:4]):
        assert int(g) == (v << shift if shift >= 0 else v >> -shift)


@pytest.mark.parametrize("width", WIDTHS)
def test_floor_clamp(width):
    lo, hi = float(T.MINVAL[width]), float(T.MAXVAL[width])
    v = np.array([0.0, -0.5, 0.5, -1.0, 1.5, lo, hi, lo - 1.0, hi + 1.0,
                  lo * 4, hi * 4, 2147483520.0, 2147483648.0, -2147483648.0,
                  -2147483904.0, 3.0e9, -3.0e9, 1e20, -1e20, 126.99, -128.01],
                 np.float32)
    got = T.floor_clamp(_t(v), width, T.DTYPES[width])
    _same(got, J.floor_clamp(jnp.asarray(v), width, J.DTYPES[width]))
    want = np.clip(np.floor(v.astype(np.float64)), lo, hi)
    np.testing.assert_array_equal(got.numpy().astype(np.float64), want)


@pytest.mark.parametrize("factor", FACTORS)
@pytest.mark.parametrize("width", WIDTHS)
def test_mul_floor(width, factor):
    a = _data(width, seed=5)
    got = T.mul_floor(_t(a), factor)
    _same(got, J.mul_floor(jnp.asarray(a), factor))
    want = gp.frombytes(gp.mul_f32(a.tobytes(), width, factor), width)
    np.testing.assert_array_equal(got.numpy(), want)
    # a factor that lives on the device gives the same bits
    _same(T.mul_floor(_t(a), torch.tensor(factor, dtype=torch.float32)),
          want)


@pytest.mark.parametrize("width", WIDTHS)
def test_gain_apply(width):
    a = _data(width, seed=6).reshape(-1, 2)
    rng = np.random.default_rng(60 + width)
    g = rng.uniform(-2.0, 2.0, size=(a.shape[0], 1)).astype(np.float32)
    got = T.gain_apply(_t(a), _t(g))
    _same(got, J.gain_apply(jnp.asarray(a), jnp.asarray(g)))
    prod = a.astype(np.float32) * g
    want = np.clip(np.floor(prod.astype(np.float64)), T.MINVAL[width],
                   T.MAXVAL[width])
    np.testing.assert_array_equal(got.numpy().astype(np.float64), want)


@pytest.mark.parametrize("lf,rf", [(1.0, 1.0), (0.5, 0.5), (0.3, 0.9),
                                   (-1.0, 0.25), (1.7, 1.7)])
@pytest.mark.parametrize("width", WIDTHS)
def test_to_mono_within_one_lsb(width, lf, rf):
    a = _data(width, seed=7).reshape(-1, 2)
    got = T.to_mono(_t(a), lf, rf)
    ref = np.asarray(J.to_mono(jnp.asarray(a), lf, rf))
    assert got.shape == ref.shape and got.numpy().dtype == ref.dtype
    gold = gp.frombytes(gp.tomono_f32(a.tobytes(), width, lf, rf),
                        width)[:, None]
    g = got.numpy().astype(np.int64)
    tol = 1 if width <= 2 else 256      # one f32 ulp below 2^31
    assert np.abs(g - ref.astype(np.int64)).max() <= tol
    assert np.abs(g - gold.astype(np.int64)).max() <= tol


@pytest.mark.parametrize("lf,rf", [(1.0, 1.0), (0.5, 0.25), (-0.7, 1.3)])
@pytest.mark.parametrize("width", WIDTHS)
def test_to_stereo(width, lf, rf):
    a = _data(width, seed=8)[:, None]
    got = T.to_stereo(_t(a), lf, rf)
    _same(got, J.to_stereo(jnp.asarray(a), lf, rf))
    want = gp.frombytes(gp.tostereo_f32(a.tobytes(), width, lf, rf),
                        width).reshape(-1, 2)
    np.testing.assert_array_equal(got.numpy(), want)


@pytest.mark.parametrize("case", ["random", "minval", "small", "empty"])
@pytest.mark.parametrize("width", WIDTHS)
def test_peak(width, case):
    a = _data(width, seed=9)
    if case == "minval":
        a = np.full(16, T.MINVAL[width], NPDT[width])
    elif case == "small":
        a = np.array([3, -7, 5], NPDT[width])
    elif case == "empty":
        a = a[:0]
    got = T.peak(_t(a))
    want = J.peak(jnp.asarray(a))
    assert got.dtype == torch.int32 and got.ndim == 0
    assert int(got) == int(want)


@pytest.mark.parametrize("width", WIDTHS)
def test_rms_mean_square(width):
    a = _data(width, seed=10)
    got = float(T.rms_mean_square(_t(a)))
    want = float(J.rms_mean_square(jnp.asarray(a)))
    exact = float(np.mean(a.astype(np.float64) ** 2))
    assert got == pytest.approx(want, rel=1e-6)
    assert got == pytest.approx(exact, rel=1e-6)


@pytest.mark.parametrize("width", WIDTHS)
def test_vu_levels(width):
    a = _data(width, seed=11).reshape(-1, 2)
    got = T.vu_levels(_t(a))
    want = np.asarray(J.vu_levels(jnp.asarray(a)))
    assert got.shape == (4,) and got.dtype == torch.float32
    np.testing.assert_array_equal(got.numpy()[:2], want[:2])
    np.testing.assert_allclose(got.numpy()[2:], want[2:], rtol=1e-6)


def test_ops_do_not_write_their_inputs():
    a = _data(2, seed=12).reshape(-1, 2)
    t = _t(a.copy())
    T.sat_add(t, t), T.bias_wrap(t, 5), T.lin2lin(t, 4), T.mul_floor(t, 0.5)
    T.gain_apply(t, torch.full((t.shape[0], 1), 0.5)), T.to_mono(t, 1.0, 1.0)
    np.testing.assert_array_equal(t.numpy(), a)
