"""The port's effects rack (``synthesizer_tpu_torch.ops.effects``) against
the JAX package's ``ops.effects`` and the ``goldref.effects`` oracle, on
the CPU, on seeded numpy input.

Budgets: ``ops.effects.BUDGETS`` (``goldref.effects``'s, at 16 bit); the
biquad kinds as the reference's filter tests budget them.  Each JAX op runs
jitted, once per shape.
"""

import math

import numpy as np
import pytest
import torch
import torch.utils._python_dispatch

import goldref.effects as gfx
import goldref.sample as gs
from synthesizer_tpu.ops import coeffs as JC
from synthesizer_tpu.ops import effects as JF
from synthesizer_tpu_torch.ops import coeffs as TC
from synthesizer_tpu_torch.ops import effects as TF

torch.set_num_threads(2)

SR = 44100
N = 4000


def _signal(n=N, nch=2, seed=0, scale=0.5):
    rng = np.random.default_rng(seed)
    t = np.arange(n) / SR
    sig = scale * np.sin(2 * np.pi * 330 * t)[:, None] \
        + 0.2 * rng.standard_normal((n, nch))
    sig[n // 3:n // 2] *= 0.01                  # a quiet stretch
    return np.clip(np.rint(sig * 32767), -32768, 32767).astype(np.int16)


def _jax(fn, *args):
    import jax
    import jax.numpy as jnp
    return np.asarray(jax.jit(fn)(*(jnp.asarray(a) for a in args)))


def _lsb(a, b):
    a, b = np.asarray(a), np.asarray(b)
    assert a.shape == b.shape, (a.shape, b.shape)
    return int(np.abs(a.astype(np.int64) - b.astype(np.int64)).max())


def _t(a):
    return torch.from_numpy(np.ascontiguousarray(a))


# ---------------------------------------------------------------------------
# Scans
# ---------------------------------------------------------------------------

def _affine_combine(l, r):
    (al, bl), (ar, br) = l, r
    return al * ar, bl * ar + br


def _generic_affine(coeff, add, init, axis=0):
    """The affine scan through the generic odd/even recursion."""
    acum, bcum = TF.associative_scan(_affine_combine, (_t(coeff), _t(add)),
                                     dim=axis)
    return (acum * TF._f32(init, acum.device) + bcum).numpy()


class _CountOps(torch.utils._python_dispatch.TorchDispatchMode):
    """Counts the operations that compute (not views): on the card each is
    one kernel launch."""

    def __init__(self):
        super().__init__()
        self.n = 0

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        if not func._schema.is_mutable and not any(
                r.alias_info for r in func._schema.returns):
            self.n += 1
        return func(*args, **(kwargs or {}))


@pytest.mark.parametrize("n", [2, 5, 441000])
def test_affine_scan_launches_no_more_than_the_generic_recursion(n):
    """One affine scan (the gate's, the compressor's and the limiter's
    smoother, the allpasses) launches no more operations than the generic
    recursion it replaces, and reads the same bits."""
    rng = np.random.default_rng(n)
    coeff = np.full(n, 0.99, np.float32)
    add = rng.standard_normal(n).astype(np.float32)
    with _CountOps() as split:
        y = TF.affine_scan(_t(coeff), _t(add), 0.3)
    with _CountOps() as generic:
        want = _generic_affine(coeff, add, 0.3)
    np.testing.assert_array_equal(y.numpy(), want)
    assert 0 < split.n <= generic.n


@pytest.mark.parametrize("n", [1, 2, 5, 64, 1000])
def test_associative_scan_is_the_reference_tree(n):
    """Prefix sums and decaying maxima take the reference's grouping: bit
    for bit equal to ``jax.lax.associative_scan`` (no product is fused
    into an add there); the affine scan agrees with the sequential f64
    recurrence as closely as the reference's own."""
    import jax
    import jax.numpy as jnp
    rng = np.random.default_rng(n)
    a = rng.standard_normal(n).astype(np.float32)
    (s,) = TF.associative_scan(lambda l, r: (l[0] + r[0],), (_t(a),))
    np.testing.assert_array_equal(
        s.numpy(), _jax(lambda x: jax.lax.associative_scan(jnp.add, x), a))
    m = rng.standard_normal((3, n)).astype(np.float32)
    (s2,) = TF.associative_scan(lambda l, r: (l[0] + r[0],), (_t(m),), dim=1)
    np.testing.assert_array_equal(s2.numpy(), np.stack(
        [TF.associative_scan(lambda l, r: (l[0] + r[0],), (_t(row),))[0]
         .numpy() for row in m]))
    e = np.abs(a)
    np.testing.assert_array_equal(
        TF.decaying_max_scan(_t(e), 0.999, 0.5).numpy(),
        _jax(lambda x: JF.decaying_max_scan(x, 0.999, 0.5), e))
    coeff = rng.uniform(0.9, 1.0, n).astype(np.float32)
    y = TF.affine_scan(_t(coeff), _t(a), 0.3).numpy()
    # the split into a coefficient half and an add half is the generic
    # recursion's tree under the affine composition, bit for bit
    np.testing.assert_array_equal(y, _generic_affine(coeff, a, 0.3))
    rows = rng.standard_normal((4, n)).astype(np.float32)
    init = a[:4, None] if n >= 4 else np.ones((4, 1), np.float32)
    scan = TF.affine_scan_fixed(_t(np.tile(coeff, (4, 1))), axis=1)
    np.testing.assert_array_equal(
        scan(_t(rows), _t(init)).numpy(),
        _generic_affine(np.tile(coeff, (4, 1)), rows, init, axis=1))
    ref, acc = np.zeros(n), 0.3
    for i in range(n):
        acc = float(coeff[i]) * acc + float(a[i])
        ref[i] = acc
    jy = _jax(lambda c, x: JF.affine_scan(c, x, 0.3), coeff, a)
    tol = 1e-5 * (1.0 + np.abs(ref))
    assert (np.abs(y - ref) <= tol).all()
    assert (np.abs(jy - ref) <= tol).all()
    np.testing.assert_allclose(TF.one_pole_scan(_t(a), 0.01, 0.2).numpy(),
                               _jax(lambda x: JF.one_pole_scan(x, 0.01, 0.2),
                                    a), rtol=1e-5, atol=1e-6)


def test_float_float_primitives():
    """On (hi, lo) pairs split from f64 values, ff_add is bit-identical to
    the reference's and ff_mul carries the f64 product to 2^-44 (the
    reference contracts its cross terms into FMAs, so its pair may differ
    from this one in the last bits, within the same bound)."""
    rng = np.random.default_rng(1)
    a64, b64 = (rng.standard_normal(20000) * 10.0 ** rng.uniform(-3, 3, 20000)
                for _ in range(2))
    x = [*TC.ff_split(a64), *TC.ff_split(b64)]
    for a, b in zip(TF.ff_add(*map(_t, x)), _jax(JF.ff_add, *x)):
        np.testing.assert_array_equal(a.numpy(), b)
    exact = a64 * b64
    th, tl = (v.numpy().astype(np.float64) for v in TF.ff_mul(*map(_t, x)))
    jh = _jax(lambda *v: JF.ff_mul(*v)[0], *x).astype(np.float64)
    jl = _jax(lambda *v: JF.ff_mul(*v)[1], *x).astype(np.float64)
    for h, l in ((th, tl), (jh, jl)):
        assert (np.abs(h + l - exact) <= 2.0 ** -44 * np.abs(exact)).all()


#: badly conditioned coefficient sets (poles near z = 1), each routed to the
#: float-float scan by coeffs.wants_ff_scan
FF_CASES = [("lowshelf", 120.0, -12.0, 0.7071), ("lowshelf", 60.0, 6.0, 0.7071),
            ("peaking", 250.0, 12.0, 8.0)]


@pytest.mark.parametrize("kind,freq,gain,q", FF_CASES)
def test_float_float_scan_on_badly_conditioned_coefficients(kind, freq,
                                                            gain, q):
    coeffs = TC.eq_band_coeffs(kind, freq, gain, q, SR)
    assert TC.wants_ff_scan(coeffs)
    x = _signal(seed=2) // 4
    s = TF._norm(_t(x))
    y, _ = TF.biquad_apply_ff(s, tuple(TC.ff_split(c) for c in coeffs))
    got = TF.to_int_samples(y, 2).numpy()
    gold = gs.Sample(x.copy(), SR, 2, 2).filter(kind, freq, q,
                                                gain_db=gain).frames
    assert _lsb(got, gold) <= 2
    # the plain f32 scan on the same coefficients drifts further
    yp, _ = TF.biquad_apply(s, coeffs)
    assert _lsb(TF.to_int_samples(yp, 2).numpy(), gold) >= _lsb(got, gold)


def test_biquad_state_carries_across_chunks():
    coeffs = TC.biquad_coeffs("lowpass", 1000.0, 0.7071, SR)
    s = TF._norm(_t(_signal(seed=3)))
    whole, _ = TF.biquad_apply(s, coeffs)
    a, st = TF.biquad_apply(s[:1500], coeffs)
    b, _ = TF.biquad_apply(s[1500:], coeffs, st)
    got = TF.to_int_samples(torch.cat([a, b]), 2)
    assert _lsb(got.numpy(), TF.to_int_samples(whole, 2).numpy()) <= 2
    pairs = tuple(TC.ff_split(c) for c in
                  TC.eq_band_coeffs("lowshelf", 120.0, -12.0, 0.7071, SR))
    whole, _ = TF.biquad_apply_ff(s, pairs)
    a, st = TF.biquad_apply_ff(s[:1500], pairs)
    b, _ = TF.biquad_apply_ff(s[1500:], pairs, st)
    assert _lsb(TF.to_int_samples(torch.cat([a, b]), 2).numpy(),
                TF.to_int_samples(whole, 2).numpy()) <= 1


# ---------------------------------------------------------------------------
# Each op against the JAX op (jitted), within its goldref budget
# ---------------------------------------------------------------------------

def _comp_pair(knee):
    alpha, decay = TC.compressor_coeffs(SR, 0.003, 0.08)
    assert (alpha, decay) == JC.compressor_coeffs(SR, 0.003, 0.08)
    args = (-18.0, 0.75, alpha, decay)
    return (lambda x: TF.compressor_gains_from_coeffs(x, *args, knee=knee),
            lambda x: JF.compressor_gains_from_coeffs(x, *args, knee=knee))


def _gains_applied(gain_fn):
    def op(x, lib):
        g = gain_fn(x)
        if lib == "torch":
            return TF.dpcm.gain_apply(x, g[:, None])
        from synthesizer_tpu.ops import pcm as jpcm
        return jpcm.gain_apply(x, g[:, None])
    return op


def _gate(lib):
    alpha, decay, floor_gain = TC.gate_coeffs(SR, 0.001, 0.01, 60.0)
    F = TF if lib == "torch" else JF
    return lambda x: F.gate_gains_from_coeffs(x, -30.0, floor_gain, alpha,
                                              decay, 0.0, floor_gain)


P_GRIDS = TC.phaser_coeff_grids(0, N, SR, 0.8, 1.0, 300.0, 3000.0, 0.7071,
                                dtype=np.float32)
TREM = TC.tremolo_gain_grid(TC.static_phase(0, N, SR, 5.0), 0.5)
PAN = TC.autopan_pan_grid(TC.static_phase(0, N, SR, 2.0), 1.0)
IR = (np.random.default_rng(9).standard_normal((300, 1))
      * np.exp(-np.arange(300) / 60.0)[:, None] * 0.3).astype(np.float32)


def _phaser(F, lib):
    def op(x):
        s = F._norm(x)
        if lib == "torch":
            z = torch.zeros(2)
            grids = tuple(_t(g) for g in P_GRIDS)
        else:
            import jax.numpy as jnp
            z = jnp.zeros(2, jnp.float32)
            grids = tuple(jnp.asarray(g) for g in P_GRIDS)
        y, _ = F.phaser_apply(s, grids, tuple((z,) * 4 for _ in range(4)),
                              False)
        return F.to_int_samples(s + 0.5 * y, 2)
    return op


def _lib_ops(F, lib):
    """name -> (op on an int16 [N, 2] array of this library, budget)."""
    import jax.numpy as jnp
    arr = _t if lib == "torch" else jnp.asarray
    comp = {"torch": 0, "jax": 1}[lib]
    B = TF.BUDGETS
    return {
        "compress": (_gains_applied(lambda x: _comp_pair(None)[comp](x)),
                     B["compress"]),
        "compress_soft_knee": (_gains_applied(
            lambda x: _comp_pair(6.0)[comp](x)), B["compress"]),
        "gate": (_gains_applied(lambda x: _gate(lib)(x)), B["gate"]),
        "reverb": (lambda x, lib: F.reverb(x, SR, 0.7, 0.5, 0.33, 0.7, 1.0,
                                           2000), B["reverb"]),
        "reverb_mono": (lambda x, lib: F.reverb(x[:, :1], SR, 0.8, 0.3, 0.5,
                                                0.5, 1.0, 500),
                        B["reverb"]),
        "chorus": (lambda x, lib: F.chorus(x, SR, 0.5, 0.002, 0.02, 3, 0.4,
                                           1.0), B["chorus"]),
        "convolve": (lambda x, lib: F.convolve(x, arr(IR), 1.0, 0.3),
                     B["convolve"]),
        "stretch": (lambda x, lib: F.stretch(x, 1.3), B["stretch"]),
        "stretch_odd_hop": (lambda x, lib: F.stretch(x, 0.8, 1024, 300),
                            B["stretch"]),
        "granulate": (lambda x, lib: F.granulate(x, SR, 0.12, 0.02, 80.0,
                                                 0.01, 0.7, 3),
                      B["granulate"]),
        "tremolo": (lambda x, lib: F.tremolo(x, arr(TREM)), B["tremolo"]),
        "autopan": (lambda x, lib: F.autopan(x, arr(PAN)), B["autopan"]),
        "feedback_echo": (lambda x, lib: F.feedback_echo(x, 441, 0.5, 0.5,
                                                         1.0, 3000),
                          B["feedback_echo"]),
        "stereo_width": (lambda x, lib: F.stereo_width(x, 1.7),
                         B["stereo_width"]),
        "limiter": (lambda x, lib: F.limiter(x, -6.0, TC.compressor_coeffs(
            SR, 0.0, 0.05)[1], 220, TC.limiter_ceiling(-6.0, 2)),
                    B["limit"]),
        "phaser": (lambda x, lib: _phaser(F, lib)(x), B["phaser"]),
    }


OPS = sorted(_lib_ops(TF, "torch"))


@pytest.mark.parametrize("name", OPS)
def test_op_matches_jax(name):
    x = _signal(seed=4)
    top, budget = _lib_ops(TF, "torch")[name]
    jop, _ = _lib_ops(JF, "jax")[name]
    got = top(_t(x), "torch").numpy()
    want = _jax(lambda v: jop(v, "jax"), x)
    assert got.dtype == want.dtype
    assert _lsb(got, want) <= budget


def test_granulate_is_the_same_run_to_run():
    x = _t(_signal(seed=5))
    a = TF.granulate(x, SR, 0.2, 0.03, 120.0, 0.02, 0.7, 11)
    b = TF.granulate(x, SR, 0.2, 0.03, 120.0, 0.02, 0.7, 11)
    assert torch.equal(a, b)
    gold = gs.Sample(x.numpy().copy(), SR, 2, 2).granulate(
        0.2, 0.03, 120.0, 0.02, 0.7, 11).frames
    assert _lsb(a.numpy(), gold) <= 2


def test_overlap_add_groups_never_overlap():
    starts = np.array([0, 3, 5, 9, 10, 30, 31], np.int64)
    groups = TF._groups(starts, 6)
    assert sorted(np.concatenate(groups).tolist()) == list(range(7))
    for g in groups:
        s = np.sort(starts[g])
        assert (np.diff(s) >= 6).all()
    segs = torch.arange(7 * 6, dtype=torch.float32).reshape(7, 6)
    out = TF.overlap_add(segs, starts, 34)
    ref = np.zeros(34)
    for i, st in enumerate(starts):
        ref[st:st + 6] += segs[i].numpy()[:max(0, min(6, 34 - st))]
    np.testing.assert_array_equal(out.numpy(), ref.astype(np.float32))


@pytest.mark.parametrize("kind,cutoff,q,gain,budget", [
    ("lowpass", 1000.0, 0.7071, 0.0, 4), ("highpass", 300.0, 0.7071, 0.0, 16),
    ("bandpass", 800.0, 4.0, 0.0, 4), ("highpass", 30.0, 0.7071, 0.0, 4),
    ("peaking", 1000.0, 1.0, 6.0, 4), ("highshelf", 8000.0, 0.7071, 9.0, 4)])
def test_biquad_matches_oracle(kind, cutoff, q, gain, budget):
    """The scan (plain, or float-float where the coefficients ask for it)
    against the oracle's sequential f64 biquad through the same
    coefficients (the JAX scan is held to these budgets by the reference's
    own filter tests)."""
    x = _signal(seed=6)
    if kind in ("peaking", "highshelf"):
        coeffs = TC.eq_band_coeffs(kind, cutoff, gain, q, SR)
    else:
        coeffs = TC.biquad_coeffs(kind, cutoff, q, SR)
    s = TF._norm(_t(x))
    if TC.wants_ff_scan(coeffs):        # as Sample.filter routes it
        y, _ = TF.biquad_apply_ff(s, tuple(TC.ff_split(c) for c in coeffs))
    else:
        y, _ = TF.biquad_apply(s, coeffs)
    gold = gs.Sample(x.copy(), SR, 2, 2).filter(kind, cutoff, q,
                                                gain_db=gain).frames
    assert _lsb(TF.to_int_samples(y, 2).numpy(), gold) <= budget


def test_phaser_float_float_matches_oracle():
    x = _signal(seed=7)
    grids = TC.phaser_coeff_grids(0, N, SR, 0.8, 1.0, 60.0, 2000.0, 1.0,
                                  dtype=np.float64)
    assert TC.phaser_wants_ff(60.0)
    pairs = tuple(tuple(_t(p) for p in TC.ff_split(g)) for g in grids)
    s = TF._norm(_t(x))
    z = torch.zeros(2)
    y, _ = TF.phaser_apply(s, pairs, tuple((z,) * 6 for _ in range(4)), True)
    got = TF.to_int_samples(s + 0.5 * y, 2).numpy()
    gold = gs.Sample(x.copy(), SR, 2, 2).phaser(
        rate=0.8, depth=1.0, min_freq=60.0, max_freq=2000.0, stages=4,
        q=1.0, wet=0.5, dry=1.0, grids_dtype=np.float64).frames
    assert _lsb(got, gold) <= 2


def test_streaming_twins_match_whole_signal():
    """The chunked forms (reverb network, chorus history, convolution
    tail, feedback-echo history, limiter state) reproduce the whole-signal
    op within the reverb budget / bit for bit where the arithmetic is the
    same."""
    x = _signal(2000, seed=8)
    s = TF._norm(_t(x))
    # feedback echo: identical per-element arithmetic
    e, _ = TF.feedback_echo_core(s, 300, 0.5, torch.zeros((300, 2)))
    e1, h = TF.feedback_echo_core(s[:700], 300, 0.5, torch.zeros((300, 2)))
    e2, _ = TF.feedback_echo_core(s[700:], 300, 0.5, h)
    assert torch.equal(torch.cat([e1, e2]), e)
    # chorus: pure gathers
    whole = TF.chorus_core(s, 0, torch.zeros((0, 2)), SR, 0.5, 0.002, 0.02,
                           3, 0.4, 1.0)
    hist = torch.zeros((1000, 2))
    a = TF.chorus_core(s[:900], 0, hist, SR, 0.5, 0.002, 0.02, 3, 0.4, 1.0)
    b = TF.chorus_core(s[900:], 900, torch.cat([hist, s[:900]])[-1000:],
                       SR, 0.5, 0.002, 0.02, 3, 0.4, 1.0)
    assert torch.equal(torch.cat([a, b]), whole)
    # convolution: overlap-add with the carried tail
    ir = _t(IR[:, 0])
    full = TF.convolve(_t(x), ir, 1.0, 0.0)
    y1, tail = TF.convolve_chunk(_t(x[:1200]), ir, 1.0, 0.0,
                                 torch.zeros((299, 2)))
    y2, _ = TF.convolve_chunk(_t(x[1200:]), ir, 1.0, 0.0, tail)
    assert _lsb(torch.cat([y1, y2]).numpy(), full[:2000].numpy()) <= 1
    # reverb: the blocked network == the lag-aligned comb stage
    combs, aps = TC.reverb_delays(SR, 0)
    mono = s.sum(dim=1) * 0.015
    _, blocked = TF.reverb_network_apply(
        TF.reverb_zero_state(combs, aps, "cpu"), mono, combs, aps, 0.84, 0.2)
    whole = TF._reverb_networks_whole(mono, [(combs, aps)], 0.84, 0.2)[0]
    assert float((blocked - whole).abs().max()) * 32767 <= 4
    # limiter: gains over two chunks with the carried state
    a = TF.torch.amax(torch.abs(s), dim=1)
    decay = TC.compressor_coeffs(SR, 0.0, 0.05)[1]
    ap = torch.cat([a, torch.zeros(100)])
    g, _, _ = TF.limiter_gains_core(ap, -6.0, decay, 100)
    g1, r, gp = TF.limiter_gains_core(ap[:1100], -6.0, decay, 100)
    g2, _, _ = TF.limiter_gains_core(ap[1000:], -6.0, decay, 100, r, gp)
    assert float((torch.cat([g1, g2]) - g).abs().max()) <= 2e-6


def test_reverb_past_the_packing_cap(monkeypatch):
    """Past COMB_PACK_BYTES_CAP the whole-signal reverb runs the blocked
    network: the same recurrences, within the reverb budget."""
    x = _t(_signal(1500, seed=9))
    packed = TF.reverb(x, SR, 0.7, 0.5, 0.33, 0.7, 1.0, 300)
    monkeypatch.setattr(TF, "COMB_PACK_BYTES_CAP", 0)
    blocked = TF.reverb(x, SR, 0.7, 0.5, 0.33, 0.7, 1.0, 300)
    assert _lsb(packed.numpy(), blocked.numpy()) <= 4
    gold = gfx.reverb(x.numpy().copy(), 2, SR, 0.7, 0.5, 0.33, 0.7, 1.0,
                      tail_frames=300)
    assert _lsb(blocked.numpy(), gold) <= 4


def test_int_quantization_widths():
    v = torch.tensor([0.0, 0.5, -0.5, 1.0, -1.0, 1.5, -1.5, 2.5e-5, 1e-9])
    for width in (1, 2, 4):
        got = TF.to_int_samples(v, width).numpy()
        want = gfx._to_int(v.numpy(), width)
        np.testing.assert_array_equal(got, want)
