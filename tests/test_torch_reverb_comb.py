"""The reverb's comb stage (``synthesizer_tpu_torch.ops.effects.reverb_comb``):
the route its wrapper takes, what it refuses, how its blocks are counted,
and the in-place scan tree of ``csrc/reverb_comb.cu`` written out in numpy
against ``affine_scan_fixed``.  The kernel itself runs on the card only:
``gpu_verify``'s section E holds it to the plain loop there, and the one
test below that needs it skips without a card.

No JAX here: the plain loop is the reference, and its agreement with the
JAX package is ``tests/test_torch_effects.py``'s.
"""

import numpy as np
import pytest
import torch

from synthesizer_tpu_torch import effects as TE
from synthesizer_tpu_torch import gpu_verify as GV
from synthesizer_tpu_torch.ops import coeffs as TC
from synthesizer_tpu_torch.ops import effects as TF
from synthesizer_tpu_torch.ops import kernels as K
from synthesizer_tpu_torch.utils import profiling
from synthesizer_tpu_torch.utils.program import Program, _Inside, on_replay

SR = 44100
NETS = [TC.reverb_delays(SR, ch) for ch in range(2)]
COMBS = [D for cs, _ in NETS for D in cs]
BLOCK = min(COMBS)


def _inputs(n, lanes=16, grid=False, seed=0):
    rng = np.random.default_rng(seed)
    combs = COMBS[:lanes]
    t = lambda a: torch.from_numpy(np.array(a, np.float32))
    return dict(
        comb_buf=t(rng.standard_normal((lanes, max(combs))) * 0.2),
        fstores=t(rng.standard_normal(lanes) * 0.2),
        x=t(rng.standard_normal(n) * 0.3), n0=torch.tensor(4410),
        feedback=t(0.7 + 0.28 * rng.random(n) if grid else 0.84),
        damp=t(0.24), combs=combs, block=min(combs))


def _no_kernel(monkeypatch):
    def refuse():
        raise AssertionError("the CPU route loaded the comb kernel")
    monkeypatch.setattr(K, "comb_library", refuse)


@pytest.mark.parametrize("n,lanes,grid", [
    (1470, 16, False), (354, 8, True), (3 * BLOCK, 16, True), (0, 16, True)])
def test_cpu_takes_the_plain_route(monkeypatch, n, lanes, grid):
    """On CPU tensors the wrapper is the plain loop, bit for bit, and
    launches nothing."""
    _no_kernel(monkeypatch)
    kw = _inputs(n, lanes, grid)
    launches = TF.reverb_comb.launches
    got = TF.reverb_comb(**kw)
    assert got[2].shape == (lanes, n)
    if n:
        want = TF._comb_blocks(kw["comb_buf"], kw["fstores"], kw["x"],
                               kw["n0"], kw["feedback"], kw["damp"],
                               kw["combs"], kw["block"])
        assert all(torch.equal(a, b) for a, b in zip(got, want))
    else:
        assert got[0] is kw["comb_buf"] and got[1] is kw["fstores"]
    assert TF.reverb_comb.launches == launches


def _bad(kw, what):
    kw = dict(kw)
    if what == "dtype":
        kw["x"] = kw["x"].double()
    elif what == "contiguity":
        kw["comb_buf"] = kw["comb_buf"].t().contiguous().t()
    elif what == "block":
        kw["block"] = BLOCK + 1
    elif what == "n0":
        kw["n0"] = kw["n0"].float()
    elif what == "grid":
        kw["feedback"] = kw["feedback"][:-1]
    elif what == "lanes":
        kw["fstores"] = kw["fstores"][:-1].contiguous()
    elif what == "width":
        kw["comb_buf"] = kw["comb_buf"][:, :BLOCK].contiguous()
    return kw


@pytest.mark.parametrize("what", ["dtype", "contiguity", "block", "n0",
                                  "grid", "lanes", "width"])
def test_the_wrapper_raises_on_what_it_does_not_take(what):
    with pytest.raises(ValueError, match="reverb_comb"):
        TF.reverb_comb(**_bad(_inputs(1470, grid=True), what))


def _delta(before):
    return {r: profiling.comb_blocks[r] - before[r] for r in before}


@pytest.mark.parametrize("nch,chunks,slab", [
    (2, [1470] * 3, 256), (1, [1470, 354, 0, 5000], 256),
    (2, [3 * 4 * BLOCK + 17, 1470], 4)])
def test_every_comb_block_is_counted_by_route(monkeypatch, nch, chunks,
                                              slab):
    """Every block of every ``StreamingReverb.process`` piece is counted
    once, where it runs: on the plain route on the CPU."""
    monkeypatch.setattr(TF, "SLAB_STEPS", slab)
    _no_kernel(monkeypatch)
    proc = TE.StreamingReverb(SR, nch, device="cpu")
    piece = slab * BLOCK
    rng = np.random.default_rng(3)
    before = dict(profiling.comb_blocks)
    for n in chunks:
        x = rng.integers(-9000, 9000, (n, nch), dtype=np.int16)
        proc.process(torch.from_numpy(x))
    want = sum(-(-min(n - p0, piece) // BLOCK)
               for n in chunks for p0 in range(0, max(n, 1), piece))
    assert _delta(before) == {"kernel": 0, "plain": want}


def test_networks_apply_counts_its_blocks():
    """A call of ``reverb_networks_apply`` counts its blocks, alone and
    inlined into another program's body (which runs at every call on the
    CPU)."""
    states = [TF.reverb_zero_state(c, a, "cpu") for c, a in NETS]
    x = torch.from_numpy(np.random.default_rng(4).standard_normal(
        2 * BLOCK + 5).astype(np.float32))
    before = dict(profiling.comb_blocks)
    TF.reverb_networks_apply(states, x, NETS, 0.84, 0.2)
    assert _delta(before) == {"kernel": 0, "plain": 3}
    before = dict(profiling.comb_blocks)
    prog = Program(lambda s, xx, f, i: TF.reverb_networks_apply(
        s, xx, NETS, f[0], f[1]), "comb_count_test", "cpu")
    for _ in range(2):
        prog(states, x, f=(0.84, 0.2))
    assert _delta(before) == {"kernel": 0, "plain": 6}


def test_a_capture_counts_at_each_replay():
    """``on_replay`` runs its hook at once outside a capture, and, inside
    one, hands it to the capture's list, which each replay runs (the
    comb counters' route on the card)."""
    seen, hooks = [], []
    on_replay(lambda: seen.append("now"))
    assert seen == ["now"] and hooks == []
    with _Inside(hooks=hooks):
        with _Inside():                         # a nested program, inlined
            TF._count_blocks("kernel", 7)
            on_replay(lambda: seen.append("replay"))
    assert seen == ["now"] and len(hooks) == 2
    before = dict(profiling.comb_blocks)
    for _ in range(3):
        for fn in hooks:
            fn()
    assert seen == ["now"] + ["replay"] * 3
    assert _delta(before) == {"kernel": 21, "plain": 0}
    on_replay(lambda: seen.append("after"))
    assert seen[-1] == "after" and len(hooks) == 2


def _tree(add: np.ndarray, coef) -> np.ndarray:
    """``comb_kernel``'s in-place scan of one block, written out: the
    pair sums up the levels (x[p] = x[p - s] c_k + x[p] at p = (2j + 2) s
    - 1), then the even results down (p = (2j + 3) s - 1)."""
    x = add.astype(np.float32).copy()
    m = len(x)
    levels = 0
    while (m >> levels) >= 2:
        levels += 1
    for k, first in [(k, 2) for k in range(levels)] + \
            [(k, 3) for k in reversed(range(levels))]:
        s = 1 << k
        nk = m >> k
        count = nk >> 1 if first == 2 else (nk - 1) >> 1
        for j in range(count):
            p = (2 * j + first) * s - 1
            x[p] = np.float32(np.float32(x[p - s] * coef[k]) + x[p])
    return x


@pytest.mark.parametrize("m", [1, 2, 3, 5, 7, 8, 354, 1116, 1117])
def test_the_kernels_tree_is_affine_scan_fixed(m):
    """The kernel's index arithmetic gives ``affine_scan_fixed``'s add
    half bit for bit, with the coefficient half as the wrapper hands it
    over (one scalar a level, the cumulative product)."""
    rng = np.random.default_rng(m)
    d1 = torch.tensor(np.float32(0.31))
    scan = TF.affine_scan_fixed(d1.expand(m), axis=0)
    for a in scan.level_coeffs:
        assert torch.equal(a, a[:1].expand(a.shape))
    coef = np.array([float(a[0]) for a in scan.level_coeffs], np.float32)
    add = rng.standard_normal(m).astype(np.float32)
    init = np.float32(rng.standard_normal())
    want = scan(torch.from_numpy(add), torch.tensor(init)).numpy()
    acum = scan.acum.numpy()
    got = (acum * init).astype(np.float32) + _tree(add, coef)
    assert np.array_equal(got.astype(np.float32), want)


def test_the_card_section_is_na_without_a_card():
    rows = []
    GV.section_reverb_comb(torch.device("cpu"), lambda name, ok, detail="":
                           rows.append((name, ok, detail)))
    assert [(n, ok) for n, ok, _ in rows] == [
        ("kernel/reverb_comb", None), ("kernel/reverb_comb_streaming", None)]


@pytest.mark.card
def test_the_kernel_equals_the_plain_loop_on_the_card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the comb kernel runs on the card")
    rows = []
    GV.section_reverb_comb(torch.device("cuda"), lambda name, ok, detail="":
                           rows.append((name, ok, detail)))
    assert [n for n, ok, _ in rows if ok] == [
        "kernel/reverb_comb", "kernel/reverb_comb_streaming"], rows
