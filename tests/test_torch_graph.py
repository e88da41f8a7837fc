"""The port's patch graph (``synthesizer_tpu_torch.models.graph``, with the
host-only ``models.spec`` and the two helpers of ``ops.effects``) against
the JAX package and the numpy oracle (``goldref.osc.render_oracle``), on
the CPU.

Tolerances: every waveform kind and node type but Biquad is within 1 LSB at
16 bit of both, and block-size invariant bit for bit; the noise pipeline is
integer hashing and one f32 scale, so its digest is exact; ``to_int_device``
is bit-exact on the same f32 input; Biquad (a parallel f32 scan) is held to
the budgets of ``tests/test_filters.py`` against the sequential f64 oracle
(2 to 16 LSB by pole position) and to block-size near-invariance below
3/32767.
"""

import dataclasses
import hashlib

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

import goldref.osc as go
from synthesizer_tpu.models import graph as JG
from synthesizer_tpu.models import spec as JS
from synthesizer_tpu.ops import effects as JE
from synthesizer_tpu_torch.models import graph as TG
from synthesizer_tpu_torch.models import spec as TS
from synthesizer_tpu_torch.ops import effects as TE

SR = 44100
N = 20000


def sha(a) -> str:
    return hashlib.sha256(np.ascontiguousarray(a).tobytes()).hexdigest()[:16]


def q16(v):
    return np.clip(np.rint(np.asarray(v, np.float64) * 32767), -32768, 32767)


def render(node, n=N, blocksize=2048):
    return TG.render_patch(node, n, SR, blocksize, device="cpu").numpy()


def patches(S):
    """One patch per waveform kind and node type, built from the spec
    module ``S`` (the JAX package's or the port's copy)."""
    tab = tuple(float(x) for x in
                np.sin(np.linspace(0, 2 * np.pi, 64, endpoint=False)) ** 3)
    src = S.Osc("sawtooth", 330.0, 0.8)
    P = {}
    for k in S.WAVEFORMS:
        kw = {}
        if k == "harmonics":
            kw["harmonics"] = ((1.0, 0.5), (2.0, 0.3), (2.5, 0.2))
        if k == "wavetable":
            kw["table"] = tab
        if k in ("white_noise", "pluck"):
            kw["seed"] = 3
        P[k] = S.Osc(k, 8000.0 if k == "white_noise" else 330.0, 0.8,
                     phase=0.1, bias=0.05, **kw)
    P["fm_sine"] = S.Osc("sine", 440.0, 0.8,
                         fm_lfo=S.Osc("sine", 5.0, 0.05))
    P["fm_ramp"] = S.Osc("sawtooth", 220.0, 0.7,
                         fm_lfo=S.Linear(0.0, 1e-5))
    P["fm_down"] = S.Osc("triangle", 300.0, 0.7, fm_lfo=S.Const(-2.5))
    P["pwm"] = S.Osc("pulse", 220.0, 0.7,
                     pwm_lfo=S.Osc("sine", 2.0, 0.3, bias=0.5))
    P["pulse_width"] = S.Osc("pulse", 220.0, 0.7, pulse_width=0.3)
    P["noise_held"] = S.Osc("white_noise", 441.0, 0.9, seed=11)
    P["const"] = S.Const(0.25)
    P["linear"] = S.Linear(-0.5, 1e-4, -0.4, 0.7)
    P["envelope"] = S.Envelope(src, 0.01, 0.02, 0.05, 0.6, 0.05)
    P["envelope_zero"] = S.Envelope(src, 0.0, 0.0, 0.1, 0.5, 0.0)
    P["mix"] = S.Mix((src, S.Osc("sine", 550.0, 0.2), S.Const(0.01)))
    P["ampmod"] = S.AmpMod(src, S.Osc("sine", 7.0, 0.5, bias=0.5))
    P["delay"] = S.Delay(src, 0.013)
    P["delay_long"] = S.Delay(src, 0.1)
    P["echo"] = S.Echo(S.Envelope(src, 0.005, 0.01, 0.02, 0.5, 0.02),
                       0.03, 3, 0.02, 0.5)
    P["clip"] = S.Clip(src, -0.3, 0.4)
    P["abs"] = S.Abs(src)
    P["null"] = S.Null(src)
    return P


PJ, PT = patches(JS), patches(TS)


def test_spec_copy_is_the_reference_spec():
    assert TS.WAVEFORMS == JS.WAVEFORMS
    for name in ("Osc", "Linear", "Const", "Envelope", "Mix", "AmpMod",
                 "Delay", "Echo", "Biquad", "Clip", "Abs", "Null",
                 "HostSource"):
        a, b = getattr(TS, name), getattr(JS, name)
        assert [(f.name, f.default) for f in dataclasses.fields(a)] == \
               [(f.name, f.default) for f in dataclasses.fields(b)], name
    for kind in ("lowpass", "highpass", "bandpass"):
        assert TS.biquad_coeffs(kind, 700.0, 2.0, SR) == \
               JS.biquad_coeffs(kind, 700.0, 2.0, SR)
    assert TS.Envelope(TS.Const(1.0), 0.1, 0.2, 0.3, 0.5, 0.4).end_time == \
           JS.Envelope(JS.Const(1.0), 0.1, 0.2, 0.3, 0.5, 0.4).end_time
    with pytest.raises(ValueError):
        TS.Osc("nope", 1.0)
    with pytest.raises(ValueError):
        TS.Osc("wavetable", 1.0)
    with pytest.raises(ValueError):
        TS.Biquad(TS.Const(0.0), "notch", 500.0)
    with pytest.raises(ValueError):
        TS.Biquad(TS.Const(0.0), "lowpass", -1.0)


def test_spec_tree_helpers():
    h1, h2 = TS.HostSource(17), TS.HostSource(5)
    tree = TS.Mix((TS.Envelope(h1, 0.1, 0.1, 0.1, 0.5, 0.1),
                   TS.AmpMod(TS.Osc("sine", 1.0), h2), h1))
    assert TS.has_host_source(tree) and TS.has_host_source(h1)
    assert not TS.has_host_source(PT["echo"])
    canon, keys = TS.canonical_host_patch(tree)
    assert keys == [17, 5]
    assert canon.sources[0].source == TS.HostSource(0)
    assert canon.sources[1].modulator == TS.HostSource(1)
    assert canon.sources[2] == TS.HostSource(0)
    same = TS.map_children(PT["echo"], lambda nd: nd)
    assert same is PT["echo"]
    swapped = TS.map_children(PT["ampmod"], lambda nd: TS.Const(0.0))
    assert swapped == TS.AmpMod(TS.Const(0.0), TS.Const(0.0))


@pytest.mark.parametrize("name", sorted(PJ))
def test_patch_matches_reference_and_oracle(name):
    got = render(PT[name])
    assert got.dtype == np.float32 and got.shape == (N,)
    ref = np.asarray(JG.render_patch(PJ[name], N, SR, 2048))
    gold = go.render_oracle(PJ[name], N, SR)
    assert np.abs(q16(got) - q16(ref)).max() <= 1
    assert np.abs(q16(got) - q16(gold)).max() <= 1


@pytest.mark.parametrize("name", sorted(PT))
def test_blocksize_invariance_bit_for_bit(name):
    np.testing.assert_array_equal(render(PT[name], blocksize=512),
                                  render(PT[name], blocksize=8192))


def test_noise_digest_exact():
    noise = render(TS.Osc("white_noise", SR, 0.5, seed=42), 10000, 8192)
    assert sha(noise) == "7d5f6f9b694b18a5"
    ref = np.asarray(JG.render_patch(JS.Osc("white_noise", SR, 0.5, seed=42),
                                     10000, SR))
    np.testing.assert_array_equal(noise, ref)


@pytest.mark.parametrize("width", [1, 2, 4])
def test_to_int_device_bit_exact(width):
    rng = np.random.default_rng(width)
    v = rng.uniform(-1.2, 1.2, 5000).astype(np.float32)
    mx = {1: 127.0, 2: 32767.0, 4: 2147483647.0}[width]
    # ties (round half to even), the ends, and far out of range
    v[:12] = [0.0, 1.0, -1.0, 0.5 / mx, 1.5 / mx, 2.5 / mx, -0.5 / mx,
              -1.5 / mx, 1.00001, -1.00001, 3.0e9, -3.0e9]
    got = TG.to_int_device(torch.from_numpy(v), width)
    want = np.asarray(JG.to_int_device(jnp.asarray(v), width))
    assert got.numpy().dtype == want.dtype
    np.testing.assert_array_equal(got.numpy(), want)
    np.testing.assert_array_equal(
        TE.to_int_samples(torch.from_numpy(v), width).numpy(),
        np.asarray(JE.to_int_samples(jnp.asarray(v), width)))


BIQUADS = [
    ("lowpass", 1000.0, 0.7071, 2),
    ("lowpass", 3000.0, 2.0, 3),
    ("lowpass", 500.0, 8.0, 16),         # strong resonance: wider budget
    ("highpass", 2000.0, 1.0, 2),
    ("highpass", 300.0, 0.7071, 16),     # poles near the unit circle
    ("bandpass", 800.0, 4.0, 3),
]


@pytest.mark.parametrize("kind,fc,q,tol", BIQUADS)
def test_biquad_within_oracle_budget(kind, fc, q, tol):
    src = JS.Osc("sawtooth", 330.0, 0.8)
    want = go.render_oracle(JS.Biquad(src, kind, fc, q), SR // 2, SR)
    got = render(TS.Biquad(TS.Osc("sawtooth", 330.0, 0.8), kind, fc, q),
                 SR // 2)
    d = np.abs(q16(got) - q16(want))
    assert d.max() <= tol, f"max {d.max()} LSB"


@pytest.mark.parametrize("kind,q,tol", [("lowpass", 0.7071, 3),
                                        ("lowpass", 4.0, 6),
                                        ("highpass", 1.0, 6),
                                        ("bandpass", 2.0, 6)])
def test_swept_biquad_within_oracle_budget(kind, q, tol):
    def node(S):
        return S.Biquad(S.Osc("sawtooth", 110.0, 0.8), kind, 800.0, q,
                        cutoff_lfo=S.Osc("sine", 0.5, amplitude=2.0))
    want = go.render_oracle(node(JS), SR // 2, SR)
    d = np.abs(q16(render(node(TS), SR // 2)) - q16(want))
    assert d.max() <= tol, f"max {d.max()} LSB"


def test_biquad_blocksize_near_invariance():
    node = TS.Biquad(TS.Osc("sawtooth", 330.0, 0.8), "lowpass", 700.0, 2.0)
    a = render(node, 30000, 512)
    b = render(node, 30000, 8192)
    assert np.abs(a - b).max() < 3.0 / 32767


@pytest.mark.parametrize("n", [1, 2, 3, 64, 1000, 2049])
def test_companion_scan_against_sequential_recurrence(n):
    rng = np.random.default_rng(n)
    u = rng.uniform(-1, 1, n).astype(np.float32)
    b0, b1, b2, a1, a2 = TS.biquad_coeffs("lowpass", 2000.0, 1.0, SR)
    y1, y2 = 0.3, -0.2
    want = np.zeros(n)
    p1, p2 = y1, y2
    for i in range(n):
        want[i] = u[i] - np.float32(a1) * p1 - np.float32(a2) * p2
        p1, p2 = want[i], p1
    got = TE.companion_scan(torch.from_numpy(u), a1, a2, y1, y2).numpy()
    assert got.shape == (n,)
    np.testing.assert_allclose(got, want, atol=2e-5)
    if n == 64:     # one size through the reference's scan (it compiles)
        ref = jax.jit(JE.companion_scan)(jnp.asarray(u), jnp.float32(a1),
                                         jnp.float32(a2), y1, y2)
        np.testing.assert_allclose(got, np.asarray(ref), atol=2e-5)
    # per-sample coefficients (the swept filter's form)
    a1v = torch.full((n,), a1, dtype=torch.float32)
    a2v = torch.full((n,), a2, dtype=torch.float32)
    np.testing.assert_array_equal(
        TE.companion_scan(torch.from_numpy(u), a1v, a2v, y1, y2).numpy(), got)


def test_streaming_equals_offline():
    node = PT["echo"]
    off = render(node, 512 * 9, 8192)
    blocks = []
    for blk in TG.block_stream(node, SR, 512, device="cpu"):
        assert blk.dtype == np.float32 and not blk.flags.writeable
        blocks.append(blk)
        if len(blocks) == 9:
            break
    np.testing.assert_array_equal(np.concatenate(blocks), off)
    ints = []
    for blk in TG.int_block_stream(node, SR, 512, 2, device="cpu"):
        ints.append(blk)
        if len(ints) == 9:
            break
    want = TG.to_int_device(torch.from_numpy(off), 2).numpy()
    assert ints[0].dtype == np.int16
    np.testing.assert_array_equal(np.concatenate(ints), want)
    # and against the reference's stream
    ref = []
    for blk in JG.int_block_stream(PJ["echo"], SR, 512, 2):
        ref.append(np.asarray(blk))
        if len(ref) == 9:
            break
    assert np.abs(np.concatenate(ints).astype(int)
                  - np.concatenate(ref).astype(int)).max() <= 1


def test_blocks_handed_out_stay_valid():
    """No step writes into a tensor it has handed out: a block (here a view
    of the delay line) is unchanged after later blocks were rendered."""
    stream = TG.device_block_stream(PT["delay_long"], SR, 512, device="cpu")
    first = next(stream)
    keep = first.clone()
    for _ in range(20):
        next(stream)
    assert torch.equal(first, keep)


def _host_patch(S, G, pull):
    key = G.new_host_key()
    G.register_host_source(key, lambda: pull)
    node = S.Envelope(S.Mix((S.HostSource(key), S.Osc("sine", 440.0, 0.2))),
                      0.01, 0.01, 0.2, 0.7, 0.05)
    return key, node


def _tone(n0, nframes, total):
    n = np.arange(n0, min(n0 + nframes, total))
    return (0.5 * np.sin(2 * np.pi * 220.0 * n / SR)).astype(np.float32)


def test_host_source_patch_matches_reference():
    total = 512 * 6
    kt, nt = _host_patch(TS, TG, lambda n0, k: _tone(n0, k, 10 ** 9))
    kj, nj = _host_patch(JS, JG, lambda n0, k: _tone(n0, k, 10 ** 9))
    try:
        got = TG.render_patch(nt, total, SR, 512, device="cpu").numpy()
        ref = np.asarray(JG.render_patch(nj, total, SR, 512))
        assert got.shape == (total,)
        assert np.abs(q16(got) - q16(ref)).max() <= 1
        with pytest.raises(ValueError, match="host-source"):
            TG.patch_values(nt, total, SR, 512, device="cpu")
    finally:
        TG.unregister_host_source(kt)
        JG.unregister_host_source(kj)
    with pytest.raises(ValueError, match="not registered"):
        next(TG.block_stream(nt, SR, 512, device="cpu"))


@pytest.mark.parametrize("total,nblocks,why", [
    (512 * 3, 3, "a None pull stops before the block"),
    (512 * 2 + 100, 3, "a short pull emits one zero-padded block"),
])
def test_host_source_stream_ends(total, nblocks, why):
    def pull(n0, k):
        blk = _tone(n0, k, total)
        return blk if len(blk) else None
    kt, nt = _host_patch(TS, TG, pull)
    kj, nj = _host_patch(JS, JG, pull)
    try:
        got = list(TG.block_stream(nt, SR, 512, device="cpu"))
        ref = [np.asarray(b) for b in JG.block_stream(nj, SR, 512)]
        assert len(got) == len(ref) == nblocks, why
        assert all(len(b) == 512 for b in got)
        assert np.abs(q16(np.concatenate(got))
                      - q16(np.concatenate(ref))).max() <= 1
        # offline: the source ended early, the rest is zeros
        off = TG.render_patch(nt, 512 * 5, SR, 512, device="cpu").numpy()
        assert off.shape == (512 * 5,)
        np.testing.assert_array_equal(off[:512 * nblocks],
                                      np.concatenate(got))
        assert not off[512 * nblocks:].any()
    finally:
        TG.unregister_host_source(kt)
        JG.unregister_host_source(kj)


def test_entry_points_default_to_the_card():
    if torch.cuda.is_available():
        pytest.skip("this check is for a machine without a CUDA device")
    node = PT["sine"]
    for call in (lambda: TG.render_patch(node, 16, SR),
                 lambda: TG.patch_values(node, 16, SR),
                 lambda: next(TG.block_stream(node, SR)),
                 lambda: next(TG.int_block_stream(node, SR, 512, 2)),
                 lambda: TG.lower(node, SR, 512)):
        with pytest.raises(RuntimeError, match="device='cpu'"):
            call()
