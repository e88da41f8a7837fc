"""The port's ``[fx]`` rack (``synthesizer_tpu_torch.effects``) against the
JAX package's ``effects`` module, on the CPU, on seeded int16 chunks.

Each streaming processor is fed the same chunks in both packages and held
within its effect's budget (``ops.effects.BUDGETS``, at 16 bit); where the
reference promises it, the port's chunked output is also held against its
own whole-signal output.  ``interp`` is held against ``jnp.interp`` bit for
bit, and the spec parsers against the reference's results and errors.
"""

import math

import numpy as np
import pytest
import torch

import jax.numpy as jnp
from synthesizer_tpu import effects as JE
from synthesizer_tpu.ops import effects as JF
from synthesizer_tpu_torch import effects as TE
from synthesizer_tpu_torch.ops import effects as TF
from synthesizer_tpu_torch.ops.effects import BUDGETS
from synthesizer_tpu_torch.ops.wave import interp
from synthesizer_tpu_torch.sample import Sample

torch.set_num_threads(2)

SR = 44100
N = 6000
CHUNK = 1500
TICKF = 1500.0


def _signal(n=N, seed=0):
    rng = np.random.default_rng(seed)
    t = np.arange(n) / SR
    sig = 0.5 * np.sin(2 * np.pi * 220 * t)[:, None] * np.exp(-t * 3)[:, None] \
        + 0.15 * rng.standard_normal((n, 2))
    sig[n // 3:n // 2] *= 0.02                  # a quiet stretch
    return np.clip(np.rint(sig * 32767), -32768, 32767).astype(np.int16)


X = _signal()
KEY = _signal(seed=9)
CURVE = [(0.0, 0.2), (2.0, 0.9), (3.5, 0.4)]


def _lsb(a, b):
    a, b = np.asarray(a), np.asarray(b)
    assert a.shape == b.shape, (a.shape, b.shape)
    return int(np.abs(a.astype(np.int64) - b.astype(np.int64)).max())


def _run_jax(proc, x=X, chunk=CHUNK):
    return np.concatenate([np.asarray(proc.process(jnp.asarray(x[i:i + chunk])))
                           for i in range(0, len(x), chunk)])


def _run_port(proc, x=X, chunk=CHUNK):
    return np.concatenate([proc.process(torch.from_numpy(
        np.ascontiguousarray(x[i:i + chunk]))).numpy()
        for i in range(0, len(x), chunk)])


def _keys():
    def jkey(n0, n):
        return jnp.asarray(KEY[n0:n0 + n])

    def tkey(n0, n):
        return torch.from_numpy(np.ascontiguousarray(KEY[n0:n0 + n]))
    return jkey, tkey


# (name, budget key, constructor(module) -> processor, whole == chunked
# within the budget)
def _c(mod, cls, *args, **kw):
    if mod is TE:
        kw["device"] = "cpu"
    return getattr(mod, cls)(*args, **kw)


PROCS = {
    "compress": ("compress", lambda m: _c(m, "StreamingCompressor", SR, -18.0,
                                          4.0, 0.003, 0.08, 3.0)),
    "compress_knee_curves": ("compress", lambda m: _c(
        m, "StreamingCompressor", SR, -18.0, 4.0, knee_db=6.0,
        makeup_curve=[(0, 0.0), (3, 4.0)],
        threshold_curve=[(0, -30.0), (3, -10.0)],
        ratio_curve=[(0, 2.0), (3, 8.0)], knee_curve=[(0, 2.0), (3, 10.0)],
        tickf=TICKF)),
    "compress_grids": ("compress", lambda m: _c(
        m, "StreamingCompressor", SR, -20.0, 4.0,
        attack_curve=[(0, 0.001), (3, 0.02)],
        release_curve=[(0, 0.05), (3, 0.3)], tickf=TICKF, start_frame=300)),
    "compress_sidechain": ("compress", lambda m: _c(
        m, "StreamingCompressor", SR, -24.0, 6.0,
        key_fn=_keys()[0 if m is JE else 1])),
    "biquad_ff": ("filter", lambda m: _c(m, "StreamingBiquad", SR, 2,
                                         "lowshelf", 60.0, 0.7071, 6.0)),
    "swept_biquad": ("filter", lambda m: _c(
        m, "SweptStreamingBiquad", SR, 2, "lowpass", 0.7071,
        [(0, 300.0), (2, 5000.0), (4, 1200.0)], TICKF)),
    "swept_gain_kind": ("filter", lambda m: _c(
        m, "SweptGainKindBiquad", SR, 2, "peaking", 1.2, 5.0,
        [(0, 200.0), (4, 4000.0)], TICKF)),
    "eq_curves": ("eq", lambda m: _c(
        m, "StreamingEQ", SR, 2, low_db=3.0, high_db=-4.0,
        mid_curve=[(0, -6.0), (3, 6.0)], low_curve=[(0, 0.0), (2, 5.0)],
        tickf=TICKF)),
    "gate": ("gate", lambda m: _c(m, "StreamingGate", SR, -30.0, 60.0)),
    "gate_curve": ("gate", lambda m: _c(
        m, "StreamingGate", SR, threshold_curve=[(0, -40.0), (3, -15.0)],
        tickf=TICKF)),
    "reverb": ("reverb", lambda m: _c(m, "StreamingReverb", SR, 2)),
    "reverb_curves": ("reverb", lambda m: _c(
        m, "StreamingReverb", SR, 2, wet_curve=CURVE,
        roomsize_curve=[(0, 0.2), (3, 0.9)], tickf=TICKF, start_frame=700)),
    "chorus": ("chorus", lambda m: _c(m, "StreamingChorus", SR, 2)),
    "chorus_curves": ("chorus", lambda m: _c(
        m, "StreamingChorus", SR, 2, dry_curve=CURVE,
        rate_curve=[(0, 0.5), (3, 3.0)], depth_curve=[(0, 0.001), (3, 0.004)],
        tickf=TICKF, start_frame=4000)),
    "convolve": ("convolve", lambda m: _c(
        m, "StreamingConvolver", (np.random.default_rng(3).standard_normal(
            (300, 2)) * np.exp(-np.arange(300) / 60.0)[:, None] * 0.3
        ).astype(np.float32), 0.6, 0.8)),
    "echo": ("feedback_echo", lambda m: _c(m, "StreamingFeedbackEcho", SR,
                                           2, 0.01, 0.5, 0.6)),
    "echo_curves": ("feedback_echo", lambda m: _c(
        m, "StreamingFeedbackEcho", SR, 2, 0.02,
        feedback_curve=[(0, 0.1), (3, 0.8)], wet_curve=CURVE, tickf=TICKF)),
    "width": ("stereo_width", lambda m: _c(m, "StreamingWidth", SR, 2, 1.8)),
    "width_curve": ("stereo_width", lambda m: _c(
        m, "StreamingWidth", SR, 2, amount_curve=[(0, 0.0), (3, 3.0)],
        tickf=TICKF)),
    "limiter": ("limit", lambda m: _c(m, "StreamingLimiter", SR, 2, -6.0)),
    "limiter_curves": ("limit", lambda m: _c(
        m, "StreamingLimiter", SR, 2, ceiling_curve=[(0, -12.0), (3, -1.0)],
        release_curve=[(0, 0.01), (3, 0.2)], tickf=TICKF)),
    "phaser": ("phaser", lambda m: _c(m, "StreamingPhaser", SR, 2)),
    "phaser_curves": ("phaser", lambda m: _c(
        m, "StreamingPhaser", SR, 2, min_freq=200.0, stages=3,
        wet_curve=CURVE, rate_curve=[(0, 0.3), (3, 2.0)],
        depth_curve=[(0, 0.5), (3, 1.0)], tickf=TICKF, start_frame=900)),
    "tremolo": ("tremolo", lambda m: _c(m, "StreamingTremolo", SR, 2,
                                        start_frame=500)),
    "tremolo_curves": ("tremolo", lambda m: _c(
        m, "StreamingTremolo", SR, 2, rate_curve=[(0, 2.0), (3, 9.0)],
        depth_curve=[(0, 0.2), (3, 0.9)], tickf=TICKF, start_frame=2000)),
    "autopan": ("autopan", lambda m: _c(m, "StreamingAutopan", SR, 2)),
}


@pytest.mark.parametrize("name", list(PROCS))
def test_processor_matches_jax(name):
    budget_key, make = PROCS[name]
    want = _run_jax(make(JE))
    got = _run_port(make(TE))
    assert want.shape == got.shape
    assert np.abs(got.astype(np.int64)).max() > 100
    assert _lsb(want, got) <= BUDGETS[budget_key], _lsb(want, got)


@pytest.mark.parametrize("name", ["compress", "compress_grids", "gate",
                                  "echo_curves", "width_curve", "limiter",
                                  "tremolo_curves", "chorus_curves",
                                  "reverb", "phaser"])
def test_chunked_equals_whole(name):
    """The same processor fed 1500-frame chunks and the whole signal:
    within its budget (the scans regroup at chunk boundaries); the
    stateless and host-grid effects bit for bit."""
    budget_key, make = PROCS[name]
    chunked = _run_port(make(TE))
    whole = _run_port(make(TE), chunk=N)
    d = _lsb(chunked, whole)
    exact = name in ("echo_curves", "width_curve", "tremolo_curves",
                     "chorus_curves")
    assert d == 0 if exact else d <= BUDGETS[budget_key], d


def test_limiter_holds_back_its_lookahead():
    lim = TE.StreamingLimiter(SR, 2, -3.0, lookahead=0.005, device="cpu")
    L = lim.flush_frames
    out = lim.process(torch.from_numpy(X[:100]))
    assert out.shape[0] == 0 and L == int(0.005 * SR)
    out = lim.process(torch.from_numpy(X[100:1000]))
    assert out.shape[0] == 1000 - L


FX_SPEC = [("compress", dict(threshold_db=-15.0, ratio=4.0, attack=0.003)),
           ("filter", dict(kind="lowpass", cutoff=2500.0)),
           ("eq", dict(low_db=2.0, mid_db=-3.0)),
           ("reverb", dict(roomsize=0.6, wet=0.2, tail=0.05)),
           ("chorus", dict(rate=1.1)),
           ("echo", dict(delay=0.01, feedback=0.3, wet=0.2)),
           ("width", dict(amount=1.4)),
           ("phaser", dict(stages=2)),
           ("tremolo", dict(rate=4.0, depth=0.3)),
           ("limiter", dict(ceiling_db=-2.0))]
AUTO = {"fx.filter.cutoff": [(0, 500.0), (3, 6000.0)],
        "fx.reverb.wet": CURVE, "fx.chorus.depth": [(0, 0.001), (3, 0.003)],
        "fx.compress.release": [(0, 0.05), (3, 0.2)],
        "fx.echo.feedback": [(0, 0.2), (3, 0.6)],
        "fx.tremolo.rate": [(0, 2.0), (3, 6.0)]}
CHAIN_BOUND = sum(BUDGETS[k] for k in (
    "compress", "filter", "eq", "reverb", "chorus", "feedback_echo",
    "stereo_width", "phaser", "tremolo", "limit"))


@pytest.mark.parametrize("auto", [None, AUTO], ids=["static", "automated"])
def test_fx_chain_matches_jax(auto):
    """FxChain streaming against the JAX FxChain, and the port's offline
    apply_fx_sample against its own stream: within the chain's summed
    budgets."""
    jc = JE.FxChain(FX_SPEC, SR, 2, automation=auto, tickf=TICKF)
    tc = TE.FxChain(FX_SPEC, SR, 2, automation=auto, tickf=TICKF,
                    device="cpu")
    assert (jc.tail_frames, jc.flush_frames) == \
        (tc.tail_frames, tc.flush_frames)
    want = _run_jax(jc)
    got = _run_port(tc)
    assert _lsb(want, got) <= CHAIN_BOUND
    pad = np.zeros((tc.tail_frames + tc.flush_frames, 2), np.int16)
    stream = np.concatenate([got, _run_port(tc, pad, chunk=len(pad))])
    smp = Sample.from_array(X, SR, 2, device="cpu")
    TE.apply_fx_sample(smp, FX_SPEC, automation=auto, tickf=TICKF)
    off = smp.get_frame_array()
    assert off.shape == stream.shape == (N + tc.tail_frames, 2)
    assert _lsb(off, stream) <= CHAIN_BOUND


def test_offline_chain_matches_jax():
    """apply_fx_sample on both packages, the automated entries included,
    and a convolve and sidechain compressor entry."""
    from synthesizer_tpu.sample import Sample as JS
    rng = np.random.default_rng(5)
    ir = np.clip(rng.standard_normal((200, 2)) * 3000
                 * np.exp(-np.arange(200) / 40.0)[:, None], -32768,
                 32767).astype(np.int16)
    spec = [FX_SPEC[0], FX_SPEC[3],
            ("convolve", dict(ir="ir", wet=0.5, dry=0.9)),
                          ("compress", dict(threshold_db=-20.0,
                                            sidechain="kick"))]
    outs = []
    for mod, S, kw in ((JE, JS, {}), (TE, Sample, {"device": "cpu"})):
        smp = S.from_array(X, SR, 2, **kw)
        key = S.from_array(np.concatenate([KEY, KEY]), SR, 2, **kw)
        irs = {"ir": S.from_array(ir, SR, 2, **kw)}
        auto = {k: v for k, v in AUTO.items() if "compress" not in k}
        mod.apply_fx_sample(smp, spec, irs, automation=auto, tickf=TICKF,
                            sidechain_keys={"kick": key})
        outs.append(smp.get_frame_array())
    assert _lsb(*outs) <= (2 * BUDGETS["compress"] + BUDGETS["reverb"]
                           + BUDGETS["convolve"])


def test_chain_errors_match_jax():
    for spec, kw in (([("compress", dict(sidechain="nope"))], {}),
                     ([("compress", dict(sidechain="k"))],
                      dict(automation={"fx.compress.ratio": [(0, 2.0)]},
                           tickf=TICKF, sidechain_keys={"k": _keys()[1]})),
                     ([("filter", dict(kind="lowpass", cutoff=100.0))],
                      dict(automation={"fx.filter.cutoff": [(0, 1.0)]})),
                     ([("echo", dict(delay=0.01, feedback=0.99))], {}),
                     ([("width", dict(amount=1.0))], {})):
        msgs = []
        for mod, extra in ((JE, {}), (TE, {"device": "cpu"})):
            nch = 1 if spec[0][0] == "width" else 2
            with pytest.raises(ValueError) as err:
                mod.FxChain(spec, SR, nch, **kw, **extra)
            msgs.append(str(err.value))
        assert msgs[0] == msgs[1], msgs


SPECS = [
    [("reverb", "roomsize=0.8 wet=0.3 tail=1.2"), ("echo", "beats=0.5")],
    [("chorus", "rate_beats=2 voices=4"), ("filter", "kind=peaking "
                                                     "cutoff=1000 gain_db=3")],
    [("compress", "threshold_db=-10 sidechain=kick knee_db=3")],
    [("convolve", "ir=hall.wav wet=0.4")],
]
BAD_SPECS = [
    [("wobble", "x=1")], [("reverb", "size=1")], [("reverb", "wet")],
    [("convolve", "wet=1")], [("filter", "kind=lowpass")],
    [("filter", "kind=notch cutoff=100")], [("echo", "feedback=0.1")],
    [("echo", "delay=0.1 beats=1")], [("width", "")],
    [("chorus", "rate=1 rate_beats=2")], [("phaser", "stages=2.5")],
]


@pytest.mark.parametrize("items", SPECS)
def test_parse_fx_items_matches_jax(items):
    assert JE.parse_fx_items(items) == TE.parse_fx_items(items)


@pytest.mark.parametrize("items", BAD_SPECS)
def test_parse_fx_items_errors_match_jax(items):
    msgs = []
    for mod in (JE, TE):
        with pytest.raises(ValueError) as err:
            mod.parse_fx_items(items)
        msgs.append(str(err.value))
    assert msgs[0] == msgs[1]


def test_fx_tables_match_jax():
    assert TE.FX_PARAMS == JE.FX_PARAMS
    assert TE.HOLDBACK_FX == JE.HOLDBACK_FX
    assert TE.FILTER_KINDS == JE.FILTER_KINDS
    assert TE.DEFAULT_REVERB_TAIL == JE.DEFAULT_REVERB_TAIL
    auto = {k: [(0, 1.0)] for k in ("fx.filter.cutoff", "fx.echo.wet",
                                    "fx.compress.knee_db", "fx.autopan.rate")}
    assert TE._fx_curves(auto) == JE._fx_curves(auto)


def test_chain_tail_and_flush_frames_match_jax():
    class Ir:
        nframes = 321
    fx = [("reverb", dict(tail=0.7)), ("reverb", {}),
          ("echo", dict(delay=0.2, feedback=0.5, wet=0.4)),
          ("echo", dict(delay=0.1, tail=0.3)), ("convolve", dict(ir="a")),
          ("limiter", dict(lookahead=0.01)), ("limiter", {})]
    for sr in (22050, 44100, 48000):
        assert TE.chain_tail_frames(fx, sr, {"a": Ir()}) == \
            JE.chain_tail_frames(fx, sr, {"a": Ir()})
        assert TE.chain_flush_frames(fx, sr) == JE.chain_flush_frames(fx, sr)
    msgs = []
    for mod in (JE, TE):
        with pytest.raises(ValueError) as err:
            mod.chain_tail_frames([("echo", dict(beats=1.0))], SR)
        msgs.append(str(err.value))
    assert msgs[0].replace("—", "--") == msgs[1]


def test_processors_default_to_the_card():
    if torch.cuda.is_available():
        pytest.skip("a card is present")
    for make in (lambda **kw: TE.StreamingReverb(SR, 2, **kw),
                 lambda **kw: TE.StreamingCompressor(SR, **kw),
                 lambda **kw: TE.StreamingChorus(SR, 2, **kw),
                 lambda **kw: TE.FxChain([("gate", {})], SR, 2, **kw)):
        with pytest.raises(RuntimeError, match="no CUDA device"):
            make()
        make(device="cpu")
    with pytest.raises(TypeError):
        TF.reverb_zero_state((1116,), (556,))       # no default device


def test_interp_matches_jnp_bit_for_bit():
    """On breakpoints, between them, outside them (ends held), a
    zero-width interval and a one-point curve, and at the curve times
    f32(n)/f32(tickf) the automation uses."""
    import jax
    rng = np.random.default_rng(2)
    cases = [([0.0, 16.0, 32.0, 64.0], [1.0, 0.25, 0.8, 0.0]),
             ([0.0, 3.0, 3.0, 5.0], [0.0, 1.0, -1.0, 2.0]),
             ([2.5], [0.7]),
             (sorted(rng.uniform(0, 50, 6)), rng.uniform(-3, 3, 6))]
    tick = np.float32(1234.5678)
    for xp, fp in cases:
        xp = np.asarray(xp, np.float32)
        fp = np.asarray(fp, np.float32)
        n = np.arange(0, 90000, 7, dtype=np.int32)
        x = np.concatenate([xp, xp - 1e-3, xp + 1e-3, [-5.0, 1e6],
                            rng.uniform(-5, 60, 3000),
                            n.astype(np.float32) / tick]).astype(np.float32)
        want = np.asarray(jax.jit(jnp.interp)(x, xp, fp))
        got = interp(torch.from_numpy(x), xp, fp).numpy()
        assert np.array_equal(want.view(np.int32), got.view(np.int32))


def test_chorus_core_with_phase_grid_matches_jax():
    """chorus_core with a cumulative phase grid P and per-frame depth (the
    rate and depth automation) against the JAX chorus_core."""
    from synthesizer_tpu_torch.ops import coeffs as TC
    s = (X[:2000].astype(np.float32) / 32767.0).astype(np.float32)
    hist = (X[2000:2500].astype(np.float32) / 32767.0).astype(np.float32)
    inc = TC.chorus_inc_grid(np.linspace(0.5, 4.0, 2000), SR)
    P, _ = TC.chorus_phase_grid(inc, 12345)
    depth = np.linspace(0.001, 0.004, 2000).astype(np.float32)
    want = np.asarray(JF.chorus_core(
        jnp.asarray(s), 0, jnp.asarray(hist), SR, 0.5, jnp.asarray(depth),
        0.006, 3, 0.4, 1.0, P=jnp.asarray(P.astype(np.int64)
                                          .astype(np.int32))))
    got = TF.chorus_core(torch.from_numpy(s), 0, torch.from_numpy(hist), SR,
                         0.5, torch.from_numpy(depth), 0.006, 3, 0.4, 1.0,
                         P=torch.from_numpy(P.astype(np.int64)))
    d = np.abs(want - got.numpy()).max() * 32767
    assert d <= BUDGETS["chorus"], d
    assert not math.isnan(d)


def test_swept_cutoff_tracks_the_f64_recurrence():
    """A one-second cutoff sweep that ends at a low, resonant cutoff (the
    on-card battery's fx/automation_filter_sweep: 300 -> 6000 -> 300 Hz,
    Q 2): the whole-signal call and 1470-frame chunks stay within 1 LSB of
    the sequential f64 recurrence on the same f32 coefficients (the f32
    scan drifted 10 LSB, past the reference's 8 between streaming and
    offline), and within 8 of each other."""
    n, tickf, q = 46306, SR / 16.0, 2.0
    t = np.arange(n) / SR
    saw = 0.4 * (2.0 * ((130.8128 * t) % 1.0) - 1.0)
    x = np.repeat(np.rint(saw * 32767).astype(np.int16)[:, None], 2, 1)
    xs, vs = TE._curve([(0, 300.0), (8, 6000.0), (16, 300.0)])
    whole, _ = TE.swept_biquad_chunk(torch.from_numpy(x), 0, "lowpass", q,
                                     xs, vs, tickf, SR)
    chunks, state = [], None
    for i in range(0, n, 1470):
        y, state = TE.swept_biquad_chunk(torch.from_numpy(x[i:i + 1470]), i,
                                         "lowpass", q, xs, vs, tickf, SR,
                                         state)
        chunks.append(y.numpy())
    # the oracle: the same f32 cutoff grid and RBJ formulas, the
    # recurrence in f64, frame by frame
    fc = np.clip(np.interp(np.arange(n, dtype=np.float32)
                           / np.float32(tickf), xs, vs).astype(np.float32),
                 10.0, np.float32(0.49 * SR))
    w0 = (np.float32(2.0 * math.pi / SR) * fc).astype(np.float64)
    alpha, cw = np.sin(w0) / (2.0 * q), np.cos(w0)
    b0, b1, a0 = (1 - cw) / 2, 1 - cw, 1 + alpha
    a1, a2 = -2 * cw, 1 - alpha
    s = x[:, 0].astype(np.float64) / 32767.0
    y = np.zeros(n)
    x1 = x2 = y1 = y2 = 0.0
    for i in range(n):
        y[i] = (b0[i] * s[i] + b1[i] * x1 + b0[i] * x2 - a1[i] * y1
                - a2[i] * y2) / a0[i]
        x2, x1, y2, y1 = x1, s[i], y1, y[i]
    want = np.clip(np.rint(y * 32767), -32768, 32767)
    assert _lsb(whole.numpy()[:, 0], want) <= 1
    assert _lsb(np.concatenate(chunks)[:, 0], want) <= 1
    assert _lsb(np.concatenate(chunks), whole.numpy()) <= 8
