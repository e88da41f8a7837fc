"""Randomized op-chain fuzzing of the port: ``Sample(device="cpu")`` against
the goldref oracle.

The counterpart of ``tests/test_fuzz_chains.py`` with its seeds, op pool
and per-op tolerance accounting (exact ops add 0, gain-ramp ops 1 LSB
each, amplify_max and echo multiply the running tolerance, the effects add
their goldref budget after multiplying what came in).  The two tests of
the reference's lazy IR (``test_staged_metadata_consistency``,
``test_auto_materialize_bounds_pending``) have no counterpart: the port's
``Sample`` is eager.  ``test_nested_subprogram_trees`` keeps its numbers.
"""

import numpy as np
import pytest

import goldref.sample as gs
from synthesizer_tpu_torch.sample import Sample

SR = 44100
CPU = "cpu"

# amplify_max and echo amplify an existing difference instead of adding
# their own (the reference's accounting, tests/test_fuzz_chains.py)
AMPMAX_GAIN = 12
ECHO_GAIN = 3       # 1 + amount taps (amount=2 below)
FX_MULT = {"chorus": 2, "compress": 2, "compress_sc": 2, "reverb": 2,
           "convolve": 2, "filter": 2, "gate": 2, "compress_knee": 2,
           "tremolo": 1, "autopan": 1, "hq_resample": 2, "hq_speed": 2}
FX_COST = {"chorus": 2, "compress": 2, "compress_sc": 2, "reverb": 4,
           "convolve": 8, "filter": 4, "gate": 2, "compress_knee": 2,
           "tremolo": 0, "autopan": 0, "hq_resample": 1, "hq_speed": 1}


def _fuzz_convolve(s):
    # a tiny 3-tap IR at the sample's current rate
    ir = np.zeros((40, 1), np.int16)
    ir[0, 0], ir[7, 0], ir[25, 0] = 26000, -9000, 4000
    if isinstance(s, gs.Sample):
        return s.convolve(gs.Sample(ir, s.samplerate, 2, 1), wet=0.4, dry=0.6)
    return s.convolve(Sample.from_raw_frames(ir.tobytes(), 2, s.samplerate,
                                             1, device=CPU),
                      wet=0.4, dry=0.6)


def _fuzz_compress_sc(s):
    """Sidechain ducking with a pulse-train key at the sample's rate."""
    key = np.zeros((800, 1), np.int16)
    key[::200] = 24000
    kw = dict(threshold_db=-20.0, ratio=6.0, attack=0.001, release=0.02)
    if isinstance(s, gs.Sample):
        return s.compress(sidechain=gs.Sample(key, s.samplerate, 2, 1),
                          **kw)
    return s.compress(sidechain=Sample.from_raw_frames(
        key.tobytes(), 2, s.samplerate, 1, device=CPU), **kw)


OPS = [
    ("amplify", lambda s: s.amplify(0.7), 0),
    ("amplify_neg", lambda s: s.amplify(-0.4), 0),
    ("amplify_max", lambda s: s.amplify_max(), 0),
    ("invert", lambda s: s.invert(), 0),
    ("bias", lambda s: s.bias(321), 0),
    ("clip", lambda s: s.clip(0.001, 0.08), 0),
    ("cut", lambda s: s.cut(0.002, 0.004), 0),
    ("silence", lambda s: s.add_silence(0.003), 0),
    ("silence0", lambda s: s.add_silence(0.002, at_start=True), 0),
    ("reverse", lambda s: s.reverse(), 0),
    ("delayk", lambda s: s.delay(0.002, keep_length=True), 0),
    ("fadein", lambda s: s.fadein(0.01), 1),
    ("fadeout", lambda s: s.fadeout(0.01, 0.2), 1),
    ("envelope", lambda s: s.envelope(0.005, 0.01, 0.6, 0.01), 1),
    ("echo", lambda s: s.echo(0.09, 2, 0.013, 0.5), 0),
    ("resample_up", lambda s: s.resample(48000), 0),
    ("resample_down", lambda s: s.resample(22050), 0),
    ("speed", lambda s: s.speed(1.25), 0),
    ("hq_resample", lambda s: s.resample(48000, quality="hq"), 0),
    ("hq_speed", lambda s: s.speed(0.8, quality="hq"), 0),
    ("chorus", lambda s: s.chorus(rate=2.0, depth=0.002, delay=0.01,
                                  wet=0.4), 0),
    ("compress", lambda s: s.compress(threshold_db=-18.0, ratio=3.0,
                                      attack=0.002, release=0.05), 0),
    ("compress_sc", lambda s: _fuzz_compress_sc(s), 0),
    ("reverb", lambda s: s.reverb(roomsize=0.6, damping=0.5, wet=0.25,
                                  dry=0.7, tail=0.03), 0),
    ("convolve", _fuzz_convolve, 0),
    ("filter", lambda s: s.filter("lowpass", 1200.0, q=1.2), 0),
    ("gate", lambda s: s.gate(threshold_db=-30.0, range_db=40.0), 0),
    ("compress_knee", lambda s: s.compress(threshold_db=-20.0, ratio=5.0,
                                           knee_db=9.0), 0),
    ("tremolo", lambda s: s.tremolo(rate=4.0, depth=0.6), 0),
    ("autopan", lambda s: s.autopan(rate=1.5, depth=0.8), 0),
]


def make_pair(rng, n=3000):
    a = rng.integers(-15000, 15000, size=(n, 2)).astype(np.int16)
    return (gs.Sample(a.copy(), SR, 2, 2),
            Sample.from_raw_frames(a.tobytes(), 2, SR, 2, device=CPU))


def _step(tol, name, cost):
    if name == "amplify_max":
        return tol * AMPMAX_GAIN
    if name == "echo":
        return tol * ECHO_GAIN
    if name in FX_MULT:
        return tol * FX_MULT[name] + FX_COST[name]
    return tol + cost


def _assert_within(dev, gold, tol, names):
    got = dev.get_frame_array()
    assert got.shape == gold.frames.shape, f"chain {names}"
    d = np.abs(got.astype(np.int64) - gold.frames.astype(np.int64))
    dmax = d.max() if d.size else 0
    assert dmax <= max(tol, 0), f"chain {names}: max diff {dmax} > tol {tol}"


@pytest.mark.parametrize("seed", range(12))
def test_random_chain(seed):
    rng = np.random.default_rng(seed)
    gold, dev = make_pair(rng)
    tol = 0
    names = []
    for _ in range(7):
        name, fn, cost = OPS[rng.integers(len(OPS))]
        names.append(name)
        fn(gold)
        fn(dev)
        tol = _step(tol, name, cost)
        if gold.nframes == 0:
            break
    _assert_within(dev, gold, tol, names)


@pytest.mark.parametrize("seed", range(6))
def test_random_chain_from_synth_source(seed):
    """Chains over a WaveSynth-made sample against oracle-rendered goldref
    twins; the source adds <= 1 LSB (the turn-unit sine against np.sin),
    a patch-modulator op (pan / modulate_amp with an oscillator) 1 LSB."""
    import goldref.osc as go
    import goldref.spec as gS
    from synthesizer_tpu_torch import WaveSynth
    from synthesizer_tpu_torch import oscillators as oscm
    rng = np.random.default_rng(seed + 500)
    kind = ["sine", "triangle", "sawtooth_bl", "pointy"][seed % 4]
    freq = float(rng.uniform(100, 900))
    ws = WaveSynth(samplerate=SR, samplewidth=2, device=CPU)
    dev = getattr(ws, kind)(freq, 0.07, amplitude=0.8).stereo()
    src = go.to_int_samples(go.render_oracle(
        gS.Osc(kind, freq, 0.8), int(0.07 * SR), SR), 2)
    gold = gs.Sample(np.repeat(src[:, None], 2, axis=1), SR, 2, 2)
    tol = 1
    names = [kind]
    for _ in range(5):
        if rng.random() < 0.25 and gold.nframes:
            lfreq = float(rng.uniform(0.5, 5.0))
            lamp = float(rng.uniform(0.2, 0.8))
            gains = go.render_oracle(gS.Osc("sine", lfreq, lamp),
                                     gold.nframes, SR)
            lfo = oscm.Sine(lfreq, amplitude=lamp, samplerate=SR)
            if rng.random() < 0.5:
                names.append("pan_osc")
                gold.pan(lfo=gains)
                dev.pan(lfo=lfo)
            else:
                names.append("modamp_osc")
                gold.modulate_amp(gains)
                dev.modulate_amp(lfo)
            tol += 1
            continue
        name, fn, cost = OPS[rng.integers(len(OPS))]
        names.append(name)
        fn(gold)
        fn(dev)
        tol = _step(tol, name, cost)
        if gold.nframes == 0:
            break
    _assert_within(dev, gold, tol, names)


def test_chain_with_mixes(rng):
    gold_a, dev_a = make_pair(rng)
    gold_b, dev_b = make_pair(rng, n=2000)
    gold_a.amplify(0.6).mix_at(0.01, gold_b).fadeout(0.01).amplify_max()
    dev_a.amplify(0.6).mix_at(0.01, dev_b).fadeout(0.01).amplify_max()
    d = np.abs(dev_a.get_frame_array().astype(np.int64)
               - gold_a.frames.astype(np.int64))
    assert d.max() <= 2  # fadeout + amplify_max after float ops


@pytest.mark.parametrize("width", [1, 4])
def test_chains_other_widths(rng, width):
    """8-bit and 32-bit chains match the oracle too."""
    lo = -100 if width == 1 else -2_000_000
    hi = 100 if width == 1 else 2_000_000
    a = rng.integers(lo, hi, size=(2000, 2)).astype(gs._DTYPES[width])
    gold = gs.Sample(a.copy(), SR, width, 2)
    dev = Sample.from_raw_frames(a.tobytes(), width, SR, 2, device=CPU)
    for s in (gold, dev):
        s.amplify(0.5).add_silence(0.002).reverse().bias(3)
        s.resample(22050).fadeout(0.01)
    got = dev.get_frame_array().astype(np.int64)
    want = gold.frames.astype(np.int64)
    assert got.shape == want.shape
    assert np.abs(got - want).max() <= (1 if width == 1 else 256)


@pytest.mark.parametrize("seed", range(4))
def test_nested_subprogram_trees(seed):
    """Mixes of mixes: the port's eager tree against the oracle's."""
    rng = np.random.default_rng(seed + 7000)

    def build(depth):
        gold, dev = make_pair(rng, n=int(rng.integers(1500, 2500)))
        gold.amplify(0.5).fadeout(0.01)
        dev.amplify(0.5).fadeout(0.01)
        if depth > 0:
            for _ in range(int(rng.integers(1, 3))):
                g2, d2 = build(depth - 1)
                at = float(rng.uniform(0, 0.02))
                gold.mix_at(at, g2)
                dev.mix_at(at, d2)
        return gold, dev

    gold, dev = build(2)
    got = dev.get_frame_array().astype(np.int64)
    want = gold.frames.astype(np.int64)
    assert got.shape == want.shape
    # every node contributes <= 1 LSB (fadeout); the tree has <= 7 nodes
    assert np.abs(got - want).max() <= 7
