"""The tracker song streamed by the port, held to the benchmark's plain
reference (``benchmark/reference/tracker_song.py``) on the CPU, and that
reference's new stages held to sequential oracles (``goldref.effects``
where it has one; a frame-by-frame loop of the published semantics
where it has none).

The song is its short form (patterns ``a b``, about 5 s with its tails)
over a kit made from a seed; the limit is the benchmark cell's own.  The
port's two spans of this song (``effects.biquad``,
``sequencer.sidechain_key``) are held to where they sit in the log.
"""

import json
import math
import os

import numpy as np
import pytest

from benchmark.inputs import tracker_song as T
from benchmark.kinds.song import gap
from benchmark.reference import song as SR_
from benchmark.reference import tracker_song as R
from goldref import effects as G
from synthesizer_tpu_torch.sequencer import Song
from synthesizer_tpu_torch.utils import profiling

SR = 44100
SEED = 2 ** 31 + 20
ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
with open(os.path.join(ROOT, "benchmark", "workloads",
                       "tracker_song.stream.json")) as _f:
    LIMIT = json.load(_f)["limits"]["stream_lsb_gap"]
EXACT = SR_._Prec(False)


@pytest.fixture(scope="module")
def short(tmp_path_factory):
    """(text, kit directory, the port's stream on the CPU)."""
    kitdir = str(tmp_path_factory.mktemp("tracker_kit"))
    T.write(T.make(SEED), kitdir)
    text = T.with_patterns("a b")
    song = Song.from_string(text, kitdir, device="cpu")
    got = np.concatenate([np.array(c.get_frame_array())
                          for c in song.mix_generator(chunk_frames=1470)])
    return text, kitdir, got


@pytest.mark.parametrize("case", ["port_within_limit",
                                  "control_above_limit"])
def test_stream_against_the_reference(short, case):
    """The port's stream lies within the cell's limit of the reference;
    the reference computed with bfloat16 between its stages lies above
    it."""
    text, kitdir, got = short
    want = R.render(text, kitdir)
    if case == "port_within_limit":
        assert len(got) == len(want)
        assert gap(got, want) <= LIMIT
    else:
        assert gap(R.render(text, kitdir, control=True), want) > LIMIT


def _signal(n, seed, f=220.0, amp=0.5):
    rng = np.random.default_rng(seed)
    t = np.arange(n) / SR
    x = amp * np.sin(2 * np.pi * f * t)[:, None] * np.exp(-2 * t)[:, None] \
        + 0.1 * rng.standard_normal((n, 2))
    return np.clip(np.rint(x * 32767), -32768, 32767).astype(np.int16)


def _looped_oracle(w, loop, rate, g, held, tickf):
    """Frame by frame: the read position n * rate, past the loop's end
    cycled through the loop region (float64); gated by the tie length
    plus a linear release fade."""
    ls, le = float(int(loop[0] * SR)), float(int(loop[1] * SR))
    lp = le - ls
    fade = max(1, int(loop[2] * SR))
    gate = held * tickf + fade
    out = []
    n = 0
    while n < gate:
        p = n * rate
        if p > le:
            p = ls + (p - ls) % lp
        p = min(p, len(w) - 1.0)
        i = min(int(p), len(w) - 2)
        v = w[i] + (w[i + 1] - w[i]) * (p - i)
        env = min(1.0, max(0.0, (gate - n) / fade))
        out.append(np.rint(v * g * env))
        n += 1
    return np.asarray(out)


def _sequential_biquad(x16, coeffs):
    """y_n = b0 x_n + b1 x_{n-1} + b2 x_{n-2} - a1 y_{n-1} - a2 y_{n-2},
    coefficients per frame, frame by frame in float64."""
    b0, b1, b2, a1, a2 = (np.broadcast_to(np.asarray(c, np.float64),
                                          (len(x16),)) for c in coeffs)
    s = x16.astype(np.float64) / 32767.0
    out = np.empty_like(s)
    for ch in range(s.shape[1]):
        x1 = x2 = y1 = y2 = 0.0
        for i in range(len(s)):
            y = (b0[i] * s[i, ch] + b1[i] * x1 + b2[i] * x2 - a1[i] * y1
                 - a2[i] * y2)
            x2, x1, y2, y1 = x1, s[i, ch], y1, y
            out[i, ch] = y
    return np.clip(np.rint(out * 32767), -32768, 32767)


def _lsb(a, b):
    assert a.shape == b.shape
    return int(np.abs(np.asarray(a, np.int64) - np.asarray(b, np.int64))
               .max())


@pytest.mark.parametrize("stage", ["looped_sampler", "swept_lowpass",
                                   "fixed_highpass", "sidechain_compressor",
                                   "swept_release", "swept_roomsize"])
def test_reference_stage_against_sequential_oracle(stage):
    n = 3000
    if stage == "looped_sampler":
        # a tonal source, as a sustain loop holds (the float32 read
        # positions stay within a few 2**-12 frames of the float64 cycle)
        w = np.rint(0.5 * 32767 * np.sin(2 * np.pi * 220.0 * np.arange(4410)
                                          / SR)).astype(np.int64)
        w2 = np.stack([w, w], 1)
        g = np.asarray([0.8, 0.6], np.float32)
        rate = 2.0 ** (4 / 12)
        loop = (0.02, 0.08, 0.02)
        idx, got = R._looped(w2, loop, 0, rate, g, 2, 2000.0, 10 ** 6)
        want = np.stack([_looped_oracle(w.astype(np.float64), loop, rate,
                                        float(gc), 2, 2000.0)
                         for gc in g], 1)
        assert len(idx) == len(want) and idx[-1] == len(want) - 1
        assert _lsb(got, want) <= 1
        return
    x = _signal(n, 2)
    if stage in ("swept_lowpass", "fixed_highpass"):
        kind = "lowpass" if stage == "swept_lowpass" else "highpass"
        fc = (np.linspace(900.0, 9000.0, n) if kind == "lowpass"
              else np.full(n, 6000.0))
        coeffs = R.rbj(kind, fc, 0.7071)
        got = R.biquad(x, coeffs, EXACT)
        assert _lsb(got, _sequential_biquad(x, [c.numpy()
                                                for c in coeffs])) <= 1
        if kind == "highpass":
            assert _lsb(got, G.biquad_filter(x, 2, SR, "highpass", 6000.0,
                                             0.7071)) <= 1
        return
    if stage == "swept_roomsize":
        room = np.linspace(0.35, 0.7, n)
        fb = (0.7 + 0.28 * room).astype(np.float32)
        got = R.reverb(x, EXACT, np.full(n, 0.12), np.full(n, 0.95), fb,
                       0.55)
        want = G.reverb(x, 2, SR, damping=0.55, wet=0.12, dry=0.95,
                        feedback_curve=fb)
        assert _lsb(got, want) <= 4
        return
    # the compressor: keyed by another signal, or its release swept
    key = _signal(n, 3, f=55.0, amp=0.9) if stage == "sidechain_compressor" \
        else x
    release = (np.full(n, 0.11) if stage == "sidechain_compressor"
               else np.linspace(0.05, 0.25, n))
    attack = np.full(n, 0.002)
    alpha, decay = R.compressor_coeffs(attack, release)
    got = R.compress(x, R.detector(key), alpha, decay, EXACT, -14.0, 8.0,
                     1.0)
    a = G.sidechain_level(key, 2, n)
    gains = G.compressor_gains_swept(
        a, alpha.astype(np.float32), decay.astype(np.float32), -14.0,
        np.float32(1.0 - 1.0 / 8.0))
    makeup = np.float32(np.exp2(np.float32(1.0) / np.float32(6.0206)))
    want = G._gain_floor(x, (gains * makeup)[:, None], 2)
    assert _lsb(got, want) <= 2
    assert not math.isclose(float(gains.min()), 1.0)


@pytest.mark.parametrize("on", [True, False])
def test_span_log_of_a_chunk(short, on):
    """A chunk's log: the sidechain key under the chunk's root (the pad's
    chain runs inside the chunk), the master lowpass under the master
    chain's ``effects.fx_stream`` root; with the spans off, nothing."""
    text, kitdir, _ = short
    song = Song.from_string(text, kitdir, device="cpu")
    gen = song.mix_generator(chunk_frames=1470)
    next(gen)                                   # the pass's set-up
    profiling.take_spans()
    was = profiling.tracing(on)
    try:
        next(gen)
    finally:
        profiling.tracing(was)
    spans = profiling.take_spans()
    if not on:
        assert spans == []
        return
    by_id = {s.id: s for s in spans}
    chunk = [s for s in spans if s.name == "sequencer.chunk"]
    key = [s for s in spans if s.name == "sequencer.sidechain_key"]
    bq = [s for s in spans if s.name == "effects.biquad"]
    assert len(chunk) == 1 and chunk[0].parent == -1
    assert len(key) == 1 and key[0].root == chunk[0].id
    assert by_id[key[0].parent].name == "effects.fx_stream"
    assert len(bq) == 1 and by_id[bq[0].root].name == "effects.fx_stream"
    assert by_id[bq[0].root].parent == -1
