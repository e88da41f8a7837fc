"""The port's ``RealtimeVoice`` (``synthesizer_tpu_torch.voice``) against the
JAX one on the CPU.

Tolerance: each int16 sample within 1 LSB of the JAX voice (the gate's and
the patch's f32 arithmetic, where XLA may fuse what eager PyTorch rounds
step by step); the release starts at the same frame, the stream ends after
the same number of chunks, and lookahead 1 and 4 give the same bits.
"""

import numpy as np
import pytest
import torch

from synthesizer_tpu import oscillators as JO
from synthesizer_tpu.models import spec as JS
from synthesizer_tpu.voice import RealtimeVoice as JVoice
from synthesizer_tpu_torch import oscillators as TO
from synthesizer_tpu_torch.models import spec as TS
from synthesizer_tpu_torch.voice import RealtimeVoice as TVoice
from synthesizer_tpu_torch.voice import _gate_gains

torch.set_num_threads(2)

SR = 44100
BS = 1470


def _config4(S):
    """bench.py's config 4 patch: an FM sawtooth under a sine amplitude
    LFO, through a four-tap echo."""
    return S.Echo(
        S.AmpMod(S.Osc("sawtooth", 330.0, 0.7,
                       fm_lfo=S.Osc("sine", 5.0, 0.01)),
                 S.Osc("sine", 2.0, amplitude=0.4, bias=0.6)),
        0.05, 4, 0.07, 0.6)


def _run(V, O, S, release_at=None, release_after=None, lookahead=1,
         echo=None, **kw):
    v = V(O.Oscillator(_config4(S), SR), 0.01, 0.02, 0.7, 0.05,
          samplerate=SR, blocksize=BS, lookahead_blocks=lookahead,
          echo=echo, **kw)
    if release_at is not None:
        v.release(at_frame=release_at)
    out = []
    for i, c in enumerate(v.chunks()):
        out.append(np.frombuffer(c, np.int16).reshape(-1, 2))
        if release_after is not None and i == release_after - 1:
            v.release()
        assert i < 400, "the voice never ended"
    return out


def _lsb(a, b):
    return int(np.abs(a.astype(np.int64) - b.astype(np.int64)).max())


@pytest.mark.parametrize("case", ["at_frame", "next_block", "echo"])
def test_voice_matches_jax(case):
    """Config 4's patch under the gate: a release pinned mid-block, a bare
    release after 5 blocks, and the gate's own echo after the envelope.
    Same chunk count and sizes, within 1 LSB."""
    kw = {"at_frame": {"release_at": 4 * BS + 777},
          "next_block": {"release_after": 5},
          "echo": {"release_at": 2 * BS + 300,
                   "echo": (0.02, 3, 0.03, 0.5)}}[case]
    got = _run(TVoice, TO, TS, device="cpu", **kw)
    want = _run(JVoice, JO, JS, **kw)
    assert [len(c) for c in got] == [len(c) for c in want]
    assert all(len(c) == BS for c in got)
    g, w = np.concatenate(got), np.concatenate(want)
    assert np.array_equal(g[:, 0], g[:, 1])
    assert _lsb(g, w) <= 1
    assert np.abs(g[-10:]).max() == 0          # silent at its end


def test_release_is_sample_accurate():
    """The gains switch from the held curve to the release ramp exactly at
    the release frame, mid-block, in int64 frame arithmetic: the gain at
    rn - 1 is the held level, at rn the ramp's start, and frames past
    2^24 (where an f32 frame index loses single frames) still split
    exactly."""
    for rn in (3 * BS + 517, (1 << 24) + 3):
        n0 = rn - 517
        g = _gate_gains(n0, BS, SR, 0.01, 0.02, 0.7, rn, 0.7, 0.05, "cpu")
        k = rn - n0
        assert float(g[k - 1]) == pytest.approx(0.7, abs=1e-6)
        assert float(g[k]) == pytest.approx(0.7, abs=1e-6)
        assert float(g[k + 1]) < float(g[k])      # the ramp falls from rn
        held = _gate_gains(n0, BS, SR, 0.01, 0.02, 0.7, 2**31 - 1, 1.0,
                           0.05, "cpu")
        assert torch.equal(g[:k], held[:k])
        assert not torch.equal(g[k:], held[k:])


def test_lookahead_1_and_4_give_the_same_bits():
    a = _run(TVoice, TO, TS, release_at=4 * BS + 777, lookahead=1,
             echo=(0.02, 2, 0.03, 0.5), device="cpu")
    b = _run(TVoice, TO, TS, release_at=4 * BS + 777, lookahead=4,
             echo=(0.02, 2, 0.03, 0.5), device="cpu")
    assert all(len(c) == BS for c in b)
    na, nb = np.concatenate(a), np.concatenate(b)
    m = min(len(na), len(nb))
    np.testing.assert_array_equal(na[:m], nb[:m])
    rest = nb[m:] if len(nb) > m else na[m:]
    assert np.abs(rest).max(initial=0) == 0
    # the JAX voice ends after the same number of chunks at lookahead 4
    jb = _run(JVoice, JO, JS, release_at=4 * BS + 777, lookahead=4,
              echo=(0.02, 2, 0.03, 0.5))
    assert len(jb) == len(b)


def test_voice_defaults_to_the_card():
    if torch.cuda.is_available():
        pytest.skip("this check is for a machine without a CUDA device")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        TVoice(TO.Sine(440.0, samplerate=SR), 0.01, 0.02, 0.7, 0.05)
