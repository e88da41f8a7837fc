"""The kernels' bound on a hand-counted bank."""

import numpy as np
import pytest

from benchmark.harness import roofline as R
from benchmark.kinds import song as K
from benchmark.reference import song as ref


def test_voice_ops_by_hand():
    # a sine: 23 common + 18 waveform operations a frame
    assert R.voice_ops("sine", 1000) == 41 * 1000
    # a square_bl with FM: 23 + 38 + 32
    assert R.voice_ops("square_bl", 10, fm=True) == 93 * 10
    # a pluck of 5 sounding partials: 23 + 32 * 5
    assert R.voice_ops("pluck", 2, partials=5) == 183 * 2
    assert R.voice_ops("sine", -5) == 0


def test_bound_picks_the_larger():
    assert R.bound_seconds(67e12, 0) == pytest.approx(1.0)
    assert R.bound_seconds(0, 3.35e12) == pytest.approx(1.0)
    assert R.bound_seconds(67e9, 6.7e12) == pytest.approx(2.0)


def test_song_bound_by_hand(tmp_path):
    """A song of one sine note and one pluck note on the master bus: the
    bound is the output's bytes (operations are far fewer)."""
    text = """[song]
bpm = 120
ticks = 4
patterns = p
[synth.s]
wave = sine
attack = 0.01
decay = 0.05
sustain_level = 0.5
release = 0.1
[synth.g]
wave = pluck
release = 0.1
[pattern.p]
s = A4 - . .
g = . . C2 .
"""

    class Kind(K.SongKind):
        def __init__(self):
            self.kitdir = str(tmp_path)

    total = 44100
    st = ref.SongText(text, str(tmp_path), None)
    vs = ref.synth_voices(st)
    assert [v["wave"] for v in vs] == ["sine", "pluck"]
    # the sine: 2 ticks of 0.125 s gate, release 0.1 -> 0.35 s audible
    s0, a, d, sus, sl, r, end = ref.envelope_times(vs[0])
    assert s0 == 0 and end == pytest.approx(0.35)
    inc = ref.phase_increment(ref.note_freq("C2"))
    partials = sum(1 for k in range(1, 9) if k * inc < 2 ** 31)
    assert partials == 8
    frames_s = int(np.ceil(0.35 * 44100))
    g0, *_, gend = ref.envelope_times(vs[1])
    frames_g = int(np.ceil(gend * 44100))
    ops = 41 * frames_s + (23 + 32 * 8) * frames_g
    nbytes = total * 8 + 2 * R.VOICE_BYTES
    want = max(ops / R.F32_OPS_S, nbytes / R.HBM_BYTES_S)
    assert Kind().bound(text, total) == pytest.approx(want, rel=1e-3)
