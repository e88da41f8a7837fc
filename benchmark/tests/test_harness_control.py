"""The control of each cell: the reference in the program's place,
computed one precision below the float32 the song states (bfloat16
between stages), must read above the cell's limit.

As a test it runs the songs at their shortest; as a script it reads the
control at the cells' own sizes on the seeds given (on the machine of the
card; the reference runs on the host):

    python3 benchmark/tests/test_harness_control.py 11 12 13
"""

import os
import sys
import tempfile

import numpy as np

if __name__ == "__main__":
    sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.dirname(
        os.path.abspath(__file__)))))

from benchmark.harness import manifest  # noqa: E402
from benchmark.inputs import demo_song as D  # noqa: E402
from benchmark.inputs import kit as KIT  # noqa: E402
from benchmark.inputs import gm  # noqa: E402
from benchmark.kinds.song import gap  # noqa: E402
from benchmark.reference import midi as midiref  # noqa: E402
from benchmark.reference import song as ref  # noqa: E402

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))


def control_gaps(seed: int, repeats, stream: bool, kitdir: str) -> list:
    """The control's widest gap to the reference for each song length of
    the cell (the render cell's seeded orders; the stream's song as
    written)."""
    KIT.write(KIT.make(seed), kitdir)
    out = []
    for j, k in enumerate(repeats):
        text = D.TEXT if stream else D.variant(
            D.pattern_order(np.random.default_rng([seed, j])), k)
        kw = dict(normalize=False, tail_seconds=0.0) if stream else {}
        st = ref.SongText(text, kitdir, KIT.read_wav)
        out.append(gap(ref.mix(st, control=True, **kw), ref.mix(st, **kw)))
    return out


def midi_control_gaps(seed: int, notes: int, seconds: float) -> list:
    """The control's widest gap on one GM file of the seed."""
    data = gm.gm_file(notes, seconds, [seed & 0xFFFFFFFF, seed >> 32, 5, 0])
    return [gap(midiref.render(data, control=True),
                midiref.render(data, spread=True))]


def test_render_control_reads_above_the_limit(tmp_path):
    limit = manifest.cell(ROOT, "demo_song.render")["limits"][
        "render_lsb_gap"]
    assert min(control_gaps(3, [1], False, str(tmp_path))) > limit


def test_stream_control_reads_above_the_limit(tmp_path):
    limit = manifest.cell(ROOT, "demo_song.stream")["limits"][
        "stream_lsb_gap"]
    assert min(control_gaps(4, [1], True, str(tmp_path))) > limit


def test_square_range_holds_both_sides_of_the_half_cycle():
    """Within the slack of the half cycle the reference allows both the
    value the residuals give where the float32 position rounds to 0.5
    (2) and the one beside it (about 0); far from it, its value alone."""
    half = 1 << 31
    p = np.array([half - 10, half - 100, half + 5, half - 2 ** 20],
                 np.uint32)
    dt = np.full(len(p), 0.01)
    val = midiref._square(p, dt)
    assert val[0] == 2.0 and abs(val[1]) < 0.1
    lo, hi = midiref._square_spread(p, dt, val)
    assert np.all(val[:3] + lo[:3] < 0.1) and np.all(val[:3] + hi[:3] == 2.0)
    assert lo[3] == hi[3] == 0.0
    got = np.array([[0, 0], [5, 0]], np.int16)
    assert gap(got, (np.array([[0, 0], [0, 0]], np.int16),
                     np.array([[0, 0], [9, 0]], np.int16))) == 0.0
    assert gap(got, (np.array([[0, 0], [7, 0]], np.int16),
                     np.array([[0, 0], [9, 0]], np.int16))) == 2.0


def test_midi_control_reads_above_the_limit():
    limit = manifest.cell(ROOT, "gm_midi.render")["limits"]["render_lsb_gap"]
    assert min(midi_control_gaps(3, 200, 20.0)) > limit


if __name__ == "__main__":
    render = manifest.cell(ROOT, "demo_song.render")["traffic"]["repeats"]
    midi = manifest.cell(ROOT, "gm_midi.render")["traffic"]
    for s in sys.argv[1:]:
        with tempfile.TemporaryDirectory() as d:
            print(f"seed {s}: render {control_gaps(int(s), render, False, d)}"
                  f" stream {control_gaps(int(s), [1], True, d)}"
                  f" midi {midi_control_gaps(int(s), midi['notes'], midi['seconds'])}",
                  flush=True)
