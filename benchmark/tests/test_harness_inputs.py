"""The frozen inputs against the program's own generators, at a small
size."""

import numpy as np

from benchmark.inputs import demo_song as D
from benchmark.inputs import kit as KIT


def test_demo_text_is_the_repository_s():
    from synthesizer_tpu_torch import bench_song
    from benchmark.reference import song as ref
    assert D.TEXT == bench_song.DEMO_INI
    a = ref.SongText(D.variant(D.PATTERNS, 1), "", None)
    b = ref.SongText(D.TEXT, "", None)
    assert (a.sequence, a.automation, a.patterns, a.fx) == \
        (b.sequence, b.automation, b.patterns, b.fx)
    long = ref.SongText(bench_song.repeated(D.TEXT, 2), "", None)
    assert ref.SongText(D.variant(D.PATTERNS, 2), "", None).sequence == \
        long.sequence


def test_variants_share_their_length():
    from benchmark.reference import song as ref
    ends = set()
    for s in range(4):
        text = D.variant(D.pattern_order(np.random.default_rng(s)), 2)
        st = ref.SongText(text, "", None)
        assert st.sequence[6] == st.sequence[13] == "outro"
        assert sorted(st.sequence) == sorted(list(D.PATTERNS) * 2)
        ends.add(ref.synth_end_frame(ref.synth_voices(st)))
    assert len(ends) == 1
    st = ref.SongText(D.variant(D.PATTERNS, 4), "", None)
    assert st.automation["master.volume"] == [(0.0, 1.0), (384.0, 1.0),
                                              (448.0, 0.0)]


def test_kit_from_the_seed(tmp_path):
    a, b, c = KIT.make(5), KIT.make(5), KIT.make(2 ** 40 + 5)
    assert set(a) == set(KIT.LENGTHS)
    for name, secs in KIT.LENGTHS.items():
        assert a[name].shape == (int(secs * 44100), 2)
        assert a[name].dtype == np.int16
        assert np.array_equal(a[name], b[name])
        assert np.abs(a[name]).max() > 1000
    assert not np.array_equal(a["snare"], c["snare"])
    KIT.write(a, str(tmp_path))
    assert np.array_equal(KIT.read_wav(str(tmp_path / "kick.wav")),
                          a["kick"])


def test_gm_file_is_the_repository_s():
    from synthesizer_tpu_torch import bench_song
    from benchmark.inputs import gm
    for seed in (0, 7):
        assert gm.gm_file(120, 12.0, seed) == bench_song.gm_file(120, 12.0,
                                                                 seed)
    assert gm.gm_file(50, 5.0, [1, 2]) != gm.gm_file(50, 5.0, [1, 3])
