"""Randomized song fuzzing of the port on ``device="cpu"``: the batched
mixdown against the oracle per-hit loop, and streaming == offline (with a
seek), over random patterns, instruments, synth tracks and samplers.

The counterpart of ``tests/test_fuzz_songs.py``, with its seeds, generator
and tolerances; and a cross-check: the same random song built in both
packages and mixed with ``normalize=False``, within 1 LSB (the synth
tracks' and samplers' bound of ``tests/test_torch_sequencer.py``; a drum
here is a WaveSynth sound each package renders itself, so it is held to
the same 1 LSB, not 0).
"""

import types

import numpy as np
import pytest
import torch

import goldref.sample as gs
from synthesizer_tpu_torch import WaveSynth
from synthesizer_tpu_torch.sequencer import Song, SynthDef

torch.set_num_threads(2)

SR = 44100
NOTES = ["C2", "E2", "G2", "C3", "E3", "G3", "C4", "E4"]
WAVES = ["sine", "triangle", "square_bl", "sawtooth_bl", "harmonics"]
PORT = types.SimpleNamespace(Song=Song, WaveSynth=WaveSynth,
                             SynthDef=SynthDef, kw={"device": "cpu"})


def rand_song(rng, pkg=None):
    """A random song of ``pkg`` (the port on the CPU unless given)."""
    pkg = pkg or PORT
    song = pkg.Song(**pkg.kw)
    song.bpm = int(rng.integers(120, 300))
    song.ticks = int(rng.choice([2, 4]))
    synth = pkg.WaveSynth(samplerate=SR, samplewidth=2, **pkg.kw)
    ninst = int(rng.integers(1, 4))
    for i in range(ninst):
        dur = float(rng.uniform(0.02, 0.15))
        freq = float(rng.uniform(50, 400))
        s = synth.sine(freq, dur, amplitude=float(rng.uniform(0.2, 0.7)))
        s.fadeout(dur / 2).stereo()
        song.add_instrument(f"inst{i}", s)
    nsynth = int(rng.integers(0, 3))
    for i in range(nsynth):
        kw = {}
        wave = WAVES[rng.integers(len(WAVES))]
        if wave == "harmonics":
            kw["harmonics"] = (1.0, 0.5, 0.25)
        song.add_synth(f"syn{i}", pkg.SynthDef(
            wave=wave, amplitude=float(rng.uniform(0.1, 0.4)),
            attack=float(rng.uniform(0, 0.02)),
            decay=float(rng.uniform(0, 0.05)),
            sustain_level=float(rng.uniform(0.3, 0.9)),
            release=float(rng.uniform(0.01, 0.1)),
            pan=float(rng.uniform(-0.8, 0.8)), **kw))
    nsamp = int(rng.integers(0, 2))
    for i in range(nsamp):
        dur = float(rng.uniform(0.05, 0.2))
        src = synth.pluck(261.6255653005986, dur,
                          amplitude=float(rng.uniform(0.2, 0.5)),
                          seed=int(rng.integers(0, 50)))
        src.fadeout(dur / 3).stereo()
        song.add_sampler(f"smp{i}", src, base_note="C4")
    npat = int(rng.integers(1, 3))
    for p in range(npat):
        nticks = int(rng.choice([8, 16]))
        tracks = {}
        for i in range(ninst):
            if rng.random() < 0.8:
                tracks[f"inst{i}"] = "".join(
                    "x" if rng.random() < 0.3 else "." for _ in range(nticks))
        for i in range(nsynth):
            if rng.random() < 0.8:
                toks = []
                for _ in range(nticks):
                    r = rng.random()
                    if r < 0.25:
                        toks.append(NOTES[rng.integers(len(NOTES))])
                    elif r < 0.45 and toks and toks[-1] not in (".",):
                        toks.append("-")
                    else:
                        toks.append(".")
                tracks[f"syn{i}"] = " ".join(toks)
        for i in range(nsamp):
            if rng.random() < 0.8:
                toks = [NOTES[rng.integers(len(NOTES))]
                        if rng.random() < 0.25 else "."
                        for _ in range(nticks)]
                tracks[f"smp{i}"] = " ".join(toks)
        if tracks:
            song.add_pattern(f"p{p}", tracks)
    song.pattern_sequence = [f"p{i}" for i in
                             rng.integers(0, npat, size=int(rng.integers(1, 4)))
                             if f"p{i}" in song.patterns]
    if not song.pattern_sequence and song.patterns:
        song.pattern_sequence = [next(iter(song.patterns))]
    return song


def oracle_drum_mix(song: Song, total_frames: int) -> np.ndarray:
    out = gs.Sample(np.zeros((total_frames, 2), np.int32), SR, 4, 2)
    sched = song.compile_schedule()
    for inst_i, start in sched.hits:
        arr = song.instruments[sched.instruments[inst_i]].get_frame_array()
        g = gs.Sample(arr.astype(np.int32), SR, 4, 2)
        out.mix_at(start / SR, g, pad_shortest=False)
    return out.frames


@pytest.mark.parametrize("seed", range(8))
def test_random_song(seed):
    rng = np.random.default_rng(seed + 5000)
    song = rand_song(rng)
    if not song.pattern_sequence:
        pytest.skip("empty song")
    offline = song.mix(normalize=False)
    if offline.nframes == 0:
        return
    # streaming == offline
    chunks = [c.get_frame_array() for c in song.mix_generator(chunk_frames=977)]
    if chunks:
        got = np.concatenate(chunks)
        np.testing.assert_array_equal(got, offline.get_frame_array()[:len(got)],
                                      err_msg=f"seed {seed}")
    # drum part matches the oracle per-hit loop (pure-drum songs only)
    voices = song.compile_synth_voices()
    if not voices and not song.samplers:
        want32 = oracle_drum_mix(song, offline.nframes)
        want = np.clip(want32, -32768, 32767).astype(np.int16)
        np.testing.assert_array_equal(offline.get_frame_array(), want,
                                      err_msg=f"seed {seed}")


def add_rand_automation(song, rng):
    """Random velocity/pan/master curves (all bit-exact surfaces)."""
    def curve(lo, hi, allow_neg=False):
        npts = int(rng.integers(1, 4))
        ticks = np.sort(rng.choice(np.arange(0, 64), npts, replace=False))
        vals = rng.uniform(lo, hi, npts)
        return " ".join(f"{t}:{v:.3f}" for t, v in zip(ticks, vals))
    if rng.random() < 0.4:
        song.swing = float(rng.uniform(0.1, 0.6))
    for name in (list(song.instruments) + list(song.synths)
                 + list(song.samplers)):
        if rng.random() < 0.5:
            song.add_automation(f"track.{name}.volume", curve(0.1, 1.2))
        if rng.random() < 0.3:
            song.add_automation(f"track.{name}.pan", curve(-1.0, 1.0))
    if rng.random() < 0.5:
        song.add_automation("master.volume", curve(0.0, 1.1))


@pytest.mark.parametrize("seed", range(6))
def test_random_song_with_automation(seed):
    """Velocity/pan/master-volume automation keeps streaming (incl. a
    random mid-song seek) bit-identical to offline on random songs."""
    rng = np.random.default_rng(seed + 6100)
    song = rand_song(rng)
    if rng.random() < 0.4 and song.synths:
        # swap one synth to pluck (covers the banked KS path in the mix)
        name = next(iter(song.synths))
        song.synths[name].wave = "pluck"
        song.synths[name].seed = int(rng.integers(0, 100))
        song.synths[name].damping = float(rng.uniform(0.5, 2.5))
    add_rand_automation(song, rng)
    if not song.pattern_sequence:
        pytest.skip("empty song")
    offline = song.mix(normalize=False, tail_seconds=0.0)
    if offline.nframes == 0:
        return
    off = offline.get_frame_array()
    cf = int(rng.choice([977, 2048, 4096]))
    got = np.concatenate([c.get_frame_array()
                          for c in song.mix_generator(chunk_frames=cf)])
    np.testing.assert_array_equal(got, off[:len(got)],
                                  err_msg=f"seed {seed}")
    seek = int(rng.integers(1, max(2, song.duration_frames())))
    chunks = [c.get_frame_array()
              for c in song.mix_generator(chunk_frames=cf, start_frame=seek)]
    if chunks:
        got2 = np.concatenate(chunks)
        np.testing.assert_array_equal(got2, off[seek:seek + len(got2)],
                                      err_msg=f"seed {seed} seek {seek}")


def _curve_str(rng, lo, hi):
    npts = int(rng.integers(2, 4))
    ticks = np.sort(rng.choice(np.arange(0, 48), npts, replace=False))
    vals = rng.uniform(lo, hi, npts)
    return " ".join(f"{t}:{v:.4f}" for t, v in zip(ticks, vals))


# Master-chain fx pool: (fx name, ctor params, automatable keys with ranges).
# Reverb is exercised separately (its offline path compiles per song length
# on CPU — tens of seconds cold — so one dedicated seed keeps the fuzz fast).
_FX_POOL = [
    ("filter", dict(kind="lowpass", cutoff=1500.0, q=0.9),
     {"fx.filter.cutoff": (250.0, 7000.0)}),
    ("filter", dict(kind="lowshelf", cutoff=220.0, q=0.7071, gain_db=4.0),
     {"fx.filter.cutoff": (80.0, 500.0)}),
    ("eq", dict(low_db=0.0, mid_db=0.0, high_db=0.0),
     {"fx.eq.low_db": (-9.0, 9.0), "fx.eq.mid_db": (-9.0, 9.0),
      "fx.eq.high_db": (-9.0, 9.0)}),
    ("compress", dict(threshold_db=-18.0, ratio=4.0, attack=0.005,
                      release=0.08),
     {"fx.compress.threshold_db": (-35.0, -8.0),
      "fx.compress.ratio": (1.5, 10.0),
      "fx.compress.makeup_db": (-6.0, 6.0),
      "fx.compress.attack": (0.0005, 0.05),
      "fx.compress.release": (0.02, 0.4)}),
    ("gate", dict(threshold_db=-55.0, range_db=-35.0),
     {"fx.gate.threshold_db": (-70.0, -30.0)}),
    ("chorus", dict(rate=1.2, depth=0.0015, delay=0.012, wet=0.35, dry=0.9),
     {"fx.chorus.wet": (0.0, 0.8), "fx.chorus.dry": (0.4, 1.0),
      "fx.chorus.rate": (0.2, 5.0), "fx.chorus.depth": (0.0005, 0.004)}),
    ("echo", dict(delay=0.07, feedback=0.4, wet=0.4),
     {"fx.echo.feedback": (0.05, 0.8), "fx.echo.wet": (0.0, 0.7),
      "fx.echo.dry": (0.5, 1.0)}),
    ("width", dict(amount=1.2),
     {"fx.width.amount": (0.0, 2.5)}),
    ("limiter", dict(ceiling_db=-2.0, lookahead=0.004),
     {"fx.limiter.ceiling_db": (-15.0, -0.5),
      "fx.limiter.release": (0.005, 0.4)}),
    ("phaser", dict(rate=1.0, depth=1.0, wet=0.4),
     {"fx.phaser.wet": (0.0, 0.8), "fx.phaser.dry": (0.5, 1.0),
      "fx.phaser.rate": (0.2, 6.0), "fx.phaser.depth": (0.1, 1.0)}),
    ("tremolo", dict(rate=4.0, depth=0.5),
     {"fx.tremolo.rate": (0.3, 8.0), "fx.tremolo.depth": (0.1, 1.0)}),
    ("autopan", dict(rate=0.7, depth=0.8),
     {"fx.autopan.rate": (0.2, 4.0), "fx.autopan.depth": (0.1, 1.0)}),
]


@pytest.mark.parametrize("seed", range(5))
def test_random_song_with_fx_automation(seed):
    """Random master [fx] chains with random fx.* automation curves on
    every automatable key: streaming == offline within the composed
    budgets at a random chunk size.  Covers cross-key interactions the
    per-key tests in test_automation.py don't (e.g. a swept shelf feeding
    an attack/release-automated compressor)."""
    rng = np.random.default_rng(seed + 6300)
    song = rand_song(rng)
    if not song.pattern_sequence:
        pytest.skip("empty song")
    picks = rng.permutation(len(_FX_POOL))[: int(rng.integers(1, 4))]
    used_names = set()
    nkeys = 0
    for pi in picks:
        name, params, keys = _FX_POOL[pi]
        if name in used_names:      # one automatable entry per fx kind
            continue
        used_names.add(name)
        song.add_fx(name, **params)
        for key, (lo, hi) in keys.items():
            if rng.random() < 0.7:
                song.add_automation(key, _curve_str(rng, lo, hi))
                nkeys += 1
    if nkeys == 0:
        song.add_automation("master.volume", _curve_str(rng, 0.3, 1.0))
    add_rand_automation(song, rng)
    offline = song.mix(normalize=False, tail_seconds=0.0)
    if offline.nframes == 0:
        return
    off = offline.get_frame_array()
    cf = int(rng.choice([997, 1536, 3001]))
    got = np.concatenate([c.get_frame_array()
                          for c in song.mix_generator(chunk_frames=cf)])
    assert len(got) == len(off), f"seed {seed}"
    d = np.abs(got.astype(np.int64) - off.astype(np.int64)).max()
    # composed per-fx budgets (<=10 each, <=3 fx) — 24 covers every draw
    assert d <= 24, f"seed {seed}: {d} (fx={[n for n, _ in song.fx]}, " \
                    f"auto={sorted(song.automation)})"


def test_random_song_reverb_roomsize_automation():
    """One reverb draw (kept out of the seed loop: the offline Freeverb
    compiles per song length on CPU) — roomsize/wet/dry curves stay within
    budget between streaming and offline on a random song."""
    rng = np.random.default_rng(6399)
    song = rand_song(rng)
    assert song.pattern_sequence
    song.add_fx("reverb", roomsize=0.6, damping=0.4, wet=0.3, dry=0.8,
                tail=0.15)
    song.add_automation("fx.reverb.roomsize", "0:0.2 24:0.9")
    song.add_automation("fx.reverb.wet", _curve_str(rng, 0.05, 0.6))
    song.add_automation("fx.reverb.dry", _curve_str(rng, 0.5, 1.0))
    add_rand_automation(song, rng)
    off = song.mix(normalize=False, tail_seconds=0.0).get_frame_array()
    got = np.concatenate([c.get_frame_array()
                          for c in song.mix_generator(chunk_frames=1536)])
    assert len(got) == len(off)
    d = np.abs(got.astype(np.int64) - off.astype(np.int64)).max()
    assert d <= 8, d


@pytest.mark.parametrize("seed", range(4))
def test_random_song_with_synth_fx(seed):
    """Random tail-less per-synth-track chains stay within the composed
    budgets between offline and streaming on random songs."""
    rng = np.random.default_rng(seed + 6200)
    song = rand_song(rng)
    if (not song.synths and not song.samplers) \
            or not song.pattern_sequence:
        pytest.skip("no melodic tracks")
    chains = [
        [("filter", f"kind=lowpass cutoff={rng.integers(400, 6000)} q=1.0")],
        [("compress", f"threshold_db={rng.uniform(-25, -10):.1f} ratio=4")],
        [("filter", "kind=highpass cutoff=300 q=0.7071"),
         ("compress", "threshold_db=-18 ratio=3")],
    ]
    for name in song.synths:
        if rng.random() < 0.7:
            song.add_track_fx(name, chains[rng.integers(len(chains))])
    for name in song.samplers:
        if rng.random() < 0.5:
            song.add_track_fx(name, chains[rng.integers(len(chains))])
    add_rand_automation(song, rng)
    offline = song.mix(normalize=False, tail_seconds=0.0)
    if offline.nframes == 0:
        return
    off = offline.get_frame_array()
    got = np.concatenate([c.get_frame_array()
                          for c in song.mix_generator(chunk_frames=1536)])
    assert len(got) == len(off)
    d = np.abs(got.astype(np.int64) - off.astype(np.int64)).max()
    assert d <= 8, f"seed {seed}: {d}"


@pytest.mark.parametrize("seed", range(8))
def test_random_song_matches_jax(seed):
    """The same draw of rand_song built in the JAX package and in the port,
    mixed with normalize=False: equal length, within 1 LSB."""
    from synthesizer_tpu import WaveSynth as JW
    from synthesizer_tpu.sequencer import Song as JSong, SynthDef as JDef
    jax_pkg = types.SimpleNamespace(Song=JSong, WaveSynth=JW,
                                    SynthDef=JDef, kw={})
    js = rand_song(np.random.default_rng(seed + 5000), jax_pkg)
    ts = rand_song(np.random.default_rng(seed + 5000))
    if not ts.pattern_sequence:
        pytest.skip("empty song")
    jm = js.mix(normalize=False).get_frame_array()
    tm = ts.mix(normalize=False).get_frame_array()
    assert tm.shape == jm.shape and tm.dtype == np.int16
    d = np.abs(tm.astype(np.int64) - jm.astype(np.int64))
    assert (d.max() if d.size else 0) <= 1, f"seed {seed}"
