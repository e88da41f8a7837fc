"""The port's pattern sequencer (``synthesizer_tpu_torch.sequencer``)
against the JAX package's, on the CPU, on the same ``.ini`` text and the
same WAV files (seeded numpy sounds written once per module).

Tolerances:
- the hit schedule, the int32 scatter mixdown and songs of sample tracks:
  equal (0 LSB; integer adds are exact in any order);
- pitched samplers: 0 LSB as measured below (the bound in the tests is 1
  LSB per overlapping note, where XLA's CPU may contract
  ``v0 + (v1 - v0) * frac`` into a fused multiply-add);
- synth tracks: 1 LSB (the bank's summation order);
- fx chains: the sum of the chain's ``ops.effects.BUDGETS`` plus the
  synth's 1 LSB;
- streaming against offline, the seek, stems and ``export_midi``: as the
  reference promises them.
"""

import dataclasses

import numpy as np
import pytest
import torch

from synthesizer_tpu import sequencer as J
from synthesizer_tpu_torch import sequencer as T
from synthesizer_tpu_torch.ops import hits as H
from synthesizer_tpu_torch.ops.effects import BUDGETS
from synthesizer_tpu_torch.utils import wavio

SR = 44100


def _lsb(a, b):
    a, b = np.asarray(a), np.asarray(b)
    assert a.shape == b.shape, (a.shape, b.shape)
    return int(np.abs(a.astype(np.int64) - b.astype(np.int64)).max()) \
        if a.size else 0


def _sound(kind, seconds, seed, freq=0.0):
    rng = np.random.default_rng(seed)
    n = int(seconds * SR)
    t = np.arange(n) / SR
    env = np.exp(-t * 18.0)
    if kind == "noise":
        x = rng.standard_normal(n) * 0.3 * env
    elif kind == "tone":
        x = 0.6 * np.sin(2 * np.pi * freq * t) * env
    else:                       # a steady tone for loops, no envelope
        x = 0.4 * np.sin(2 * np.pi * freq * t) \
            + 0.1 * np.sin(2 * np.pi * 3 * freq * t)
    st = np.stack([x, 0.8 * x], axis=1)
    return np.clip(np.rint(st * 32767), -32768, 32767).astype(np.int16)


@pytest.fixture(scope="module")
def kit(tmp_path_factory):
    d = tmp_path_factory.mktemp("kit")
    for name, (kind, sec, seed, f) in {
            "kick": ("tone", 0.12, 1, 60.0), "hat": ("noise", 0.04, 2, 0),
            "snare": ("noise", 0.09, 3, 0), "pluck": ("tone", 0.2, 4, 261.6),
            "pad": ("loop", 0.3, 5, 261.6255653005986)}.items():
        wavio.write_wav(str(d / f"{name}.wav"), _sound(kind, sec, seed, f),
                        SR, 2, 2)
    return str(d)


DRUMS = """\
[song]
bpm = 150
ticks = 4
swing = 0.2
patterns = a b a
[instruments]
kick = kick.wav
hat = hat.wav
snare = snare.wav
[pattern.a]
kick  = X... x... x..o x...
hat   = x.x. xox. x.x. x.xx
snare = .... x... .... X...
[pattern.b]
kick  = x.x. x... X... ....
hat   = xxxx xxxx xxxx xxxx
[automation]
track.hat.volume = 0:0.4 40:1.0
track.kick.pan = 0:-0.8 48:0.7
"""

SAMPLERS = """\
[song]
bpm = 180
ticks = 4
patterns = a a
[instruments]
kick = kick.wav
[sampler.pluck]
file = pluck.wav
base_note = C4
[sampler.pad]
file = pad.wav
base_note = C4
loop_start = 0.05
loop_end = 0.15
release = 0.05
[sampler.padend]
; a loop that ends at the sample's last frame
file = pad.wav
base_note = C4
loop_start = 0.2
loop_end = 0.3
release = 0.03
[pattern.a]
kick  = x... x...
pluck = C4 E4@0.5 .. G3 C5 .. C4 D#4
pad   = C3 - - - A3 - .. ..
padend = .. .. E4 - - - - .
[automation]
track.pluck.pan = 0:-1 16:1
"""

SYNTHS = """\
[song]
bpm = 150
ticks = 4
swing = 0.2
patterns = a b
[instruments]
kick = kick.wav
hat = hat.wav
[synth.lead]
wave = square_bl
amplitude = 0.25
release = 0.05
glide = 0.03
pan = 0.3
[synth.sub]
wave = sine
amplitude = 0.3
attack = 0.004
[synth.bell]
wave = triangle
amplitude = 0.2
fm_frequency = 6.0
fm_depth = 0.01
[pattern.a]
kick = X... x... x..o x...
hat  = x.x. xox. x.x. x.xx
lead = C4 .. E4@0.6 G4 - .. C5 ..
sub  = C2 - - - G1 - - -
bell = .. E5 .. .. .. G5 .. ..
[pattern.b]
kick = x.x. x... X... ....
lead = G4 - - E4 .. D4 C4 -
[fx.lead]
chorus = rate=1.3 depth=0.002 delay=0.012 wet=0.4
[fx.bell]
reverb = roomsize=0.4 wet=0.3 dry=0.8 tail=0.1
[automation]
track.sub.volume = 0:1 16:0.3
"""

FX = """\
[song]
bpm = 160
ticks = 4
patterns = a a
[instruments]
kick = kick.wav
hat = hat.wav
[sampler.pad]
file = pad.wav
base_note = C4
loop_start = 0.05
loop_end = 0.15
release = 0.05
[synth.lead]
wave = sawtooth_bl
amplitude = 0.2
[pattern.a]
kick = x... x... x... x...
hat  = x.x. x.x. x.x. x.x.
pad  = C3 - - - - - - - E3 - - - - - - -
lead = C4 .. E4 .. G4 .. E4 ..
[fx.pad]
compress = threshold_db=-20 ratio=6 attack=0.002 release=0.08 sidechain=kick
[fx.hat]
filter = kind=lowpass cutoff=3000
[fx]
compress = threshold_db=-12 ratio=3 attack=0.004 release=0.1 makeup_db=1
reverb = roomsize=0.5 damping=0.5 wet=0.15 dry=0.9 tail=0.2
echo = beats=0.5 feedback=0.3 wet=0.1 tail=0.1
limiter = ceiling_db=-1 lookahead=0.003
[automation]
fx.reverb.wet = 0:0.05 32:0.3
fx.echo.wet = 0:0.05 32:0.15
fx.hat.filter.cutoff = 0:800 32:8000
master.volume = 0:1 16:1 32:0.2
"""

SONGS = {"drums": DRUMS, "samplers": SAMPLERS, "synths": SYNTHS, "fx": FX}
#: the measured maximum port-vs-JAX difference of each song's
#: mix(normalize=False), in LSB, and the bound the test holds it to
MEASURED = {"drums": 0, "samplers": 1, "synths": 2, "fx": 3}
BOUND = {"drums": 0, "samplers": 1, "synths": 1 + BUDGETS["chorus"]
         + BUDGETS["reverb"],
         "fx": 1 + BUDGETS["compress"] * 2 + BUDGETS["reverb"]
         + BUDGETS["feedback_echo"] + BUDGETS["limit"] + BUDGETS["filter"]}


@pytest.fixture(scope="module")
def songs(kit):
    """{name: (JAX Song, port Song, JAX mix, port mix)}, each song built
    and mixed once."""
    out = {}
    for name, text in SONGS.items():
        js = J.Song.from_string(text, kit)
        ts = T.Song.from_string(text, kit, device="cpu")
        out[name] = (js, ts, js.mix(normalize=False).get_frame_array(),
                     ts.mix(normalize=False).get_frame_array())
    return out


@pytest.mark.parametrize("name", list(SONGS))
def test_mix_matches_jax(songs, name):
    js, ts, jm, tm = songs[name]
    assert tm.shape == jm.shape and tm.dtype == np.int16
    assert np.abs(tm.astype(np.int64)).max() > 1000
    d = _lsb(jm, tm)
    assert d <= BOUND[name], (name, d)
    assert d <= MEASURED[name], (name, d, "measured maximum moved")


@pytest.mark.parametrize("name", ["drums", "samplers"])
def test_normalized_mix_matches_jax(songs, name):
    js, ts, _, _ = songs[name]
    assert _lsb(js.mix().get_frame_array(), ts.mix().get_frame_array()) \
        <= BOUND[name]


@pytest.mark.parametrize("name", list(SONGS))
def test_schedules_equal(songs, name):
    js, ts, _, _ = songs[name]
    a, b = js.compile_schedule(), ts.compile_schedule()
    assert a.instruments == b.instruments
    for f in ("bank", "lengths", "hits", "gains"):
        assert np.array_equal(getattr(a, f), getattr(b, f)), f
    assert a.total_frames == b.total_frames
    for x, y in zip(js.compile_pitched_hits(), ts.compile_pitched_hits()):
        assert x.dtype == y.dtype and np.array_equal(x, y)
    assert js._last_pitched_tracks == ts._last_pitched_tracks
    jv, jt = js.compile_synth_voices(return_tracks=True)
    tv, tt = ts.compile_synth_voices(return_tracks=True)
    assert jt == tt
    assert [dataclasses.asdict(v) for v in jv] == \
        [dataclasses.asdict(v) for v in tv]
    assert js.duration_frames() == ts.duration_frames()
    assert js.duration_frames(0.5) == ts.duration_frames(0.5)


@pytest.mark.parametrize("batch", [None, 5000])
def test_mixdown_kernel_matches_jax(songs, monkeypatch, batch):
    """The int32 scatter against J._mixdown_kernel, 0 LSB, on the direct
    and (with a small element cap on both sides) the batched branch."""
    import jax.numpy as jnp
    if batch:
        monkeypatch.setattr(J, "_SCATTER_BATCH_ELEMS", batch)
        monkeypatch.setattr(H, "_SCATTER_BATCH_ELEMS", batch)
    sched = songs["drums"][1].compile_schedule()
    total = sched.total_frames - 500           # some hits run off the end
    want = np.asarray(J._mixdown_kernel(
        jnp.asarray(sched.bank), jnp.asarray(sched.hits[:, 0].astype(np.int32)),
        jnp.asarray(sched.hits[:, 1].astype(np.int32)), total,
        jnp.asarray(sched.gains)))
    got = H._mixdown_kernel(torch.from_numpy(sched.bank),
                            torch.from_numpy(sched.hits[:, 0]),
                            torch.from_numpy(sched.hits[:, 1]), total,
                            torch.from_numpy(sched.gains))
    assert got.dtype == torch.int32 and _lsb(want, got.numpy()) == 0
    # against a per-hit int64 loop (the verify battery's oracle)
    oracle = np.zeros((total, 2), np.int64)
    for (i, start), g in zip(sched.hits, sched.gains):
        v = np.rint(sched.bank[i, :sched.lengths[i]].astype(np.float32)
                    * g).astype(np.int64)
        m = min(len(v), total - start)
        oracle[start:start + m] += v[:m]
    assert _lsb(oracle, got.numpy()) == 0


def test_pitched_chunks_match_jax_and_whole(songs):
    """The pitched body chunk by chunk == the whole-song pass, bit for bit;
    each chunk within 1 LSB of the JAX body (measured 0)."""
    import jax.numpy as jnp
    ts = songs["samplers"][1]
    bank, lens, idx, starts, rates, gains, loopf, loopu = \
        ts.compile_pitched_hits()
    ends = ts._pitched_end_frames(lens, idx, starts, rates, loopf)
    total = int(ends.max())
    cf = 4096
    whole = ts._pitched_mix(bank, lens, idx, starts, rates, gains, loopf,
                            loopu, ends, total, cf=cf)
    per, K = ts._bucket(starts, ends, -(-total // cf), cf, 0)
    rows = ts._pitched_rows(per, K, idx, starts, rates, gains, loopf, loopu)
    fn = J._pitched_chunk_fn(cf, bank.shape[1])
    worst = 0
    for c in range(-(-total // cf)):
        got = H._pitched_chunk_body(torch.from_numpy(bank),
                                    torch.from_numpy(lens),
                                    *(r[c] for r in rows), c * cf, cf)
        assert torch.equal(got[:total - c * cf], whole[c * cf:(c + 1) * cf])
        jrows = [jnp.asarray(r[c].numpy()) for r in rows]
        jrows[1] = jrows[1].astype(jnp.int32)
        jrows[6] = jrows[6].astype(jnp.uint32)
        want = np.asarray(fn(jnp.asarray(bank),
                             jnp.asarray(lens.astype(np.int32)), *jrows,
                             jnp.int32(c * cf)))
        worst = max(worst, _lsb(want, got.numpy()))
    assert worst <= 1


def test_rate_one_is_a_passthrough(kit):
    """A one-shot note at its base note replays the normalized WAV bit
    for bit (the sampler's rate 1.0 promise)."""
    text = ("[song]\nbpm = 120\nticks = 4\npatterns = a\n"
            "[sampler.p]\nfile = pluck.wav\nbase_note = C4\n"
            "[pattern.a]\np = .. C4 .. ..\n")
    ts = T.Song.from_string(text, kit, device="cpu")
    out = ts.mix(normalize=False, tail_seconds=0).get_frame_array()
    src = ts.samplers["p"].sample.get_frame_array()
    start = int(SR * 60 / 120 / 4)
    assert np.array_equal(out[start:start + len(src)], src)


@pytest.mark.parametrize("name", list(SONGS))
def test_streaming_equals_offline(songs, name):
    """mix_generator(1470) against mix(normalize=False, tail=0): bit for
    bit without a master chain, within the chain's budgets with one."""
    _, ts, _, _ = songs[name]
    off = ts.mix(normalize=False, tail_seconds=0).get_frame_array()
    st = np.concatenate([c.get_frame_array()
                         for c in ts.mix_generator(chunk_frames=1470)])
    assert st.shape == off.shape
    d = _lsb(off, st)
    if name == "fx":
        assert d <= BOUND["fx"], d
    elif name == "synths":
        # the track chains (chorus, reverb) stream within their budgets
        assert d <= BUDGETS["chorus"] + BUDGETS["reverb"], d
    else:
        assert d == 0


@pytest.mark.parametrize("name", ["drums", "samplers"])
def test_seek_equals_the_slice(songs, name):
    _, ts, _, _ = songs[name]
    full = np.concatenate([c.get_frame_array()
                           for c in ts.mix_generator(chunk_frames=1000)])
    for seek in (1, 7777, len(full) - 10):
        got = np.concatenate([c.get_frame_array() for c in
                              ts.mix_generator(chunk_frames=2048,
                                               start_frame=seek)])
        assert np.array_equal(got, full[seek:])
    assert list(ts.mix_generator(start_frame=len(full))) == []
    with pytest.raises(ValueError, match="start_frame"):
        list(ts.mix_generator(start_frame=-1))


def test_streaming_matches_jax_streaming(songs):
    js, ts, _, _ = songs["samplers"]
    a = np.concatenate([c.get_frame_array()
                        for c in js.mix_generator(chunk_frames=3000,
                                                  start_frame=2500)])
    b = np.concatenate([c.get_frame_array()
                        for c in ts.mix_generator(chunk_frames=3000,
                                                  start_frame=2500)])
    assert _lsb(a, b) <= BOUND["samplers"]


@pytest.mark.parametrize("name", ["drums", "synths", "fx"])
def test_stems_match_jax(songs, name):
    js, ts, _, _ = songs[name]
    jst, tst = js.mix_stems(), ts.mix_stems()
    assert sorted(jst) == sorted(tst)
    bound = 0 if name == "drums" else BOUND[name]
    for k in jst:
        assert _lsb(jst[k].get_frame_array(), tst[k].get_frame_array()) \
            <= bound, k


def test_stems_sum_to_the_premaster_mix(songs):
    """Without a stem that clips on its own, the stems add up to the
    pre-master mix exactly (drum and sampler stems are integer sums)."""
    _, ts, _, tm = songs["samplers"]
    stems = [s.get_frame_array().astype(np.int64)
             for s in ts.mix_stems().values()]
    assert max(np.abs(s).max() for s in stems) < 32767
    assert _lsb(np.clip(sum(stems), -32768, 32767), tm) == 0


@pytest.mark.parametrize("name", list(SONGS))
def test_export_midi_bytes_equal(songs, name):
    js, ts, _, _ = songs[name]
    assert js.export_midi() == ts.export_midi()
    assert js.export_midi(bpm=97) == ts.export_midi(bpm=97)


def test_song_defaults_to_the_card(kit):
    if torch.cuda.is_available():
        pytest.skip("a card is present")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        T.Song()
    with pytest.raises(RuntimeError, match="no CUDA device"):
        T.Song.from_string(DRUMS, kit)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        T.Song.from_ini(__file__)
    song = T.Song(device="cpu")
    assert song.device == torch.device("cpu")


def test_mesh_raises_naming_item_12(songs):
    """mesh= no longer raises (queue 1 item 12 is ported,
    ``parallel.mesh``): the drum song's hits shard with an exact int32
    merge, offline and streamed."""
    from synthesizer_tpu_torch.parallel.mesh import voice_mesh
    _, ts, _, _ = songs["drums"]
    mesh = voice_mesh(4, devices=[torch.device("cpu")] * 4)
    want = ts.mix(normalize=False).get_frame_array()
    np.testing.assert_array_equal(
        ts.mix(normalize=False, mesh=mesh).get_frame_array(), want)
    got = np.concatenate([c.get_frame_array() for c in
                          ts.mix_generator(chunk_frames=2000, mesh=mesh)])
    np.testing.assert_array_equal(got, want[:len(got)])


BAD_SONGS = [
    ("[song]\nbpm = 0\nticks = 4\npatterns = a\n", "bpm and ticks"),
    ("[song]\nbpm = 100\nticks = 4\nswing = 0.99\npatterns = a\n", "swing"),
    ("[song]\nbpm = 100\nticks = 4\npatterns = a\n[synth.s]\nwave = sine\n"
     "[pattern.a]\ns = Z9\n", "invalid note|note"),
    ("[song]\nbpm = 100\nticks = 4\npatterns = a\n[synth.s]\nwave = sine\n"
     "[pattern.a]\ns = C4@x\n", "velocity"),
    ("[song]\nbpm = 100\nticks = 4\npatterns = a\n[fx]\nwobble = x=1\n",
     "unknown effect"),
    ("[song]\nbpm = 100\nticks = 4\npatterns = a\n[fx.ghost]\n"
     "reverb = wet=0.1\n", "unknown instrument"),
    ("[song]\nbpm = 100\nticks = 4\npatterns = a\n[synth.s]\nwave = sine\n"
     "[fx.s]\nlimiter = ceiling_db=-1\n", "master-chain only"),
    ("[song]\nbpm = 100\nticks = 4\npatterns = a\n[automation]\n"
     "master.volume = 0:1 0:2\n", "strictly"),
    ("[song]\nbpm = 100\nticks = 4\npatterns = a\n[automation]\n"
     "fx.reverb.wet = 0:1\n", "no reverb entry"),
    ("[song]\nbpm = 100\nticks = 4\npatterns = a\n[automation]\n"
     "wobble = 0:1\n", "not understood"),
    ("[song]\nbpm = 100\nticks = 4\npatterns = a\n[fx]\n"
     "chorus = rate_beats=0\n", "rate_beats"),
]


@pytest.mark.parametrize("text,match", BAD_SONGS)
def test_errors_match_jax(kit, text, match):
    """Song text errors: the port raises what the JAX package raises,
    with the same message."""
    def run(mod, **kw):
        song = mod.Song.from_string(text, kit, **kw)
        song.compile_synth_voices()
        return song

    with pytest.raises(Exception) as jerr:
        run(J)
    with pytest.raises(type(jerr.value), match=match) as terr:
        run(T, device="cpu")
    assert str(terr.value) == str(jerr.value)


def test_unknown_pattern_instrument_and_sampler_errors(kit):
    for mod, kw in ((J, {}), (T, {"device": "cpu"})):
        song = mod.Song.from_string(
            "[song]\nbpm = 100\nticks = 4\npatterns = a\n"
            "[pattern.a]\nghost = x...\n", kit, **kw)
        with pytest.raises(KeyError, match="unknown instrument ghost"):
            song.compile_schedule()
    msgs = []
    for mod, kw in ((J, {}), (T, {"device": "cpu"})):
        with pytest.raises(ValueError) as err:
            mod.Song.from_string(
                "[song]\nbpm = 100\nticks = 4\npatterns = a\n"
                "[sampler.p]\nfile = pluck.wav\nloop_start = 0.1\n"
                "loop_end = 0.5\n", kit, **kw)
        msgs.append(str(err.value))
    assert msgs[0] == msgs[1] and "outside the sample" in msgs[0]
