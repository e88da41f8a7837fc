"""The port's sharded render (``synthesizer_tpu_torch.parallel``,
``Song.mix(mesh=)``, ``mix_generator(mesh=)``, ``render_midi(mesh=)`` and
the dry run) held against the JAX package's sharded render on the 8
virtual CPU devices that ``tests/conftest.py`` sets up, and against the
port's single-device render, on eight CPU shards.

Tolerances (the bounds of ``tests/test_parallel.py``):
- the sharded f32 render: atol 2e-5 against JAX's and against the port's
  single-device render (the f32 summation order across shards);
- songs and MIDI: 1 LSB at int16 against both; drum-only songs bit-exact;
- sharded streaming == sharded offline, bit for bit, with a seek;
- track fx automation: 4 LSB (the synth bus's 1 LSB through the filter);
- the swept master chain: ``ops.coeffs.master_chain_error_bound``;
- two runs of a sharded render: identical bytes (the fixed shard order).
"""

import dataclasses

import numpy as np
import pytest
import torch

from synthesizer_tpu.models import voicebank as JVB
from synthesizer_tpu.parallel import mesh as JM
from synthesizer_tpu_torch.models.voicebank import (WAVE_IDS, VoiceBank,
                                                    pack_voices)
from synthesizer_tpu_torch.parallel import mesh as PM
from synthesizer_tpu_torch.parallel.dryrun import _demo_voices, dryrun_multichip

SR = 8000
CPU8 = [torch.device("cpu")] * 8


@pytest.fixture(scope="module")
def mesh():
    return PM.voice_mesh(8, devices=CPU8)


def _lsb(a, b):
    a, b = np.asarray(a), np.asarray(b)
    assert a.shape == b.shape, (a.shape, b.shape)
    return int(np.abs(a.astype(np.int64) - b.astype(np.int64)).max())


def _jax_voices(voices):
    return [JVB.Voice(**dataclasses.asdict(v)) for v in voices]


def test_render_song_sharded_matches_jax_and_single_device(mesh):
    voices = _demo_voices(64)
    total = 2048
    jvp = JVB.pack_voices(_jax_voices(voices), SR, num_harmonics=4)
    want = np.asarray(JM.render_song_sharded(
        jvp, total, SR, chunk_frames=512, num_harmonics=4,
        mesh=JM.voice_mesh(8)))
    vp = pack_voices(voices, SR, num_harmonics=4, device="cpu")
    got = PM.render_song_sharded(vp, total, SR, chunk_frames=512,
                                 num_harmonics=4, mesh=mesh)
    assert got.dtype == torch.float32 and tuple(got.shape) == (total, 2)
    np.testing.assert_allclose(got.numpy(), want, atol=2e-5)
    single = VoiceBank(64, SR, chunk_frames=512, num_harmonics=4,
                       device="cpu").render_song(vp, total)
    np.testing.assert_allclose(got.numpy(), single.numpy(), atol=2e-5)
    # the partials add in a fixed order: a second run gives the same bytes
    again = PM.render_song_sharded(vp, total, SR, chunk_frames=512,
                                   num_harmonics=4, mesh=mesh)
    assert torch.equal(got, again)


def test_shards_are_contiguous_row_blocks_with_the_whole_lists_flags(
        mesh, monkeypatch):
    """Shard i holds rows [i*V/n, (i+1)*V/n); every shard's bank takes the
    flags of the WHOLE voice list, so all shards run one specialisation."""
    voices = _demo_voices(13)
    voices[0] = dataclasses.replace(voices[0], glide_from=55.0,
                                    glide_time=0.05)
    vp = pack_voices(voices, SR, num_harmonics=8, pad_to=8, device="cpu")
    shards, seg = PM.voice_shards(voices, SR, mesh)
    assert seg is None
    assert len(shards) == 8 and all(s.device.type == "cpu" for s in shards)
    assert int(vp.wave.shape[0]) == 16
    for i, s in enumerate(shards):
        for a, b in zip(s, vp):
            assert torch.equal(a, b[2 * i:2 * i + 2])
    flags = PM.voice_flags(voices)
    uw = flags["used_waves"]
    assert flags == dict(
        used_waves=tuple(sorted({WAVE_IDS[v.wave] for v in voices})),
        use_fm=True, use_glide=True, use_bend=False, use_amp=False,
        use_dmod=False)
    assert len(uw) == 8
    seen = []
    real = VoiceBank.render_song

    def spy(self, vp, total):
        seen.append((self.used_waves, self.use_fm, self.use_glide))
        return real(self, vp, total)
    monkeypatch.setattr(VoiceBank, "render_song", spy)
    PM.render_song_sharded(shards, 256, SR, chunk_frames=256, mesh=mesh,
                           **flags)
    assert seen == [(uw, True, True)] * 8
    # the pass's renderer works out the same flags from the voices
    seen.clear()
    mesh.renderer(torch.device("cpu"), SR).synth_song(voices, 256, 256)
    assert seen == [(uw, True, True)] * 8


def test_indivisible_voice_count_raises(mesh):
    vp = pack_voices(_demo_voices(12), SR, pad_to=4, device="cpu")
    with pytest.raises(ValueError, match="not divisible"):
        PM.render_song_sharded(vp, 256, SR, chunk_frames=128, mesh=mesh)


def test_voice_mesh_has_no_cpu_fallback():
    """The reference falls back to the CPU backend when fewer devices
    exist than asked for; the port raises unless the caller names them."""
    if torch.cuda.device_count() < 8:
        with pytest.raises(ValueError, match="need 8 devices"):
            PM.voice_mesh(8)
    if not torch.cuda.is_available():
        with pytest.raises(ValueError):
            PM.voice_mesh()
    m = PM.voice_mesh(4, devices=CPU8)
    assert m.size == 4 and m.shape == {"voices": 4}
    assert m.devices == (torch.device("cpu"),) * 4


def _instruments():
    """The kick and hat of ``tests/test_parallel.py``'s song as seeded
    numpy int16 stereo frames, so both packages mix the same samples."""
    t = np.arange(int(0.05 * 44100)) / 44100.0
    env = np.minimum(1.0, (0.05 - t) / 0.04)
    kick = 0.8 * np.sin(2 * np.pi * 60.0 * t) * env
    hat = 0.4 * np.random.default_rng(3).uniform(-1, 1, int(0.02 * 44100))
    return {name: np.repeat(np.rint(x * 32767).astype(np.int16)[:, None], 2,
                            axis=1)
            for name, x in (("kick", kick), ("hat", hat))}


def _make_song(pkg):
    """``tests/test_parallel.py``'s song, built with the JAX package
    (pkg="jax") or the port on the CPU (pkg="torch")."""
    if pkg == "jax":
        from synthesizer_tpu.sample import Sample
        from synthesizer_tpu.sequencer import Song, SynthDef
        song, kw = Song(), {}
    else:
        from synthesizer_tpu_torch.sample import Sample
        from synthesizer_tpu_torch.sequencer import Song, SynthDef
        song, kw = Song(device="cpu"), {"device": "cpu"}
    song.bpm = 480
    song.ticks = 2
    for name, frames in _instruments().items():
        song.add_instrument(name, Sample.from_array(frames, 44100, 2, **kw))
    song.add_synth("lead", SynthDef(wave="square_bl", amplitude=0.2,
                                    release=0.02))
    song.add_synth("bass", SynthDef(wave="sine", amplitude=0.25, release=0.02,
                                    fm_frequency=4.0, fm_depth=0.01))
    song.add_pattern("a", {"kick": "x.x.x.x.", "hat": "xxxxxxxx",
                           "lead": "C4 . E4 . G4 . C5 .",
                           "bass": "C2 - - - G2 - - -"})
    song.pattern_sequence = ["a", "a"]
    return song


def _drums_only(song):
    song.synths.clear()
    for p in song.patterns.values():
        p.pop("lead", None)
        p.pop("bass", None)
    return song


def test_song_mix_sharded_matches_jax_and_single_device(mesh):
    song = _make_song("torch")
    jsong = _make_song("jax")
    got = song.mix(normalize=False, mesh=mesh).get_frame_array()
    want = jsong.mix(normalize=False,
                     mesh=JM.voice_mesh(8)).get_frame_array()
    assert _lsb(got, want) <= 1
    single = song.mix(normalize=False).get_frame_array()
    assert _lsb(got, single) <= 1
    assert np.array_equal(
        got, song.mix(normalize=False, mesh=mesh).get_frame_array())

    # drum-only: the int32 merge is bit-exact against the single device
    # and against the JAX package's sharded mix
    drum = _drums_only(_make_song("torch"))
    a = drum.mix(normalize=False).get_frame_array()
    b = drum.mix(normalize=False, mesh=mesh).get_frame_array()
    np.testing.assert_array_equal(a, b)
    jb = _drums_only(_make_song("jax")).mix(
        normalize=False, mesh=JM.voice_mesh(8)).get_frame_array()
    np.testing.assert_array_equal(b, jb)


def test_song_streaming_sharded_equals_offline(mesh):
    song = _make_song("torch")
    offline = song.mix(normalize=False, mesh=mesh).get_frame_array()
    got = np.concatenate([c.get_frame_array() for c in
                          song.mix_generator(chunk_frames=1000, mesh=mesh)])
    np.testing.assert_array_equal(got, offline[:len(got)])
    # seek composes with sharding: resume mid-song, mid-chunk
    k = 3217
    got = np.concatenate([c.get_frame_array() for c in song.mix_generator(
        chunk_frames=1000, mesh=mesh, start_frame=k)])
    np.testing.assert_array_equal(got, offline[k:k + len(got)])


def test_pitched_sampler_rows_shard_exactly(mesh, tmp_path):
    """Sampler rows padded to a multiple of the mesh size: the sharded
    mix equals the single-device one bit for bit, offline and streamed
    with a seek (one-shot and looped notes, track volume automation)."""
    from synthesizer_tpu_torch import WaveSynth
    from synthesizer_tpu_torch.sequencer import Song
    ws = WaveSynth(samplerate=44100, samplewidth=2, device="cpu")
    ws.sine(261.63, 0.15, amplitude=0.5).stereo().write_wav(
        str(tmp_path / "g.wav"))
    ws.sine(130.81, 0.4, amplitude=0.3).stereo().write_wav(
        str(tmp_path / "pad.wav"))
    (tmp_path / "s.ini").write_text(
        "[song]\nbpm = 240\nticks = 4\npatterns = a\n"
        "[sampler.g]\nfile = g.wav\nbase_note = C4\n"
        "[sampler.pad]\nfile = pad.wav\nbase_note = C3\nloop_start = 0.1\n"
        "loop_end = 0.3\nrelease = 0.05\n"
        "[pattern.a]\ng = C4 E4 G4 C5 . A4 F4 .\npad = C3 - - . E3 - - -\n"
        "[automation]\ntrack.g.volume = 0:1 6:0.5\n")
    song = Song.from_ini(str(tmp_path / "s.ini"), device="cpu")
    single = song.mix(normalize=False).get_frame_array()
    sharded = song.mix(normalize=False, mesh=mesh).get_frame_array()
    np.testing.assert_array_equal(sharded, single)
    k = 1234
    got = np.concatenate([c.get_frame_array() for c in song.mix_generator(
        chunk_frames=700, mesh=mesh, start_frame=k)])
    np.testing.assert_array_equal(got, single[k:k + len(got)])


def _bend_midi():
    from synthesizer_tpu_torch.midi import MidiNote, write_midi
    notes = [MidiNote(0.02 * i, 0.25, 52 + 3 * i, 90 + i, 0)
             for i in range(10)]
    return write_midi(
        notes,
        bends=[(0.05, 0, 0), (0.15, 0, 4096), (0.25, 0, 8191)],
        controls=[(0.1, 0, 1, 30), (0.2, 0, 1, 100),      # CC1 sweep
                  (0.12, 0, 11, 90), (0.22, 0, 11, 40)],  # CC11 fade
        pressures=[(0.18, 0, 80)])


def test_midi_render_sharded_matches_jax_and_single_device(mesh):
    from synthesizer_tpu.midi import render_midi as jrender
    from synthesizer_tpu.sequencer import SynthDef as JSynthDef
    from synthesizer_tpu_torch.midi import render_midi
    from synthesizer_tpu_torch.sequencer import SynthDef
    kw = dict(wave="sine", amplitude=0.4, attack=0.005, decay=0.02,
              sustain_level=0.8, release=0.05)
    data = _bend_midi()
    got = render_midi(data, instruments={0: SynthDef(**kw)}, samplerate=SR,
                      mesh=mesh, device="cpu")
    assert got.device.type == "cpu" and got.samplewidth == 2
    got = got.get_frame_array()
    single = render_midi(data, instruments={0: SynthDef(**kw)},
                         samplerate=SR, device="cpu").get_frame_array()
    assert _lsb(got, single) <= 1
    assert np.abs(got.astype(np.int64)).max() > 1000
    want = jrender(data, instruments={0: JSynthDef(**kw)}, samplerate=SR,
                   mesh=JM.voice_mesh(8)).get_frame_array()
    assert _lsb(got, want) <= 1


def test_track_fx_automation_sharded_matches_single_device(mesh):
    song = _make_song("torch")
    song.add_track_fx("lead", [("filter", "kind=lowpass cutoff=2000")])
    song.add_track_fx("kick", [("echo", "delay=0.03 feedback=0.4 wet=0.1")],
                      bus=True)
    song.add_automation("fx.lead.filter.cutoff", "0:300 16:8000")
    song.add_automation("fx.kick.echo.wet", "0:0.0 16:0.7")
    single = song.mix(normalize=False).get_frame_array()
    sharded = song.mix(normalize=False, mesh=mesh).get_frame_array()
    assert _lsb(sharded, single) <= 4
    got = np.concatenate([c.get_frame_array() for c in
                          song.mix_generator(chunk_frames=1000, mesh=mesh)])
    assert _lsb(got, sharded[:len(got)]) <= 4


def test_master_chain_budget_formula_tracks(mesh):
    """The swept-chain bound is the reference's formula (copied into the
    port's ``ops.coeffs``); the sharded mix stays within it as the chain
    varies, and the bound responds to the knobs."""
    from synthesizer_tpu.ops.coeffs import master_chain_error_bound as jbound
    from synthesizer_tpu_torch.ops.coeffs import master_chain_error_bound

    def diff(fx_lines, autos):
        song = _make_song("torch")
        for name, params in fx_lines:
            song.add_fx(name, **params)
        for target, curve in autos:
            song.add_automation(target, curve)
        return _lsb(song.mix(normalize=False, mesh=mesh).get_frame_array(),
                    song.mix(normalize=False).get_frame_array())

    light = [("eq_band", {"kind": "peaking", "freq": 1200.0, "q": 1.0,
                          "gains_db": [2.0]}),
             ("echo", {"feedback": 0.2, "wet": 0.2, "dry": 1.0}),
             ("width", {"amount": 1.1})]
    heavy = [("eq_band", {"kind": "peaking", "freq": 1200.0, "q": 1.0,
                          "gains_db": [-9.0, 6.0]}),
             ("echo", {"feedback": 0.6, "wet": 0.5, "dry": 1.0}),
             ("phaser", {"stages": 4, "q": 0.7071, "min_freq": 300.0,
                         "max_freq": 3000.0, "wet": 0.7, "dry": 1.0}),
             ("width", {"amount": 2.0}),
             ("limiter", {})]
    b_light = master_chain_error_bound(light, 44100, e_in_lsb=2.0)
    b_heavy = master_chain_error_bound(heavy, 44100, e_in_lsb=2.0)
    assert b_light == jbound(light, 44100, e_in_lsb=2.0)
    assert b_heavy == jbound(heavy, 44100, e_in_lsb=2.0)
    assert b_heavy > b_light > 2.0
    assert diff([("eq", dict(mid_db=2, mid_freq=1200)),
                 ("echo", dict(delay=0.05, feedback=0.2, wet=0.2)),
                 ("width", dict(amount=1.1))], []) <= b_light
    assert diff([("eq", dict(mid_db=6, mid_freq=1200)),
                 ("echo", dict(delay=0.05, feedback=0.6, wet=0.5)),
                 ("phaser", dict(rate=0.8, depth=1.0, stages=4, wet=0.7)),
                 ("width", dict(amount=2.0)),
                 ("limiter", dict(ceiling_db=-2, lookahead=0.003))],
                [("fx.eq.mid_db", "0:-9 2:6")]) <= b_heavy


def test_dryrun_multichip_on_eight_cpu_shards():
    out = dryrun_multichip(8, devices=CPU8)
    assert out["song_lsb"] <= 2 and out["midi_lsb"] <= 1
    assert out["master_chain_lsb"] <= out["master_chain_bound"]


def test_entry_matches_the_graft_entry():
    """entry() renders the demo bank's first chunk as the reference's
    ``__graft_entry__.entry`` does (within the bank's f32 order)."""
    import jax.numpy as jnp
    from synthesizer_tpu.models.voicebank import render_block
    from synthesizer_tpu_torch.parallel.dryrun import entry
    fn, (vp, n0) = entry(device="cpu")
    got = fn(vp, n0)
    assert tuple(got.shape) == (2048, 2) and bool(torch.isfinite(got).all())
    jvp = JVB.pack_voices(_jax_voices(_demo_voices(64)), 44100,
                          num_harmonics=8)
    want = np.asarray(render_block(jvp, jnp.int32(0), 2048, 44100, 8))
    np.testing.assert_allclose(got.numpy(), want, atol=2e-5)


@pytest.mark.parametrize("fx", [False, True])
def test_song_paths_go_through_the_mesh(mesh, monkeypatch, tmp_path, fx):
    """Under mesh= every sharded branch of mix and mix_generator runs
    through the mesh's renderer: the drum scatter, the pitched rows and the
    synth voices (flat, or grouped when a synth track has an [fx.TRACK]
    chain) once offline; the synth once a streamed pass, the drum and
    pitched bodies once a chunk."""
    from synthesizer_tpu_torch.sample import Sample
    calls = {}

    def spy(name):
        real = getattr(PM.ShardedRender, name)

        def wrapped(*a, **k):
            calls[name] = calls.get(name, 0) + 1
            return real(*a, **k)
        monkeypatch.setattr(PM.ShardedRender, name, wrapped)

    for name in ("scatter", "pitched_song", "synth_song", "grouped_song",
                 "drum_chunk", "pitched_chunk", "synth_chunks",
                 "grouped_chunks"):
        spy(name)
    song = _make_song("torch")
    song.add_sampler("smp", Sample.from_array(_instruments()["kick"], 44100,
                                              2, device="cpu"), "C4")
    song.patterns["a"]["smp"] = "C4 . E4 . . G4 . ."
    if fx:
        song.add_track_fx("lead", [("filter", "kind=lowpass cutoff=2000")])
    want = song.mix(normalize=False).get_frame_array()
    got = song.mix(normalize=False, mesh=mesh).get_frame_array()
    assert _lsb(got, want) <= (4 if fx else 1)
    streamed = np.concatenate([c.get_frame_array() for c in
                               song.mix_generator(chunk_frames=1000,
                                                  mesh=mesh)])
    assert _lsb(streamed, got[:len(streamed)]) <= (4 if fx else 0)
    nchunks = -(-len(streamed) // 1000)
    synth = ("grouped_song", "grouped_chunks")
    flat = ("synth_song", "synth_chunks")
    assert calls == {"scatter": 1, "pitched_song": 1,
                     "drum_chunk": nchunks, "pitched_chunk": nchunks,
                     **{n: 1 for n in (synth if fx else flat)}}
