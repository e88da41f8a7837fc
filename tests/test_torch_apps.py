"""The port's apps (``synthesizer_tpu_torch.apps``: trackmixer, the keyboard
synthesizer, the jukebox) against the repo's root apps on the JAX package,
on the CPU, on the same files.  Mirrors ``tests/test_apps.py`` and, through
``tests/fake_tk.py``, ``tests/test_gui_behavior.py``.

Tolerances:
- trackmixer's offline mix and MIDI render: 1 LSB at 16 bit (the voice
  bank's summation order); the ``.mid`` export and the preset files:
  equal bytes; MIDI stems: each within 1 LSB of the reference's stem over
  its length and zero after it (the port pads every stem to the longest);
- the keyboard's keys, FM routing, wavetable and arpeggio: 1 LSB; its
  filter: the Biquad budget of ``tests/test_torch_graph.py`` (f32 scans
  in another order, each within a few LSB of the f64 oracle); sampler
  mode (the exact ratecv) and the library's rows: equal;
- the jukebox: crossfade and pause 1 LSB, loudness 0.01 LU (the budget of
  ``tests/test_torch_loudness.py``), the limiter's ``ops.effects.BUDGETS``.
"""

import io
import sys
import threading
import time
import wave
from pathlib import Path

import numpy as np
import pytest
import torch

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))

import fake_tk  # noqa: E402
import keyboard_gui as ref_kb  # noqa: E402
import trackmixer as ref_tm  # noqa: E402
from jukebox import backend as ref_backend  # noqa: E402
from jukebox import box as ref_box  # noqa: E402
from synthesizer_tpu_torch.apps import keyboard_gui as kb  # noqa: E402
from synthesizer_tpu_torch.apps import trackmixer as tm  # noqa: E402
from synthesizer_tpu_torch.apps.jukebox import backend, box  # noqa: E402
from synthesizer_tpu_torch.midi import MidiNote, write_midi  # noqa: E402
from synthesizer_tpu_torch.ops.effects import BUDGETS  # noqa: E402

SR = 44100
CPU = torch.device("cpu")


def _lsb(a, b):
    a, b = np.asarray(a), np.asarray(b)
    assert a.shape == b.shape, (a.shape, b.shape)
    return int(np.abs(a.astype(np.int64) - b.astype(np.int64)).max()) \
        if a.size else 0


def _write(path, frames, rate=SR):
    frames = np.asarray(frames, np.int16)
    if frames.ndim == 1:
        frames = frames[:, None]
    with wave.open(str(path), "wb") as w:
        w.setnchannels(frames.shape[1])
        w.setsampwidth(2)
        w.setframerate(rate)
        w.writeframes(frames.tobytes())


def _read(path):
    with wave.open(str(path)) as w:
        a = np.frombuffer(w.readframes(w.getnframes()), np.int16)
        return a.reshape(-1, w.getnchannels()), w.getframerate()


def _tone(freq, seconds, amp, rate=SR, nch=2):
    t = np.arange(int(seconds * rate)) / rate
    x = np.rint(amp * 32767 * np.sin(2 * np.pi * freq * t)).astype(np.int16)
    return np.repeat(x[:, None], nch, axis=1)


SONG_INI = """
[song]
bpm = 250
ticks = 4
patterns = a a

[paths]
samples = samples/

[instruments]
kick = kick.wav
hat = hat.wav

[synth.lead]
wave = sine
amplitude = 0.3
release = 0.05

[pattern.a]
kick = x... x...
hat  = x.x. x.x.
lead = C4 . E4 . G4 . C5 .
"""


@pytest.fixture
def song_dir(tmp_path):
    """A drum + synth song over seeded numpy WAVs."""
    d = tmp_path / "samples"
    d.mkdir()
    t = np.arange(int(0.1 * SR)) / SR
    kick = 0.8 * np.sin(2 * np.pi * 60.0 * t) * np.exp(-t * 30)
    hat = 0.4 * np.random.default_rng(1).uniform(-1, 1, int(0.05 * SR)) \
        * np.exp(-np.arange(int(0.05 * SR)) / SR * 60)
    for name, x in (("kick", kick), ("hat", hat)):
        _write(d / f"{name}.wav", np.repeat(
            np.rint(x * 32767).astype(np.int16)[:, None], 2, axis=1))
    (tmp_path / "song.ini").write_text(SONG_INI)
    return tmp_path


def _midi_file(path):
    """Three channels of different lengths (melody, bass, drums)."""
    notes = [MidiNote(0.1 * i, 0.15, 60 + 2 * i, 100, 0) for i in range(6)]
    notes += [MidiNote(0.0, 0.3, 40, 100, 1), MidiNote(0.3, 0.2, 43, 90, 1)]
    notes += [MidiNote(0.0, 0.1, 36, 110, 9), MidiNote(0.25, 0.1, 38, 110, 9)]
    path.write_bytes(write_midi(notes, bends=[(0.2, 0, 4096)],
                                controls=[(0.1, 1, 11, 70)]))
    return path


# -- trackmixer -------------------------------------------------------------

def test_trackmixer_offline_mix(song_dir, capsys):
    out, ref = song_dir / "out.wav", song_dir / "ref.wav"
    assert tm.main([str(song_dir / "song.ini"), "-o", str(out),
                    "--device", "cpu"]) == 0
    assert "x realtime" in capsys.readouterr().out
    assert ref_tm.main([str(song_dir / "song.ini"), "-o", str(ref)]) == 0
    got, rate = _read(out)
    want, _ = _read(ref)
    assert rate == SR and got.shape[1] == 2 and len(got) > SR // 4
    assert _lsb(got, want) <= 1
    # --no-normalize, and the mix the CLI writes is Song.mix's
    assert tm.main([str(song_dir / "song.ini"), "-o", str(out),
                    "--no-normalize", "--device", "cpu"]) == 0
    from synthesizer_tpu_torch.sequencer import Song
    direct = Song.from_ini(str(song_dir / "song.ini"), device="cpu").mix(
        normalize=False).get_frame_array()
    np.testing.assert_array_equal(_read(out)[0], direct)


def test_trackmixer_midi_export(song_dir, capsys):
    """-o file.mid exports the song's notes: the reference's bytes."""
    out, ref = song_dir / "out.mid", song_dir / "ref.mid"
    assert tm.main([str(song_dir / "song.ini"), "-o", str(out),
                    "--device", "cpu"]) == 0
    assert "exported note events" in capsys.readouterr().out
    assert ref_tm.main([str(song_dir / "song.ini"), "-o", str(ref)]) == 0
    assert out.read_bytes() == ref.read_bytes()


def test_trackmixer_midi_render(tmp_path, capsys):
    mid = _midi_file(tmp_path / "in.mid")
    out, ref = tmp_path / "out.wav", tmp_path / "ref.wav"
    assert tm.main([str(mid), "-o", str(out), "--device", "cpu"]) == 0
    assert "rendered MIDI" in capsys.readouterr().out
    assert ref_tm.main([str(mid), "-o", str(ref)]) == 0
    got, want = _read(out)[0], _read(ref)[0]
    assert np.abs(got.astype(np.int64)).max() > 1000
    assert _lsb(got, want) <= 1


def test_trackmixer_midi_stems_are_padded(tmp_path, capsys):
    """One stem per channel, every stem as long as the longest; over its
    own length each equals the reference's stem, silence after."""
    mid = _midi_file(tmp_path / "s.mid")
    stems, ref = tmp_path / "stems", tmp_path / "ref"
    assert tm.main([str(mid), "--stems", str(stems), "--device", "cpu"]) == 0
    assert "3 MIDI channel stems" in capsys.readouterr().out
    assert ref_tm.main([str(mid), "--stems", str(ref)]) == 0
    names = sorted(p.name for p in stems.iterdir())
    assert names == ["ch00.wav", "ch01.wav", "ch09_drums.wav"]
    assert names == sorted(p.name for p in ref.iterdir())
    got = {n: _read(stems / n)[0] for n in names}
    want = {n: _read(ref / n)[0] for n in names}
    longest = max(len(w) for w in want.values())
    assert len({len(w) for w in want.values()}) > 1     # unpadded there
    for n in names:
        assert len(got[n]) == longest
        w = want[n]
        assert _lsb(got[n][:len(w)], w) <= 1
        assert not got[n][len(w):].any()
        assert np.abs(w.astype(np.int64)).max() > 500


def test_trackmixer_midi_refusals_and_play(tmp_path, capsys):
    mid = _midi_file(tmp_path / "p.mid")
    with pytest.raises(SystemExit):
        tm.main([str(mid), "-o", str(tmp_path / "out.mid"),
                 "--device", "cpu"])
    assert "already a MIDI file" in capsys.readouterr().err
    assert tm.main([str(mid), "--play", "--device", "cpu"]) == 0
    assert "played MIDI" in capsys.readouterr().out
    assert not (tmp_path / "p.wav").exists()
    if not torch.cuda.is_available():
        # the card is the default, and without one the CLI says so
        with pytest.raises(SystemExit):
            tm.main([str(mid)])
        assert "--device cpu" in capsys.readouterr().err


def _repl_pair(song_dir):
    from synthesizer_tpu.sequencer import Song as JSong
    from synthesizer_tpu_torch.sequencer import Song
    ini = str(song_dir / "song.ini")
    return (tm.TrackmixerRepl(Song.from_ini(ini, device="cpu"), "song.ini"),
            ref_tm.TrackmixerRepl(JSong.from_ini(ini), "song.ini"))


def test_trackmixer_repl_commands(song_dir, capsys, tmp_path):
    repl, ref = _repl_pair(song_dir)
    texts = []
    for r in (repl, ref):
        r.onecmd("info")
        r.onecmd("patterns")
        r.onecmd("play a")
        texts.append(capsys.readouterr().out)
    assert "bpm 250" in texts[0] and "[pattern.a]" in texts[0]
    assert "played pattern a" in texts[0]
    assert texts[0] == texts[1]
    repl.onecmd(f"mix {tmp_path / 'm.wav'}")
    ref.onecmd(f"mix {tmp_path / 'r.wav'}")
    assert _lsb(_read(tmp_path / "m.wav")[0],
                _read(tmp_path / "r.wav")[0]) <= 1
    repl.onecmd(f"stems {tmp_path / 'st'}")
    assert sorted(p.name for p in (tmp_path / "st").iterdir()) == \
        ["hat.wav", "kick.wav", "lead.wav"]
    repl.onecmd("loudness")
    assert "integrated" in capsys.readouterr().out
    repl.do_load(str(song_dir / "song.ini"))
    assert "bpm 250" in capsys.readouterr().out
    repl.do_load("/does/not/exist.ini")
    assert "no such file" in capsys.readouterr().out
    assert repl.song.device == CPU
    assert repl.do_quit("") is True


def test_repl_play_pattern_with_samplers(tmp_path, capsys):
    from synthesizer_tpu_torch.sequencer import Song
    _write(tmp_path / "g.wav", _tone(261.63, 0.08, 0.5))
    (tmp_path / "s.ini").write_text(
        "[song]\nbpm = 240\nticks = 4\npatterns = a\n"
        "[sampler.g]\nfile = g.wav\nbase_note = C4\n"
        "[pattern.a]\ng = C4 .. E4 ..\n"
        "[automation]\ntrack.g.volume = 0:1 2:0.5\n")
    song = Song.from_ini(str(tmp_path / "s.ini"), device="cpu")
    tm.TrackmixerRepl(song, str(tmp_path / "s.ini")).onecmd("play a")
    assert "played pattern a" in capsys.readouterr().out


# -- the keyboard synthesizer -------------------------------------------------

# The mixed-mode pump writes one block of ``fx_lookahead`` chunks a loop,
# and a loop that carries a first fx compile can take seconds on a loaded
# machine.  So a test that needs a finished voice's audio (and its fx tail)
# in the sink waits on the frames the pump has written, with a deadline,
# rather than sleeping a fixed time.
def count_written(out):
    """Count, from now on, the frames ``out``'s pump hands its sink.

    Returns a one-element list holding the running count."""
    written = [0]
    play = out.api.play_chunk

    def counting(frames):
        play(frames)
        written[0] += len(frames)

    out.api.play_chunk = counting
    return written


def wait_written(out, written, tail_frames=0, deadline_s=120.0):
    """Wait until the pump has written two more blocks and ``tail_frames``
    beyond them: the loop that took a voice's last chunk has then reached
    the sink.  Returns whether it did before the deadline."""
    target = (written[0] + 2 * out.fx_lookahead * out.frames_per_chunk
              + tail_frames)
    deadline = time.time() + deadline_s
    while written[0] < target and time.time() < deadline:
        time.sleep(0.02)
    return written[0] >= target


class _Sink:
    def play_chunk(self, frames):
        pass


class _Output:
    """The pump's side of an Output, as the waits above see it."""
    frames_per_chunk = 100
    fx_lookahead = 2

    def __init__(self):
        self.api = _Sink()


@pytest.mark.parametrize("pumping", [True, False], ids=["pump", "idle"])
def test_wait_written_waits_for_the_pump(pumping):
    out = _Output()
    written = count_written(out)
    stop = threading.Event()

    def pump():
        while not stop.is_set():
            out.api.play_chunk(np.zeros((out.frames_per_chunk, 2)))
            time.sleep(0.01)

    thread = threading.Thread(target=pump, daemon=True)
    if pumping:
        thread.start()
    try:
        # two blocks of fx_lookahead chunks, then the tail
        assert wait_written(out, written, tail_frames=50,
                            deadline_s=10.0 if pumping else 0.2) is pumping
        if pumping:
            assert written[0] >= 2 * 2 * 100 + 50
        else:
            assert written[0] == 0
    finally:
        stop.set()
        if pumping:
            thread.join(timeout=5)
            assert not thread.is_alive()


def _controllers():
    return kb.SynthController(samplerate=SR, device="cpu"), \
        ref_kb.SynthController(samplerate=SR)


def _key(ctrl, key=49):
    return ctrl.render_key(key).get_frame_array()


def test_synth_controller_keys_and_fm_routing():
    c, r = _controllers()
    a = _key(c)
    assert np.abs(a).max() > 1000 and np.abs(a[-100:]).max() < 500
    assert _lsb(a, _key(r)) <= 1
    for ctrl in (c, r):
        ctrl.oscs[1].waveform = "sine"
        ctrl.oscs[1].ratio = 0.01        # a low-frequency LFO panel
        ctrl.oscs[1].amplitude = 0.01
        ctrl.oscs[0].fm_source = 1
    from synthesizer_tpu_torch.models import spec as S
    patch = c.build_patch(49)
    assert isinstance(patch.spec, S.Envelope)
    assert patch.spec.source.fm_lfo is not None
    assert _lsb(_key(c), _key(r)) <= 1
    assert c.synth.device == CPU


def test_keyboard_wavetable_echo_and_presets():
    c, r = _controllers()
    for ctrl in (c, r):
        ctrl.oscs[0].waveform = "wavetable"
        ctrl.oscs[0].table = (0.0, 1.0, 0.5, -0.5, -1.0)
        ctrl.echo.enabled = True
        ctrl.env.release = 0.05
        ctrl.arp.intervals = (0, 3, 7)
        ctrl.arp.rate = 6.0
        ctrl.filter.cutoff = 900.0
    a = _key(c, 45)
    assert np.abs(a).max() > 5000
    assert len(a) / SR > c.echo.after + c.echo.amount * c.echo.delay
    assert _lsb(a, _key(r, 45)) <= 1
    # the preset file: the reference's text, and it loads back
    texts = []
    for ctrl in (c, r):
        buf = io.StringIO()
        ctrl.save_preset(buf)
        texts.append(buf.getvalue())
    assert texts[0] == texts[1]
    c2 = kb.SynthController(samplerate=SR, device="cpu")
    c2.load_preset(io.StringIO(texts[1]))
    assert c2.oscs[0].table == (0.0, 1.0, 0.5, -0.5, -1.0)
    assert c2.echo.enabled and c2.env.release == pytest.approx(0.05)
    assert c2.arp.intervals == (0, 3, 7) and c2.arp.rate == 6.0
    buf = io.StringIO()
    c2.save_preset(buf)
    assert buf.getvalue() == texts[0]


@pytest.mark.parametrize("kind,cutoff,tol", [("lowpass", 500.0, 3),
                                             ("highpass", 2000.0, 2)])
def test_keyboard_filter_section(kind, cutoff, tol):
    c, r = _controllers()
    for ctrl in (c, r):
        ctrl.oscs[0].waveform = "sawtooth"
        ctrl.filter.enabled = True
        ctrl.filter.kind = kind
        ctrl.filter.cutoff = cutoff
    assert _lsb(_key(c), _key(r)) <= tol


def test_keyboard_filter_lfo_routing():
    c, r = _controllers()
    for ctrl in (c, r):
        ctrl.oscs[0].waveform = "sawtooth"
        ctrl.oscs[1].waveform = "sine"        # the sweep LFO
        ctrl.oscs[1].ratio = 0.0
        ctrl.oscs[1].detune = 1.0             # 1 Hz
        ctrl.oscs[1].amplitude = 2.0          # +-2 octaves
        ctrl.filter.enabled = True
        ctrl.filter.cutoff = 600.0
        ctrl.filter.lfo_source = 1
    from synthesizer_tpu_torch.models import spec as S
    patch = c.build_raw_patch(49)
    assert isinstance(patch.spec, S.Biquad)
    assert patch.spec.cutoff_lfo is not None
    assert not isinstance(patch.spec.source, S.Mix)
    # the swept-biquad budget of tests/test_torch_graph.py
    assert _lsb(_key(c), _key(r)) <= 6


def test_arpeggiator_cycle_and_mixer():
    from synthesizer_tpu_torch import Output
    c, r = _controllers()
    for ctrl in (c, r):
        ctrl.arp.enabled = True
    cycle = c.render_arpeggio(49)
    assert cycle.nframes == int(len(c.arp.intervals) / c.arp.rate * SR)
    assert _lsb(cycle.get_frame_array(),
                r.render_arpeggio(49).get_frame_array()) <= 1
    out = Output(samplerate=SR, nchannels=2, frames_per_chunk=1470,
                 mixing="mixed")
    try:
        c.output = out
        c.key_down(49)
        assert out.mixer.active_count == 1
        time.sleep(0.1)
        assert out.mixer.active_count == 1      # still looping
        c.key_up(49)
        assert out.mixer.active_count == 0
    finally:
        out.close()


def test_keyboard_sampler_mode(tmp_path):
    from synthesizer_tpu import Sample as JSample
    from synthesizer_tpu_torch import Output, Sample
    src = _tone(261.63, 0.2, 0.5, nch=1)
    _write(tmp_path / "src.wav", src)
    c, r = _controllers()
    c.load_sampler(str(tmp_path / "src.wav"), base_key=60)
    r.load_sampler(JSample(wave_file=str(tmp_path / "src.wav")), base_key=60)
    assert c.sampler_sample.device == CPU
    up = c.render_sampler_key(72)
    assert abs(up.nframes - len(src) / 2) <= 2
    np.testing.assert_array_equal(up.get_frame_array(),
                                  r.render_sampler_key(72).get_frame_array())
    assert c.render_sampler_key(60).nframes == len(src)
    c.load_sampler(Sample.from_array(src, SR, 1, device="cpu"), base_key=60)
    wav = str(tmp_path / "smp.wav")
    with Output(mixing="mixed", frames_per_chunk=2048, wav_file=wav) as out:
        c.output = out
        c.key_down(67)
        deadline = time.time() + 10.0
        while out.still_playing() and time.time() < deadline:
            time.sleep(0.01)
        c.key_up(67)
    assert np.abs(_read(wav)[0]).max() > 1000
    c.clear_sampler()
    assert c.sampler_sample is None


def test_controller_master_reverb_and_limiter(tmp_path):
    """The master chain on the output bus: the reference's stages, on the
    controller's device; the limiter holds its ceiling; presets carry
    both sections."""
    from synthesizer_tpu_torch import Output
    from synthesizer_tpu_torch.ops.coeffs import limiter_ceiling
    wav = str(tmp_path / "kb.wav")
    out = Output(samplerate=SR, nchannels=2, frames_per_chunk=2000,
                 mixing="mixed", wav_file=wav)
    written = count_written(out)
    ref_out = type("Out", (), {"nchannels": 2, "fx": None})()
    try:
        ctrl = kb.SynthController(output=out, device="cpu")
        ref = ref_kb.SynthController(output=ref_out)
        ctrl.voice_lookahead = 1
        for c in (ctrl, ref):
            c.oscs[0].amplitude = 0.9
            c.reverb.enabled = True
            c.reverb.wet = 0.5
            c.limiter.enabled = True
            c.limiter.ceiling_db = -6.0
            c.apply_reverb()
        assert out.fx is not None and len(out.fx.processors) == 2
        assert out.fx.device == CPU and out.fx_lookahead == 4
        assert (out.fx.tail_frames, out.fx.flush_frames) == \
            (ref_out.fx.tail_frames, ref_out.fx.flush_frames)
        # the chain on one chunk: within the reverb's and the limiter's
        # budgets of the reference's chain
        x = _tone(220.0, 0.2, 0.9)
        got = out.fx.process(torch.from_numpy(x)).numpy()
        import jax.numpy as jnp
        want = np.asarray(ref_out.fx.process(jnp.asarray(x)))
        assert _lsb(got, want) <= BUDGETS["reverb"] + BUDGETS["limit"]
        out.fx = None
        ctrl.apply_reverb()          # a fresh chain for the played keys
        for key in (40, 44, 47):     # a loud chord
            ctrl.key_down(key)
        time.sleep(0.2)
        for key in (40, 44, 47):
            ctrl.key_up(key)
        deadline = time.time() + 60.0
        while out.mixer.active_count and time.time() < deadline:
            time.sleep(0.02)
        assert out.mixer.active_count == 0
        assert wait_written(out, written)   # the pump drains the holdback
        buf = io.StringIO()
        ctrl.save_preset(buf)
        buf.seek(0)
        ctrl2 = kb.SynthController(output=out, device="cpu")
        ctrl2.load_preset(buf)
        assert ctrl2.reverb.enabled and ctrl2.limiter.enabled
        assert ctrl2.limiter.ceiling_db == pytest.approx(-6.0)
        ctrl2.reverb.enabled = ctrl2.limiter.enabled = False
        ctrl2.apply_reverb()
        assert out.fx is None
    finally:
        out.close()
    a = _read(wav)[0]
    assert np.abs(a).max() > 1000
    assert np.abs(a.astype(np.int64)).max() <= limiter_ceiling(-6.0, 2)


# -- the jukebox ----------------------------------------------------------------

def _libraries(tmp_path):
    lib = backend.MusicLibrary(device="cpu")
    ref = ref_backend.MusicLibrary()
    assert lib.scan(str(tmp_path)) == ref.scan(str(tmp_path))
    return lib, ref


def test_music_library_rows_match(tmp_path):
    """scan, search, get; AIFF and AU headers through the decoders; the
    same rows as the reference's library."""
    import warnings
    for name, f in (("alpha", 220.0), ("beta", 330.0), ("gamma", 440.0)):
        _write(tmp_path / f"{name}.wav", _tone(f, 0.2, 0.5))
    frames = _tone(220.0, 0.25, 0.5)
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        import aifc
        import sunau
        with aifc.open(str(tmp_path / "brass.aiff"), "wb") as f:
            f.setnchannels(2)
            f.setsampwidth(2)
            f.setframerate(SR)
            f.writeframes(frames.astype(">i2").tobytes())
        with sunau.open(str(tmp_path / "reed.au"), "wb") as f:
            f.setnchannels(2)
            f.setsampwidth(2)
            f.setframerate(SR)
            f.writeframes(frames.tobytes())
    lib, ref = _libraries(tmp_path)
    rows = lib.search("")
    assert len(rows) == 5 and rows == ref.search("")
    hits = lib.search("bet")
    assert len(hits) == 1 and hits[0].title == "beta"
    assert hits[0].duration == pytest.approx(0.2, abs=0.01)
    brass = lib.search("brass")[0]
    assert brass.duration == pytest.approx(0.25, abs=0.01)
    assert (brass.samplerate, brass.nchannels) == (SR, 2)
    assert lib.get(hits[0].track_id) == ref.get(hits[0].track_id)
    # the deck decodes the AIFF on the jukebox's device
    jb = box.Jukebox(lib, crossfade=0.05, device="cpu")
    jb.enqueue(brass)
    chunks = list(jb.chunks())
    assert all(c.device == CPU for c in chunks)
    assert sum(c.nframes for c in chunks) >= int(0.2 * SR)
    lib.close()
    ref.close()


def test_library_migrates_old_schema(tmp_path):
    import sqlite3
    rows = []
    for mod in (backend, ref_backend):
        db = tmp_path / f"{mod.__name__.replace('.', '_')}.db"
        con = sqlite3.connect(str(db))
        con.execute("""CREATE TABLE tracks (
            id INTEGER PRIMARY KEY, path TEXT UNIQUE NOT NULL,
            title TEXT NOT NULL, duration REAL NOT NULL DEFAULT 0,
            samplerate INTEGER NOT NULL DEFAULT 0,
            nchannels INTEGER NOT NULL DEFAULT 0)""")
        con.execute("INSERT INTO tracks(path, title, duration, samplerate, "
                    "nchannels) VALUES ('x.wav', 'x', 1.0, 44100, 2)")
        con.commit()
        con.close()
        lib = mod.MusicLibrary(str(db))
        rows.append(lib.search("x"))
        lib.close()
    assert rows[0] == rows[1] and rows[0][0].lufs is None


def _play(jukebox, tracks):
    for t in tracks:
        jukebox.enqueue(t)
    return np.concatenate([c.get_frame_array() for c in jukebox.chunks()])


def test_jukebox_crossfade_and_pause(tmp_path):
    _write(tmp_path / "a.wav", _tone(440.0, 1.0, 0.5))
    _write(tmp_path / "b.wav", _tone(660.0, 1.0, 0.5))
    lib, ref = _libraries(tmp_path)
    got = _play(box.Jukebox(lib, crossfade=0.3, frames_per_chunk=4410,
                            device="cpu"), lib.search(""))
    want = _play(ref_box.Jukebox(ref, crossfade=0.3, frames_per_chunk=4410),
                 ref.search(""))
    assert 1.4 * SR <= len(got) <= 2.2 * SR
    assert np.abs(got).max() > 5000
    assert _lsb(got, want) <= 1
    jb = box.Jukebox(lib, frames_per_chunk=2205, device="cpu")
    jb.enqueue(lib.search("a")[0])
    gen = jb.chunks()
    assert np.abs(next(gen).get_frame_array()).max() > 1000
    jb.pause()
    assert np.abs(next(gen).get_frame_array()).max() == 0
    jb.resume()
    assert np.abs(next(gen).get_frame_array()).max() > 1000


def test_jukebox_level_match(tmp_path):
    _write(tmp_path / "loud.wav", _tone(997.0, 1.2, 0.5))
    _write(tmp_path / "quiet.wav", _tone(997.0, 1.2, 0.05))
    lib, ref = _libraries(tmp_path)
    loud, quiet = lib.search("loud")[0], lib.search("quiet")[0]
    assert loud.lufs is None                      # the scan reads headers
    loud = lib.measure_loudness(loud.track_id)
    quiet = lib.measure_loudness(quiet.track_id)
    rloud = ref.measure_loudness(loud.track_id)
    assert abs(loud.lufs - rloud.lufs) <= 0.01
    assert abs(loud.lufs - -6.02) < 0.3 and abs(quiet.lufs - -26.02) < 0.3
    assert loud.peak == rloud.peak == pytest.approx(0.5, abs=0.01)
    assert lib.get(loud.track_id).lufs == loud.lufs
    jb = box.Jukebox(lib, crossfade=0.05, frames_per_chunk=4410,
                     level_match=True, target_lufs=-18.0, device="cpu")
    assert jb._trim_for(loud) == pytest.approx(
        10 ** ((-18.0 - loud.lufs) / 20), rel=1e-6)
    assert jb._trim_for(quiet) > 1.0 > jb._trim_for(loud)
    out = _play(jb, [loud, quiet])

    def rms_db(x):
        return 10 * np.log10(np.mean(np.square(x.astype(np.float64)))
                             + 1e-12)
    assert abs(rms_db(out[:int(0.8 * SR)])
               - rms_db(out[-int(0.8 * SR):])) < 2.0
    # an ad-hoc path (no library row) is measured on the jukebox's device
    adhoc = box.Jukebox(level_match=True, target_lufs=-18.0, device="cpu")
    adhoc.enqueue_path(str(tmp_path / "loud.wav"))
    assert adhoc._trim_for(adhoc.playlist[0]) == pytest.approx(
        jb._trim_for(loud), rel=1e-6)
    lib.close()
    ref.close()


def test_jukebox_output_limiter(tmp_path):
    from synthesizer_tpu_torch.ops.coeffs import limiter_ceiling
    _write(tmp_path / "a.wav", _tone(440.0, 1.0, 0.95))
    _write(tmp_path / "b.wav", _tone(445.0, 1.0, 0.95))
    lib, ref = _libraries(tmp_path)
    raw = _play(box.Jukebox(lib, crossfade=0.4, frames_per_chunk=4410,
                            device="cpu"), lib.search(""))
    got = _play(box.Jukebox(lib, crossfade=0.4, frames_per_chunk=4410,
                            limiter_db=-3.0, device="cpu"), lib.search(""))
    want = _play(ref_box.Jukebox(ref, crossfade=0.4, frames_per_chunk=4410,
                                 limiter_db=-3.0), ref.search(""))
    assert len(got) == len(raw) == len(want)     # the flush keeps length
    assert np.abs(raw.astype(np.int64)).max() > limiter_ceiling(-3.0, 2)
    assert np.abs(got.astype(np.int64)).max() <= limiter_ceiling(-3.0, 2)
    assert _lsb(got, want) <= BUDGETS["limit"]


# -- the Tk views, through the fake Tk -------------------------------------------

@pytest.fixture
def faketk():
    mods = fake_tk.install()
    try:
        yield mods
    finally:
        fake_tk.uninstall()


def _synth_gui():
    return kb.SynthGUI(kb.SynthController(device="cpu"))


def test_synth_gui_keys_and_knobs(faketk):
    gui = _synth_gui()
    try:
        ch = kb.KEYBOARD_KEYS[0]
        gui.root.event("<KeyPress>", char=ch)
        assert gui.output.mixer.active_count > 0
        assert kb.FIRST_KEY in gui.ctrl._active
        gui.root.event("<KeyRelease>", char=ch)
        deadline = time.time() + 10.0
        while gui.output.mixer.active_count and time.time() < deadline:
            time.sleep(0.02)
        assert gui.output.mixer.active_count == 0
        gui.root.event("<KeyPress>", char="\t")      # not a key: ignored
        osc0 = fake_tk.find_all(fake_tk.LabelFrame, text="osc 0")[0]
        [w for w in osc0.children if isinstance(w, fake_tk.Scale)
         and w.kw.get("label") == "amp"][0].drive(0.77)
        assert gui.ctrl.oscs[0].amplitude == pytest.approx(0.77)
        gui.wave_vars[0].set("triangle")
        assert gui.ctrl.oscs[0].waveform == "triangle"
        filt = fake_tk.find(fake_tk.LabelFrame, text="filter")
        for w in filt.children:
            if isinstance(w, fake_tk.Checkbutton):
                w.invoke()
            if isinstance(w, fake_tk.Scale) and w.kw.get("label") == "cutoff":
                w.drive(2500)
        assert gui.ctrl.filter.enabled is True
        assert gui.ctrl.filter.cutoff == pytest.approx(2500.0)
    finally:
        gui.output.close()
        gui.root.destroy()


@pytest.mark.parametrize("section", ["reverb", "limiter"])
def test_synth_gui_master_toggles_install_fx(faketk, section):
    gui = _synth_gui()
    try:
        frame = fake_tk.find(fake_tk.LabelFrame, text=section)
        toggle = [w for w in frame.children
                  if isinstance(w, fake_tk.Checkbutton)][0]
        toggle.invoke()
        assert getattr(gui.ctrl, section).enabled is True
        assert gui.output.fx is not None and gui.output.fx.device == CPU
        toggle.invoke()
        assert gui.output.fx is None
    finally:
        gui.output.close()
        gui.root.destroy()


def test_synth_gui_preset_dialog_roundtrip(faketk, tmp_path):
    fd = faketk[2]
    gui = _synth_gui()
    try:
        gui.ctrl.oscs[0].waveform = "square"
        gui.ctrl.oscs[0].amplitude = 0.42
        preset = str(tmp_path / "patch.ini")
        fd.queue.append(preset)
        fake_tk.find(fake_tk.Button, text="save preset").invoke()
        gui.ctrl.oscs[0].waveform = "sine"
        fd.queue.append(preset)
        fake_tk.find(fake_tk.Button, text="load preset").invoke()
        assert gui.ctrl.oscs[0].waveform == "square"
        assert gui.ctrl.oscs[0].amplitude == pytest.approx(0.42)
        assert gui.wave_vars[0].get() == "square"
    finally:
        gui.output.close()
        gui.root.destroy()


def test_jukebox_gui_buttons_drive_engine(faketk, tmp_path):
    _write(tmp_path / "song.wav", _tone(330.0, 0.3, 0.4, rate=22050, nch=1),
           rate=22050)
    lib = backend.MusicLibrary(str(tmp_path / "lib.sqlite"), device="cpu")
    lib.scan(str(tmp_path))
    gui = box.JukeboxGUI(lib, device="cpu")
    try:
        assert len(gui.listbox.entries) == 1
        gui.listbox.select(0)
        fake_tk.find(fake_tk.Button, text="enqueue").invoke()
        assert len(gui.box.playlist) == 1
        fake_tk.find(fake_tk.Button, text="pause").invoke()
        assert gui.box.paused
        fake_tk.find(fake_tk.Button, text="resume").invoke()
        assert not gui.box.paused
        fake_tk.find(fake_tk.Button, text="play").invoke()
        deadline = time.time() + 30.0
        while gui.box.playlist and time.time() < deadline:
            time.sleep(0.05)
        assert not gui.box.playlist, "queued track was never consumed"
        fake_tk.find(fake_tk.Button, text="skip").invoke()
        if gui._thread is not None:
            gui._thread.join(timeout=20.0)
    finally:
        gui.root.destroy()
