"""The port's MIDI path (synthesizer_tpu_torch.midi) against the JAX
package's: the SMF writer's bytes, the parsed notes and the voices equal
on seeded General-MIDI files (bends with RPN ranges, CC7/CC11/CC1/CC64,
channel and poly pressure, percussion, SMPTE timing), and render_notes on
both routes within 1 LSB at int16 of the reference's rendered Sample."""

import dataclasses
import struct

import numpy as np
import pytest
import torch

from synthesizer_tpu import midi as JM
from synthesizer_tpu.sequencer import SynthDef as JSynthDef
from synthesizer_tpu_torch import bench_song
from synthesizer_tpu_torch import midi as TM
from synthesizer_tpu_torch.models import voicebank as T
from synthesizer_tpu_torch.sample import Sample
from synthesizer_tpu_torch.sequencer import SynthDef as TSynthDef

torch.set_num_threads(1)

SR = 44100


def _events(seed, nnotes=90, duration=8.0):
    return bench_song.gm_events(nnotes, duration, seed)


def _to_jax_notes(notes):
    return [JM.MidiNote(*n) for n in notes]


def _write_both(seed, **kw):
    notes, bends, controls, pressures, poly = _events(seed, **kw)
    args = dict(bends=bends, controls=controls, pressures=pressures,
                poly_pressures=poly)
    return (TM.write_midi(notes, **args),
            JM.write_midi(_to_jax_notes(notes), **args))


def _smpte(data: bytes, fps: int, tpf: int) -> bytes:
    """The same track under an SMPTE division (absolute timing)."""
    return data[:12] + bytes([(256 - fps) & 0xFF, tpf]) + data[14:]


def _instruments(mod):
    return {2: mod.SynthDef(wave="pulse", amplitude=0.3, pulse_width=0.3,
                            release=0.6),
            5: mod.SynthDef(wave="wavetable", amplitude=0.3,
                            table=(0.0, 1.0, 0.5, -1.0)),
            7: mod.SynthDef(wave="triangle", amplitude=0.3, fm_frequency=4.0,
                            fm_depth=0.01)}


@pytest.mark.parametrize("seed", range(3))
def test_write_midi_bytes_equal(seed):
    got, want = _write_both(seed)
    assert got == want and len(got) > 1000


#: (seed, SMPTE division or None, notes, seconds): the tests' 90-note
#: files under three timings, and the benchmark's 3000-note, 180 s files
_PARSE_CASES = [pytest.param(seed, smpte, 90, 8.0, id=f"{seed}-{name}")
                for seed in range(2)
                for smpte, name in ((None, "ppq"), ((25, 40), "smpte25"),
                                    ((29, 100), "smpte2997"))] + \
    [pytest.param(seed, None, 3000, 180.0, id=f"{seed}-gm3000")
     for seed in range(2)]


@pytest.mark.parametrize("seed, smpte, nnotes, duration", _PARSE_CASES)
def test_parse_midi_notes_equal(seed, smpte, nnotes, duration):
    data = bench_song.gm_file(nnotes, duration, seed)
    if smpte:
        data = _smpte(data, *smpte)
    for grace in (TM.release_grace_for(None), 2.0, 0.5):
        got = TM.parse_midi(data, release_grace=grace)
        want = JM.parse_midi(data, release_grace=grace)
        assert [tuple(n) for n in got] == [tuple(n) for n in want]
    kinds = {"bend": any(n.bend_curve for n in got),
             "gain": any(n.gain_curve for n in got),
             "mod": any(n.mod_curve for n in got),
             "drums": any(n.channel == 9 for n in got),
             "pan": any(n.pan is not None for n in got)}
    assert all(kinds.values()), kinds
    assert len(got) > nnotes * 0.9


def _vlq(value: int) -> bytes:
    out = [value & 0x7F]
    while value > 0x7F:
        value >>= 7
        out.append(0x80 | (value & 0x7F))
    return bytes(reversed(out))


def _smf(tracks, division=96) -> bytes:
    """A format-1 SMF of ``tracks``, each a list of (tick, message bytes)
    in tick order, ended by an end-of-track meta event."""
    out = b"MThd" + struct.pack(">IHHH", 6, 1, len(tracks), division)
    for events in tracks:
        body, last = b"", 0
        for tick, msg in events:
            body += _vlq(tick - last) + msg
            last = tick
        body += b"\x00\xff\x2f\x00"
        out += b"MTrk" + struct.pack(">I", len(body)) + body
    return out


def _on(ch, note, vel=100):
    return bytes([0x90 | ch, note, vel])


def _off(ch, note):
    return bytes([0x80 | ch, note, 64])


def _cc(ch, number, value):
    return bytes([0xB0 | ch, number, value])


def _bend(ch, value):
    value += 8192
    return bytes([0xE0 | ch, value & 0x7F, value >> 7])


def _tempo(us_per_quarter):
    return b"\xff\x51\x03" + us_per_quarter.to_bytes(3, "big")


#: a format-1 file of the orderings the note assembly must keep: notes,
#: controllers and bends in the first track; tempo changes on the same
#: ticks, and note-offs that share ticks with the first track's, in the
#: second; chords whose notes start together and close in other orders; a
#: pedal held across a retrigger; CC123 while the pedal is down; bends and
#: pressure on open, held and ringing notes; and notes still ringing, or
#: held by the pedal, when the file ends
_ORDERINGS = _smf([
    [(0, _cc(0, 7, 100)), (0, _bend(0, 0)),
     # the chord starts on a tempo change's tick, with CC11 and a bend
     (96, _on(0, 60)), (96, _on(0, 64)), (96, _on(0, 67)),
     (96, _cc(0, 11, 90)), (96, _bend(0, 2000)),
     (150, bytes([0xD0, 50])), (160, bytes([0xA0, 64, 70])),
     # it closes top, bottom (second track), middle; bends reach the tails
     (192, _off(0, 67)), (192, _bend(0, -3000)),
     # the pedal holds 72 across its retrigger, then CC123 ends it all
     (200, _off(0, 64)), (200, _cc(1, 64, 127)), (200, _on(1, 72)),
     (204, _bend(0, 0)), (204, _cc(0, 1, 80)), (210, _on(1, 76)),
     (240, _off(1, 72)), (250, _bend(1, 4000)), (260, _on(1, 72)),
     (280, _off(1, 72)), (285, _off(1, 76)), (288, _cc(1, 11, 40)),
     (300, _cc(1, 123, 0)), (310, _bend(1, -4000)),
     # a chord on the last tempo change, ringing past the end of the
     # file, and a chord still held by the pedal there
     (400, _on(0, 48)), (400, _on(0, 52)), (400, _on(0, 55)),
     (400, _cc(2, 64, 100)), (400, _on(2, 62)), (400, _on(2, 60)),
     (400, _on(2, 61)), (420, _off(0, 48)), (430, _off(0, 55)),
     (440, _off(2, 62)), (440, _off(0, 52)), (445, _off(2, 60)),
     (450, _bend(0, 6000)), (455, _cc(0, 7, 64))],
    [(0, _tempo(500_000)), (96, _tempo(400_000)), (192, _off(0, 60)),
     (288, _tempo(600_000)), (400, _tempo(300_000)), (440, _off(2, 61))],
])


def test_parse_midi_keeps_the_reference_orderings():
    for grace in (2.0, 0.5, 0.01):
        got = TM.parse_midi(_ORDERINGS, release_grace=grace)
        want = JM.parse_midi(_ORDERINGS, release_grace=grace)
        assert [tuple(n) for n in got] == [tuple(n) for n in want]
    got = TM.parse_midi(_ORDERINGS, release_grace=2.0)
    # notes that start together keep the order in which they closed
    chords = {}
    for n in got:
        chords.setdefault((n.start, n.channel), []).append(n.note)
    assert [v for v in chords.values() if len(v) == 3] == \
        [[67, 60, 64], [48, 55, 52], [62, 61, 60]]
    # the retrigger closed the held 72, and CC123 the rest of channel 1
    assert sorted(n.note for n in got if n.channel == 1) == [72, 72, 76]
    # the last chord's release tails took the bend after their offs
    tails = [n for n in got if n.channel == 0 and n.note in (48, 52, 55)]
    assert all(n.bend_curve and n.bend_curve[-1][0] > n.duration
               for n in tails)


def _error(parse, data):
    try:
        parse(data)
    except Exception as e:                     # noqa: BLE001 - the class
        return type(e)
    return None


def test_parse_rejects_what_the_reference_rejects():
    data, _ = _write_both(0)
    for bad in (b"RIFF" + data[4:], data[:12] + bytes([0xE6, 40]) + data[14:],
                data[:14] + b"MTrX" + data[18:]):
        with pytest.raises(ValueError):
            JM.parse_midi(bad)
        with pytest.raises(ValueError):
            TM.parse_midi(bad)
    # a file cut inside a note-on, and one inside a delta time's VLQ
    whole = _smf([[(0, _on(0, 60)), (300, _off(0, 60))]])
    cuts = {"mid-event": whole.index(_on(0, 60)) + 2,
            "mid-vlq": whole.index(_off(0, 60)) - 1}
    assert whole[cuts["mid-vlq"] - 1] & 0x80
    for name, cut in cuts.items():
        want = _error(JM.parse_midi, whole[:cut])
        assert want is not None, name
        assert _error(TM.parse_midi, whole[:cut]) is want, name


@pytest.mark.parametrize("instruments", [False, True],
                         ids=["gm", "instruments"])
@pytest.mark.parametrize("seed", range(2))
def test_midi_to_voices_equal(seed, instruments):
    data, _ = _write_both(seed)
    notes = TM.parse_midi(data)
    got = TM.midi_to_voices(notes, _instruments(TM) if instruments else None)
    want = JM.midi_to_voices(_to_jax_notes(notes),
                             _instruments(JM) if instruments else None)
    assert [dataclasses.asdict(v) for v in got] == \
        [dataclasses.asdict(v) for v in want]
    assert any(v.pitch_curve for v in got) and any(v.amp_curve for v in got)
    assert any(v.fm_depth_curve for v in got)


def test_gm_tables_and_grace_equal():
    assert TM.release_grace_for(None) == JM.release_grace_for(None)
    assert TM.release_grace_for(_instruments(TM)) == \
        JM.release_grace_for(_instruments(JM))
    assert [dataclasses.asdict(sd) for _, sd in TM._GM_FAMILIES] == \
        [dataclasses.asdict(sd) for _, sd in JM._GM_FAMILIES]
    assert dataclasses.asdict(TSynthDef()) == dataclasses.asdict(JSynthDef())
    for note in (0, 60, 69, 127):
        assert TM.note_to_freq(note) == JM.note_to_freq(note)


@pytest.fixture(scope="module")
def gm_notes():
    data, _ = _write_both(3, nnotes=50, duration=14.0)
    return TM.parse_midi(data, release_grace=TM.release_grace_for(None))


@pytest.mark.parametrize("sparse", [True, False], ids=["sparse", "flat"])
def test_render_notes_matches_reference(gm_notes, sparse, monkeypatch):
    calls = []
    orig = T.VoiceBank._render_rows

    def spy(self, *a, **k):
        calls.append(a)
        return orig(self, *a, **k)

    monkeypatch.setattr(T.VoiceBank, "_render_rows", spy)
    smp = TM.render_notes(gm_notes, sparse=sparse, device="cpu")
    assert bool(calls) == sparse                    # the route taken
    ref = JM.render_notes(_to_jax_notes(gm_notes), sparse=sparse)
    want = ref.get_frame_array()
    # a Sample, as the reference returns, with the same metadata
    assert isinstance(smp, Sample)
    assert (smp.name, smp.samplerate, smp.samplewidth, smp.nchannels,
            smp.nframes) == (ref.name, ref.samplerate, ref.samplewidth,
                             ref.nchannels, ref.nframes)
    got = smp.torch_frames
    assert got.dtype == torch.int16 and got.device.type == "cpu"
    assert tuple(got.shape) == want.shape
    d = np.abs(got.numpy().astype(np.int32) - want.astype(np.int32))
    assert d.max() <= 1, d.max()
    assert np.abs(want).max() > 1000


def test_render_midi_bytes_and_routes(tmp_path):
    notes = [TM.MidiNote(0.4 * i, 0.2, 60 + (i % 12), 100, 0)
             for i in range(24)]
    data = TM.write_midi(notes)
    path = tmp_path / "t.mid"
    path.write_bytes(data)
    inst = {0: TSynthDef(wave="sine", amplitude=0.3)}
    a = TM.render_midi(str(path), inst, device="cpu")
    b = TM.render_midi(data, inst, device="cpu")
    assert isinstance(a, Sample) and a == b
    assert a.torch_frames.abs().max() > 1000
    want = JM.render_midi(data, {0: JSynthDef(wave="sine", amplitude=0.3)})
    d = np.abs(a.get_frame_array().astype(np.int32)
               - want.get_frame_array().astype(np.int32))
    assert d.max() <= 1
    # the Sample wraps the bank's int16 tensor unchanged: the flat route by
    # hand gives the same frames, and so does the sparse one
    parsed = TM.parse_midi(data, release_grace=TM.release_grace_for(inst))
    voices = TM.midi_to_voices(parsed, inst)
    total = TM.song_frames(voices, a.samplerate)
    vp, layout = T.pack_voices(voices, a.samplerate, num_harmonics=8,
                               sort_by_wave=True, device="cpu")
    bank = T.VoiceBank.for_voices(voices, a.samplerate, num_harmonics=8,
                                  layout=layout, nvoices=layout.nvoices,
                                  device="cpu")
    tensor = bank.to_int16(bank.render_song(vp, total))
    flat = TM.render_midi(data, inst, sparse=False, device="cpu")
    assert torch.equal(flat.torch_frames, tensor)
    assert torch.equal(a.torch_frames, tensor)
    # and it goes out as a WAV through the Sample
    out = tmp_path / "t.wav"
    a.write_wav(str(out))
    assert Sample(str(out), device="cpu") == a


def test_empty_mesh_and_device():
    empty = TM.render_notes([], device="cpu")
    assert isinstance(empty, Sample)
    assert (empty.nframes, empty.nchannels, empty.samplewidth) == (0, 2, 2)
    assert empty.torch_frames.dtype == torch.int16
    # mesh= shards the voices (parallel.mesh): within 1 LSB of the
    # single-device render, on the device asked for
    from synthesizer_tpu_torch.parallel.mesh import voice_mesh
    mesh = voice_mesh(2, devices=[torch.device("cpu")] * 2)
    notes = [TM.MidiNote(0.0, 0.2, 60, 100, 0),
             TM.MidiNote(0.1, 0.2, 64, 90, 1)]
    assert TM.render_notes([], mesh=mesh, device="cpu").nframes == 0
    single = TM.render_notes(notes, device="cpu").get_frame_array()
    for got in (TM.render_notes(notes, mesh=mesh, device="cpu"),
                TM.render_midi(TM.write_midi(notes), mesh=mesh,
                               device="cpu")):
        assert isinstance(got, Sample) and got.device.type == "cpu"
        a = got.get_frame_array().astype(np.int64)
        assert a.shape == single.shape and np.abs(single).max() > 1000
        assert np.abs(a - single).max() <= 1


def test_render_entry_points_default_to_the_card(monkeypatch):
    import inspect
    for fn in (TM.render_notes, TM.render_midi):
        assert inspect.signature(fn).parameters["device"].default == "cuda"
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        TM.render_notes([TM.MidiNote(0.0, 0.2, 60, 100, 0)])
