"""The port's span log (``synthesizer_tpu_torch.utils.profiling.span``) on
the CPU: off it is one shared null context; on, spans nest with parents,
roots and self time, become ``synth.`` ranges under ``torch.profiler``,
fire at the layer boundaries of a MIDI render, ``Song.mix()`` and the
stream step, never stay open across a ``yield``, and change no frame.
``program.wait``, ``program.capture`` and ``device.wait`` wait on the
card and fire only there."""

import json
import threading
import time

import numpy as np
import pytest
import torch

from synthesizer_tpu_torch import midi as TM
from synthesizer_tpu_torch.sequencer import Song, SynthDef
from synthesizer_tpu_torch.utils import profiling, wavio
from synthesizer_tpu_torch.utils import program as P

torch.set_num_threads(1)

SR = 44100


@pytest.fixture
def spans_on():
    """Tracing on for one test, the log empty before and after."""
    profiling.take_spans()
    was = profiling.tracing(True)
    try:
        yield
    finally:
        profiling.tracing(was)
        profiling.take_spans()


def _names(spans):
    return {s.name for s in spans}


def test_off_is_one_shared_null_context(monkeypatch):
    """Off (the default), ``span`` hands back the one module null context
    and a ``spanned`` function calls straight through: neither makes a
    span object or reads a clock."""
    assert profiling.tracing(False) is False        # off by default

    def made(*a):
        raise AssertionError("a span object was made with tracing off")
    monkeypatch.setattr(profiling, "_Open", made)
    monkeypatch.setattr(time, "perf_counter_ns", made)
    spans = {id(profiling.span(f"s{k}")) for k in range(100)}
    assert spans == {id(profiling._NULL)}
    with profiling.span("a"):
        with profiling.span("b"):
            pass

    @profiling.spanned("c")
    def f(x, y=1):
        return x + y
    assert f(2, y=3) == 5 and f.__name__ == "f"
    assert profiling.take_spans() == []


def test_spanned_wraps_the_whole_call(spans_on):
    @profiling.spanned("outer")
    def f(x):
        with profiling.span("inner"):
            pass
        if x:
            raise ValueError(x)
        return 7

    assert f(0) == 7
    with pytest.raises(ValueError):
        f(1)
    got = profiling.take_spans()
    assert [s.name for s in got] == ["inner", "outer"] * 2
    assert got[0].parent == got[1].id and got[1].parent == -1
    assert profiling._stack() == []         # closed by the exception too


def test_nesting_parents_roots_and_self_time(spans_on):
    with profiling.span("a"):
        with profiling.span("b"):
            with profiling.span("c"):
                time.sleep(0.001)
        with profiling.span("d"):
            pass
    with profiling.span("e"):
        pass
    got = profiling.take_spans()
    assert [s.name for s in got] == ["c", "b", "d", "a", "e"]   # as closed
    s = {x.name: x for x in got}
    assert s["a"].parent == -1 and s["a"].root == s["a"].id
    assert s["b"].parent == s["a"].id and s["d"].parent == s["a"].id
    assert s["c"].parent == s["b"].id
    assert {s[n].root for n in "abcd"} == {s["a"].id}
    assert s["e"].root == s["e"].id != s["a"].id
    for x in got:
        assert x.start_ns <= x.end_ns
    assert s["a"].start_ns <= s["b"].start_ns <= s["c"].start_ns
    assert s["c"].end_ns <= s["b"].end_ns <= s["d"].start_ns
    own = profiling.self_ns(got)
    assert own[s["a"].id] == s["a"].ns - s["b"].ns - s["d"].ns >= 0
    assert own[s["b"].id] == s["b"].ns - s["c"].ns >= 0
    assert own[s["c"].id] == s["c"].ns >= 1_000_000
    assert profiling.take_spans() == []             # the log was cleared


def test_self_time_on_a_synthetic_log():
    """A top-level program call that waited and captured: its self time is
    the host work alone; per root, the waits and the calls add up."""
    S = profiling.Span
    log = [S("program.wait", 10, 40, 1, 0, 0),
           S("program.capture", 50, 60, 2, 0, 0),
           S("program.call", 0, 100, 0, -1, 0),
           S("sequencer.chunk", 200, 400, 3, -1, 3),
           S("program.call", 210, 250, 4, 3, 3),
           S("program.wait", 215, 245, 5, 4, 3),
           S("device.wait", 300, 390, 6, 3, 3)]
    own = profiling.self_ns(log)
    assert own == {0: 60, 1: 30, 2: 10, 3: 200 - 40 - 90, 4: 10, 5: 30,
                   6: 90}
    waits = {}
    for s in log:
        if s.name.endswith(".wait"):
            waits[s.root] = waits.get(s.root, 0) + s.ns
    assert waits == {0: 30, 3: 120}


def test_threads_keep_their_own_roots(spans_on):
    def work():
        with profiling.span("t.outer"):
            with profiling.span("t.inner"):
                pass

    ts = [threading.Thread(target=work) for _ in range(4)]
    with profiling.span("main"):
        for t in ts:
            t.start()
        for t in ts:
            t.join(timeout=10)
    assert not any(t.is_alive() for t in ts)
    got = profiling.take_spans()
    outer = [s for s in got if s.name == "t.outer"]
    inner = [s for s in got if s.name == "t.inner"]
    assert len(outer) == len(inner) == 4
    assert all(s.parent == -1 and s.root == s.id for s in outer)
    assert sorted(s.parent for s in inner) == sorted(s.id for s in outer)


def test_under_the_profiler_spans_are_ranges_and_log_nothing(spans_on):
    with torch.profiler.profile(
            activities=[torch.profiler.ProfilerActivity.CPU]) as prof:
        with profiling.span("outer"):
            with profiling.span("inner"):
                torch.ones(8).add_(1)
    assert profiling.take_spans() == []
    names = [e.name() for e in prof.profiler.kineto_results.events()]
    assert "synth.outer" in names and "synth.inner" in names
    # after the profile the log keeps spans again
    with profiling.span("after"):
        pass
    assert [s.name for s in profiling.take_spans()] == ["after"]


def test_trace_exports_the_spans(tmp_path):
    assert profiling.tracing(False) is False
    with profiling.trace(str(tmp_path)):
        with profiling.span("in_trace"):
            torch.ones(4).mul_(2)
    assert profiling.tracing(False) is False        # restored
    events = json.loads((tmp_path / "trace.json").read_text())["traceEvents"]
    assert any(e.get("name") == "synth.in_trace" for e in events)
    assert profiling.take_spans() == []


def test_totals_sum_the_program_cache():
    prog = P.program("test_totals", (), lambda: (lambda x, f, i: x + 1),
                     "cpu")
    try:
        prog(torch.zeros(2))
        prog.captures, prog.replays, prog.capture_s = 3, 7, 0.5

        def by_hand(k):
            return sum(getattr(p, k) for p in list(P._PROGRAMS.values()))
        for k in ("eager_calls", "captures", "replays", "capture_s"):
            assert P.totals()[k] == by_hand(k)
        before = P.totals()["captures"]
        prog.captures = 0                           # a test resets one
        assert P.totals()["captures"] == before - 3 == by_hand("captures")
    finally:
        P._PROGRAMS.pop(("test_totals", (), torch.device("cpu")), None)


# -- the spans at the port's layer boundaries ------------------------------

#: spans that the CPU paths below must produce (the waits and the capture
#: are the card's)
MIDI_SPANS = {"midi.render_midi", "midi.parse_midi", "midi.render_notes",
              "midi.to_voices", "voicebank.pack_voices",
              "voicebank.for_voices", "voicebank.sparse_plan",
              "voicebank.render", "device.to_host"}
MIX_SPANS = {"sequencer.mix", "sequencer.compile", "sequencer.drums",
             "sequencer.pitched", "sequencer.volume", "voicebank.pack_voices",
             "voicebank.for_voices", "voicebank.render",
             "effects.fx_offline", "program.call"}
STREAM_SPANS = {"sequencer.stream_setup", "sequencer.compile",
                "sequencer.chunk", "sequencer.drums", "sequencer.pitched",
                "sequencer.volume", "voicebank.render", "effects.fx_stream",
                "program.call", "device.to_host"}


def _midi_file() -> bytes:
    # sparse: short notes far apart, so the sparse plan takes the route
    notes = [TM.MidiNote(0.3 * i, 0.05, 60 + (i % 12), 100, 0)
             for i in range(10)]
    return TM.write_midi(notes)


def test_render_midi_spans(spans_on):
    data = _midi_file()
    inst = {0: SynthDef(wave="sine", amplitude=0.3)}
    profiling.tracing(False)
    want = TM.render_midi(data, inst, device="cpu").get_frame_array()
    profiling.tracing(True)
    got = TM.render_midi(data, inst, device="cpu").get_frame_array()
    assert np.array_equal(got, want) and np.abs(want).max() > 1000
    spans = profiling.take_spans()
    assert MIDI_SPANS <= _names(spans), MIDI_SPANS - _names(spans)
    job = next(s for s in spans if s.name == "midi.render_midi")
    assert job.parent == -1
    under = {s.name for s in spans if s.root == job.id}
    assert MIDI_SPANS - {"device.to_host"} <= under
    notes = next(s for s in spans if s.name == "midi.render_notes")
    assert notes.parent == job.id
    for s in spans:
        if s.name in ("voicebank.pack_voices", "voicebank.sparse_plan"):
            assert s.parent == notes.id


def test_pack_voices_child_spans(spans_on):
    """One ``pack_voices`` call: the host columns and then the upload, each
    a child of its span; with tracing off, none of the three is logged."""
    from synthesizer_tpu_torch.models.voicebank import Voice, pack_voices
    voices = [Voice(frequency=220.0 * (k + 1), amplitude=0.1,
                    amp_curve=((0.0, 1.0), (0.1, 0.5))) for k in range(3)]
    pack_voices(voices, SR, device="cpu")
    spans = profiling.take_spans()
    top = [s for s in spans if s.name == "voicebank.pack_voices"]
    assert len(top) == 1 and top[0].parent == -1
    kids = [s for s in spans if s.parent == top[0].id]
    assert [s.name for s in kids] == ["voicebank.pack_columns",
                                      "voicebank.pack_upload"]
    assert top[0].start_ns <= kids[0].start_ns <= kids[0].end_ns \
        <= kids[1].start_ns <= kids[1].end_ns <= top[0].end_ns
    profiling.tracing(False)
    pack_voices(voices, SR, device="cpu")
    assert profiling.take_spans() == []


def _tone(seconds, freq):
    t = np.arange(int(seconds * SR)) / SR
    x = 0.5 * np.sin(2 * np.pi * freq * t) * np.exp(-t * 12.0)
    return np.clip(np.rint(np.stack([x, 0.8 * x], 1) * 32767),
                   -32768, 32767).astype(np.int16)


SONG = """\
[song]
bpm = 240
ticks = 4
patterns = a
[instruments]
kick = kick.wav
[sampler.pad]
file = pad.wav
base_note = C4
[synth.lead]
wave = sine
amplitude = 0.2
[pattern.a]
kick = x... x...
pad  = C3 - - - E3 - - -
lead = C4 .. E4 ..
[fx.lead]
echo = delay=0.01 feedback=0.3 wet=0.2 tail=0.02
[fx]
compress = threshold_db=-12 ratio=3 attack=0.004 release=0.05
[automation]
master.volume = 0:1 8:0.5
"""


@pytest.fixture(scope="module")
def song(tmp_path_factory):
    d = tmp_path_factory.mktemp("tracekit")
    wavio.write_wav(str(d / "kick.wav"), _tone(0.08, 60.0), SR, 2, 2)
    wavio.write_wav(str(d / "pad.wav"), _tone(0.2, 261.6), SR, 2, 2)
    return Song.from_string(SONG, str(d), device="cpu")


def test_mix_spans(song, spans_on):
    profiling.tracing(False)
    want = song.mix().get_frame_array()
    profiling.tracing(True)
    got = song.mix().get_frame_array()
    assert np.array_equal(got, want) and np.abs(want).max() > 1000
    spans = profiling.take_spans()
    assert MIX_SPANS <= _names(spans), MIX_SPANS - _names(spans)
    mix = next(s for s in spans if s.name == "sequencer.mix")
    assert mix.parent == -1
    under = [s for s in spans if s.root == mix.id]
    assert MIX_SPANS <= _names(under)
    # the track chain and the master chain: two offline chains a mix
    assert sum(s.name == "effects.fx_offline" for s in under) == 2
    assert sum(s.name == "sequencer.compile" for s in under) == 1


def _stream(song, n):
    gen = song.mix_generator(chunk_frames=1470)
    out = []
    for _ in range(n):
        chunk = next(gen)
        # the consumer holds a chunk: no span of the port is open
        assert profiling._stack() == []
        out.append(np.array(chunk.get_frame_array()))
    gen.close()
    return out


def test_stream_spans_close_before_each_yield(song, spans_on):
    profiling.tracing(False)
    want = _stream(song, 2)
    profiling.tracing(True)
    got = _stream(song, 2)
    assert all(np.array_equal(a, b) for a, b in zip(got, want))
    assert np.abs(np.concatenate(want)).max() > 1000
    spans = profiling.take_spans()
    assert STREAM_SPANS <= _names(spans), STREAM_SPANS - _names(spans)
    setup = [s for s in spans if s.name == "sequencer.stream_setup"]
    assert len(setup) == 1 and setup[0].parent == -1    # one a pass
    assert {s.parent for s in spans if s.name == "sequencer.compile"} \
        == {s.id for s in setup}
    chunks = [s for s in spans if s.name == "sequencer.chunk"]
    assert len(chunks) == 2 and all(s.parent == -1 for s in chunks)
    for c in chunks:
        under = {s.name for s in spans if s.root == c.id and s is not c}
        assert {"sequencer.drums", "sequencer.pitched", "voicebank.render",
                "effects.fx_stream"} <= under
    # the master volume and chain run after the chunk's span closed: roots
    # of their own, one each a chunk
    for name in ("sequencer.volume", "effects.fx_stream"):
        assert sum(s.name == name and s.parent == -1 for s in spans) == 2
