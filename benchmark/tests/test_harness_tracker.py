"""The tracker song's stream cell on the CPU, with the look for a card
stubbed: a sound run comes out correct, a fault planted in the port's
swept biquad comes out not correct, and a traced run prints the two
metrics of the port's span log while no span of the port reaches the
profiler's trace."""

import torch

from benchmark.harness import context, trace
from benchmark.inputs import tracker_song as T
from benchmark.kinds import tracker_song as KT
from synthesizer_tpu_torch import effects as E

from .cpu_run import run_cell

METRICS = ("effects.biquad_ms_per_chunk",
           "sequencer.sidechain_key_ms_per_chunk")


def _short(monkeypatch, **kw):
    """The cell over one pattern of the song (with its automation, the
    sidechain and the track chains), so that a pass fits a short window
    on the CPU."""
    monkeypatch.setattr(KT.TrackerSongKind, "text",
                        lambda self, rng=None, k=1: T.with_patterns("a"))
    return run_cell(monkeypatch, "tracker_song.stream", seconds=0.5,
                    cell_edit=lambda c: c["traffic"].update(warm_passes=0),
                    **kw)


def test_sound_run_is_correct(monkeypatch):
    code, line, err = _short(monkeypatch)
    assert code == 0, err
    assert line["correct"], line["checks"]
    assert set(line["metrics"]) == {"render_x_realtime", "chunk_p95_ms",
                                    "setup_s"}


def test_planted_biquad_fault_reads_above_the_limit(monkeypatch):
    """The master lowpass at twice its Q."""
    init = E.SweptStreamingBiquad.__init__

    def resonant(self, *a, **k):
        init(self, *a, **k)
        self.q *= 2.0
    monkeypatch.setattr(E.SweptStreamingBiquad, "__init__", resonant)
    code, line, err = _short(monkeypatch)
    assert code == 0, err
    check = line["checks"]["stream_lsb_gap"]
    assert not line["correct"] and check["value"] > check["limit"], check


def test_trace_reads_the_span_log_and_keeps_it_off_the_profile(monkeypatch):
    names = []
    summarize = trace.summarize

    def seen(events, window_s):
        events = list(events)
        names.extend(ev.name() for ev in events)
        return summarize(events, window_s)
    monkeypatch.setattr(trace, "summarize", seen)
    profile = torch.profiler.profile
    # the CPU's activity alone: this build of PyTorch traces no card
    monkeypatch.setattr(torch.profiler, "profile", lambda activities: profile(
        activities=[torch.profiler.ProfilerActivity.CPU]))
    monkeypatch.setattr(context, "TRACE_SECONDS", 0.1)
    code, line, err = _short(monkeypatch, trace=1)
    assert code == 0, err
    assert line["correct"], line["checks"]
    for m in METRICS:
        assert line["metrics"][m]["value"] > 0, line["metrics"]
    assert names and not [n for n in names if n.startswith("synth.")]
    assert not [op for op, _ in line["breakdown"]["device_ops"]
                if op.startswith("synth.")]
