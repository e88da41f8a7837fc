"""The tracker song (``configs/tracker_song.json``): the repository's
tracker song over a kit made in NumPy from the seed, streamed by
``synthesizer_tpu_torch.sequencer.Song`` and held to
``reference/tracker_song.py``.

In a ``--trace 1`` run the song comes behind a wrapper that switches the
port's span log on for the chunks of the measured window outside the
profiled sub-window (the per-layer metrics read the log), and off
elsewhere, so that no span of the port reaches the profiler's trace.
"""

from __future__ import annotations

import os

from synthesizer_tpu_torch.utils import profiling

from ..inputs import tracker_song as inputs
from ..reference import tracker_song as ref
from .song import SongKind

#: where the port's span log of a traced run waits for the readers
SPANS = "port_spans"


class TrackerSongKind(SongKind):
    """The song as written, over the tracker kit; streamed only."""

    def __init__(self, run):
        self.run = run
        self.module = inputs
        self.kitdir = inputs.write(inputs.make(run.seed),
                                   os.path.join(run.tmpdir, "kit"))

    def load(self, text: str):
        song = super().load(text)
        return _SpanLog(song, self.run) if self.run.trace else song

    def reference(self, text: str, control: bool = False,
                  stream: bool = False):
        if not stream:
            raise ValueError("the tracker song has a stream cell only")
        return ref.render(text, self.kitdir, control)


class _SpanLog:
    """A song whose ``mix_generator`` switches the port's span log on
    before each chunk of the measured window outside the profiled
    sub-window, and off before every other chunk."""

    def __init__(self, song, run):
        self.song = song
        self.run = run

    def mix_generator(self, *args, **kwargs):
        gen = self.song.mix_generator(*args, **kwargs)
        run = self.run
        try:
            while True:
                profiling.tracing(run.in_window and not run.tracer.active)
                chunk = next(gen, None)
                if chunk is None:
                    return
                yield chunk
        finally:
            profiling.tracing(False)


def port_spans(run) -> list:
    """The port's span log of the run, taken once by whichever reader
    comes first."""
    if SPANS not in run.extra:
        run.extra[SPANS] = profiling.take_spans()
    return run.extra[SPANS]


def ms_per_chunk(run, name: str):
    """The spans ``name`` summed, over the count of ``sequencer.chunk``
    roots, in milliseconds; None where the log has no such span or no
    chunk."""
    spans = port_spans(run)
    chunks = sum(1 for s in spans
                 if s.name == "sequencer.chunk" and s.parent == -1)
    mine = [s.ns for s in spans if s.name == name]
    return sum(mine) / chunks * 1e-6 if mine and chunks else None


#: the constructor the harness calls
make = TrackerSongKind
