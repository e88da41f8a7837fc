"""Render profiling & observability (port of
``synthesizer_tpu.utils.profiling``).

The realtime factor is a first-class counter: wrap any render path in a
:class:`RenderTimer` to accumulate audio-seconds vs wall-seconds.
:func:`trace` captures a ``torch.profiler`` trace (host and, on the card,
CUDA activity) as a Chrome trace file, and :func:`count_program_launches`
counts, inside a block, the launches of the port's hand-written kernels
(``ops.kernels.voice_setup`` and ``render_stereo``) and the device
programs it called (``utils.program.Program``: an eager first call, a
capture or a replay each, as :func:`record_program_launch` counts them).

:func:`span` marks where the port's host time goes: ``with
span("sequencer.chunk"):`` inside a function, or :func:`spanned` around
a whole one, at each layer boundary (the MIDI front, the
packing, ``Song.mix`` and the stream step, the fx chains and their
biquad processors (``effects.biquad``), a streamed sidechain key
(``sequencer.sidechain_key``), the device programs and the two places
the host waits for the card, ``program.wait`` and ``device.wait``).
Spans are off by default, and then cost one check of a module flag.
After :func:`tracing` ``(True)`` each span is kept in memory as a
:class:`Span` (name, start and end on ``time.perf_counter_ns``, its
parent, its root) until :func:`take_spans` hands the log over;
:func:`self_ns` gives each span's self time.  While a ``torch.profiler``
profile runs, a span keeps nothing in the log and opens a
``record_function`` range ``"synth." + name`` instead, on the clock of
the device events around it (the profiler slows the host, so the log
and the trace never hold the same interval).
"""

from __future__ import annotations

import contextlib
import dataclasses
import functools
import itertools
import logging
import os
import tempfile
import threading
import time
from typing import Iterator, List, NamedTuple, Optional

import torch

log = logging.getLogger("synthesizer_tpu")


@dataclasses.dataclass
class RenderStats:
    chunks: int = 0
    audio_seconds: float = 0.0
    wall_seconds: float = 0.0
    peak_wall_chunk: float = 0.0

    @property
    def realtime_factor(self) -> float:
        return self.audio_seconds / self.wall_seconds if self.wall_seconds else 0.0

    def __str__(self) -> str:
        return (f"{self.chunks} chunks, {self.audio_seconds:.2f}s audio in "
                f"{self.wall_seconds:.3f}s wall -> {self.realtime_factor:.0f}x "
                f"realtime (worst chunk {self.peak_wall_chunk*1e3:.2f} ms)")


class RenderTimer:
    """Accumulates per-chunk render timings and the realtime factor.

    >>> timer = RenderTimer(samplerate=44100)
    >>> with timer.chunk(1470):
    ...     render_one_chunk()
    >>> timer.stats.realtime_factor
    """

    def __init__(self, samplerate: int):
        self.samplerate = samplerate
        self.stats = RenderStats()

    @contextlib.contextmanager
    def chunk(self, nframes: int) -> Iterator[None]:
        t0 = time.perf_counter()
        yield
        dt = time.perf_counter() - t0
        self.stats.chunks += 1
        self.stats.audio_seconds += nframes / self.samplerate
        self.stats.wall_seconds += dt
        self.stats.peak_wall_chunk = max(self.stats.peak_wall_chunk, dt)

    def reset(self) -> None:
        self.stats = RenderStats()

    def log_summary(self, level: int = logging.INFO) -> None:
        log.log(level, "render: %s", self.stats)


#: device-program launch counter: one per top-level call of a
#: ``utils.program.Program`` (a ``Sample`` chain's materialisation, a patch
#: render, a voice block, a processor's chunk), so tests can hold fusion
#: claims ("this chain is ONE device program") as the JAX package's do.
program_launches = 0


def record_program_launch() -> None:
    global program_launches
    program_launches += 1


def _launches() -> int:
    from ..ops import kernels as K
    return (K.voice_setup.launches + K.render_stereo.launches
            + program_launches)


@contextlib.contextmanager
def count_program_launches() -> Iterator[list]:
    """Yield a single-element list whose [0] is the number of hand-written
    kernels and device programs the port launched inside the block."""
    start = _launches()
    out = [0]
    try:
        yield out
    finally:
        out[0] = _launches() - start


#: the prefix of the port's spans as ``torch.profiler`` ranges
RANGE_PREFIX = "synth."


class Span(NamedTuple):
    """One closed span of the log.  ``parent`` is the id of the span that
    was open around it on its thread (-1 for a root); ``root`` the id of
    the outermost one, its own for a root: every span under one ``mix()``,
    one MIDI job or one streamed chunk shares it."""
    name: str
    start_ns: int
    end_ns: int
    id: int
    parent: int
    root: int

    @property
    def ns(self) -> int:
        return self.end_ns - self.start_ns


_tracing = False
_NULL = contextlib.nullcontext()
#: closed spans, in the order they closed, as plain tuples (the garbage
#: collector stops tracking those, so a long log costs it nothing)
_LOG: List[tuple] = []
_IDS = itertools.count()
#: the spans open on each thread, innermost last
_open = threading.local()
_profiling = torch._C._autograd._profiler_enabled


def _stack() -> list:
    s = getattr(_open, "stack", None)
    if s is None:
        s = _open.stack = []
    return s


class _Open:
    """A span while it is open, with tracing on."""

    __slots__ = ("name", "id", "parent", "root", "t0", "range")

    def __init__(self, name: str):
        self.name = name

    def __enter__(self):
        if _profiling():
            self.range = torch.profiler.record_function(RANGE_PREFIX
                                                        + self.name)
            self.range.__enter__()
            return self
        self.range = None
        stack = _stack()
        self.id = next(_IDS)
        if stack:
            self.parent, self.root = stack[-1].id, stack[-1].root
        else:
            self.parent, self.root = -1, self.id
        stack.append(self)
        self.t0 = time.perf_counter_ns()
        return self

    def __exit__(self, *exc):
        if self.range is not None:
            self.range.__exit__(*exc)
            return False
        t1 = time.perf_counter_ns()
        _stack().pop()
        _LOG.append((self.name, self.t0, t1, self.id, self.parent,
                     self.root))
        return False


def span(name: str):
    """A context manager around one call into a layer.  Off (the default)
    it is one shared null context: no clock reading, no allocation.  On,
    the span is logged when it closes, or is a profiler range while a
    profile runs.  A span closes before its generator yields."""
    if not _tracing:
        return _NULL
    return _Open(name)


def spanned(name: str):
    """A decorator: the whole call is one span ``name``.  Off, the wrapper
    checks the flag and calls through: no clock reading, no span object."""
    def wrap(fn):
        @functools.wraps(fn)
        def call(*args, **kwargs):
            if not _tracing:
                return fn(*args, **kwargs)
            with _Open(name):
                return fn(*args, **kwargs)
        return call
    return wrap


def tracing(on: bool = True) -> bool:
    """Switch the spans on (or off); returns the previous setting."""
    global _tracing
    was, _tracing = _tracing, bool(on)
    return was


def take_spans() -> List[Span]:
    """The spans closed since the last call, in the order they closed;
    the log is cleared."""
    n = len(_LOG)
    out = [Span._make(t) for t in _LOG[:n]]
    del _LOG[:n]
    return out


def self_ns(spans) -> dict:
    """Each span's self time by id: its duration less its children's (on
    one thread children nest inside their parent, one after another)."""
    own = {s.id: s.ns for s in spans}
    for s in spans:
        if s.parent in own:
            own[s.parent] -= s.ns
    return own


@contextlib.contextmanager
def trace(logdir: Optional[str] = None) -> Iterator[None]:
    """Capture a torch.profiler trace around a render, the port's spans
    included as ``synth.`` ranges; it is written as ``trace.json``
    (Chrome trace format) under ``logdir``, by default a directory in the
    temporary directory."""
    logdir = logdir or os.path.join(tempfile.gettempdir(),
                                    "synthesizer_tpu_torch_trace")
    acts = [torch.profiler.ProfilerActivity.CPU]
    if torch.cuda.is_available():
        acts.append(torch.profiler.ProfilerActivity.CUDA)
    was = tracing(True)
    try:
        with torch.profiler.profile(activities=acts) as prof:
            yield
    finally:
        tracing(was)
    os.makedirs(logdir, exist_ok=True)
    prof.export_chrome_trace(os.path.join(logdir, "trace.json"))
    log.info("profiler trace written to %s", logdir)


def timed_stream(chunks, samplerate: int, timer: Optional[RenderTimer] = None):
    """Wrap a Sample-chunk iterator so every pull is timed."""
    timer = timer or RenderTimer(samplerate)

    def gen():
        for c in chunks:
            t0 = time.perf_counter()
            yield c
            dt = time.perf_counter() - t0
            timer.stats.chunks += 1
            timer.stats.audio_seconds += c.nframes / samplerate
            timer.stats.wall_seconds += dt
            timer.stats.peak_wall_chunk = max(timer.stats.peak_wall_chunk, dt)
    return gen(), timer
