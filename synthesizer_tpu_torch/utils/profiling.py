"""Render profiling & observability (port of
``synthesizer_tpu.utils.profiling``).

The realtime factor is a first-class counter: wrap any render path in a
:class:`RenderTimer` to accumulate audio-seconds vs wall-seconds.
:func:`trace` captures a ``torch.profiler`` trace (host and, on the card,
CUDA activity) as a Chrome trace file, and :func:`count_program_launches`
counts the launches of the port's hand-written kernels
(``ops.kernels.voice_setup`` and ``render_stereo``) inside a block.
"""

from __future__ import annotations

import contextlib
import dataclasses
import logging
import os
import tempfile
import time
from typing import Iterator, Optional

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


def _kernel_launches() -> int:
    from ..ops import kernels as K
    return K.voice_setup.launches + K.render_stereo.launches


@contextlib.contextmanager
def count_program_launches() -> Iterator[list]:
    """Yield a single-element list whose [0] is the number of hand-written
    kernels the port launched inside the block."""
    start = _kernel_launches()
    out = [0]
    try:
        yield out
    finally:
        out[0] = _kernel_launches() - start


@contextlib.contextmanager
def trace(logdir: Optional[str] = None) -> Iterator[None]:
    """Capture a torch.profiler trace around a render; it is written as
    ``trace.json`` (Chrome trace format) under ``logdir``, by default a
    directory in the temporary directory."""
    import torch
    logdir = logdir or os.path.join(tempfile.gettempdir(),
                                    "synthesizer_tpu_torch_trace")
    acts = [torch.profiler.ProfilerActivity.CPU]
    if torch.cuda.is_available():
        acts.append(torch.profiler.ProfilerActivity.CUDA)
    with torch.profiler.profile(activities=acts) as prof:
        yield
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
