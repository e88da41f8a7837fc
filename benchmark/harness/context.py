"""What one run carries between the harness, its driver and the metric
readers: the cell, the seed, the spans and counters of the window, the
traced sub-window, the numbers compared for ``correct``."""

from __future__ import annotations

import contextlib
import time
from dataclasses import dataclass, field
from typing import Optional

from .trace import SPAN_PREFIX, Tracer

#: seconds of the measured window that a ``--trace 1`` run profiles
TRACE_SECONDS = 4.0


@dataclass
class Check:
    """One number compared for ``correct``, with its limit: it passes when
    ``value <= limit``."""
    name: str
    value: float
    limit: float

    @property
    def ok(self) -> bool:
        return self.value <= self.limit


@dataclass
class Run:
    cell: dict
    config: dict
    seed: int
    seconds: float
    trace: bool
    root: str
    t_process: float
    tmpdir: str = ""
    #: end-to-end metric name -> value, filled by the driver
    results: dict = field(default_factory=dict)
    attempted: int = 0
    failed: int = 0
    checks: list = field(default_factory=list)
    #: span name -> [seconds] inside the measured window
    spans: dict = field(default_factory=dict)
    #: counter name -> value over the measured window
    counters: dict = field(default_factory=dict)
    #: numbers a driver hands to the metric readers (such as the kernels'
    #: bound over the traced jobs)
    extra: dict = field(default_factory=dict)
    setup_s: Optional[float] = None
    in_window: bool = False
    tracer: Tracer = None

    def __post_init__(self):
        self.tracer = Tracer(self.trace, min(TRACE_SECONDS, self.seconds))

    @property
    def params(self) -> dict:
        return self.cell["traffic"]

    @contextlib.contextmanager
    def span(self, name: str):
        """A host span around one call into a layer, kept when it lies in
        the measured window outside the profiled sub-window (the profiler
        slows the host); while the profiler runs it is a range of the
        trace instead."""
        rf = None
        traced = self.tracer.active
        if traced:
            from torch.profiler import record_function
            rf = record_function(SPAN_PREFIX + name)
            rf.__enter__()
        t0 = time.perf_counter()
        try:
            yield
        finally:
            dt = time.perf_counter() - t0
            if rf is not None:
                rf.__exit__(None, None, None)
            if self.in_window and not traced:
                self.spans.setdefault(name, []).append(dt)

    def window_started(self) -> float:
        """Marks the end of set-up and the start of the measured window."""
        now = time.perf_counter()
        self.setup_s = now - self.t_process
        self.in_window = True
        return now

    def window_ended(self) -> float:
        """Marks the end of the measured window; reads the trace."""
        t = time.perf_counter()
        self.in_window = False
        self.tracer.finish()
        return t

    def check(self, name: str, value: float, limit: float) -> None:
        self.checks.append(Check(name, float(value), float(limit)))
