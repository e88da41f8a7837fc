"""The profiler's view of a traced window: device time by operation, the
busy share, and the idle gaps labelled by the host span that was open.

The profiler runs only in a ``--trace 1`` run, over a sub-window that
starts and ends between jobs or chunks; nothing is written to disk.
"""

from __future__ import annotations

import time
from dataclasses import dataclass, field

#: the prefix of the benchmark's own spans in the profiler's trace
SPAN_PREFIX = "bench."


@dataclass
class TraceSummary:
    window_s: float
    busy_s: float
    #: operation name -> (seconds on the device, launches)
    device_ops: dict = field(default_factory=dict)
    #: [(label, seconds)] of the idle gaps, longest first
    idle_gaps: list = field(default_factory=list)

    def kernel_seconds(self, *names: str) -> float:
        """Device seconds of the operations whose name contains any of
        ``names``."""
        return sum(s for op, (s, _) in self.device_ops.items()
                   if any(n in op for n in names))

    def breakdown(self, top: int = 10) -> dict:
        ops = sorted(self.device_ops.items(), key=lambda kv: -kv[1][0])
        return {"device_ops": [[n[:160], s] for n, (s, _) in ops[:top]],
                "idle_gaps": [[lab, s] for lab, s in self.idle_gaps[:top]]}


def _ns(ev, which: str) -> int:
    """An event's start or duration in nanoseconds, on either API."""
    if hasattr(ev, which + "_ns"):
        return int(getattr(ev, which + "_ns")())
    return int(getattr(ev, which + "_us")() * 1000)


def summarize(events, window_s: float) -> TraceSummary:
    """Kineto events of one window -> TraceSummary."""
    from torch.autograd import DeviceType
    dev, spans, ops = [], [], {}
    for ev in events:
        start, dur = _ns(ev, "start"), _ns(ev, "duration")
        if ev.name().startswith(SPAN_PREFIX):
            # the benchmark's own spans (the profiler shows them on the
            # device's timeline too): host context, never device work
            if ev.device_type() != DeviceType.CUDA:
                spans.append((start, start + dur,
                              ev.name()[len(SPAN_PREFIX):]))
        elif ev.device_type() == DeviceType.CUDA:
            dev.append((start, start + dur))
            s, c = ops.get(ev.name(), (0.0, 0))
            ops[ev.name()] = (s + dur * 1e-9, c + 1)
    dev.sort()
    busy, gaps = 0, []
    cur_s = cur_e = None
    for s, e in dev:
        if cur_e is None:
            cur_s, cur_e = s, e
        elif s > cur_e:
            busy += cur_e - cur_s
            gaps.append((cur_e, s))
            cur_s, cur_e = s, e
        else:
            cur_e = max(cur_e, e)
    if cur_e is not None:
        busy += cur_e - cur_s
    labelled = []
    for g0, g1 in gaps:
        mid = (g0 + g1) // 2
        open_ = [(e - s, name) for s, e, name in spans if s <= mid <= e]
        labelled.append((min(open_)[1] if open_ else "host",
                         (g1 - g0) * 1e-9))
    labelled.sort(key=lambda x: -x[1])
    return TraceSummary(window_s=window_s, busy_s=busy * 1e-9,
                        device_ops=ops, idle_gaps=labelled)


class Tracer:
    """Starts and stops the profiler around a sub-window at the start of
    the measured window, in a ``--trace 1`` run only; the trace is read
    once the window has closed."""

    def __init__(self, enabled: bool, seconds: float):
        self.enabled = enabled
        self.seconds = seconds
        self._prof = None
        self._stopped = None
        self._t0 = None
        self._window = None
        self.summary = None

    @property
    def active(self) -> bool:
        return self._prof is not None

    def begin(self) -> None:
        if not self.enabled or self._stopped is not None or self.active:
            return
        import torch
        from torch.profiler import ProfilerActivity, profile
        torch.cuda.synchronize()
        self._prof = profile(activities=[ProfilerActivity.CPU,
                                         ProfilerActivity.CUDA])
        self._prof.__enter__()
        self._t0 = time.perf_counter()

    def due(self) -> bool:
        """Whether the traced sub-window has lasted long enough."""
        return self.active and time.perf_counter() - self._t0 >= self.seconds

    def end(self) -> None:
        """Stops the profiler (the rest of the window runs untraced)."""
        if not self.active:
            return
        import torch
        torch.cuda.synchronize()
        self._window = time.perf_counter() - self._t0
        self._prof.__exit__(None, None, None)
        self._stopped, self._prof = self._prof, None

    def finish(self) -> None:
        """Reads the trace, after the window."""
        self.end()
        if self._stopped is not None and self.summary is None:
            self.summary = summarize(
                self._stopped.profiler.kineto_results.events(), self._window)
            self._stopped = None
