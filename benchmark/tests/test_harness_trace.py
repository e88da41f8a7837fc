"""The reduction of a trace to busy time, device operations and idle
gaps, on synthetic events."""

from types import SimpleNamespace

import pytest
from torch.autograd import DeviceType

from benchmark.harness.trace import summarize


def _ev(name, start_us, dur_us, dev):
    return SimpleNamespace(name=lambda: name, device_type=lambda: dev,
                           start_ns=lambda: int(start_us * 1000),
                           duration_ns=lambda: int(dur_us * 1000))


def test_busy_gaps_and_labels():
    G, C = DeviceType.CUDA, DeviceType.CPU
    evs = [_ev("render_kernel<true>", 0, 100, G),
           _ev("copy", 50, 100, G),           # overlaps: busy 0-150
           _ev("bench.sequencer.mix", 140, 1000, C),
           _ev("bench.sequencer.mix", 140, 1000, G),  # an annotation
           _ev("bench.sample.to_host", 400, 100, C),
           _ev("render_kernel<true>", 450, 10, G),   # gap 150-450
           _ev("setup_kernel", 2000, 30, G)]         # gap 460-2000
    s = summarize(evs, window_s=0.003)
    assert s.busy_s == pytest.approx((150 + 10 + 30) * 1e-6)
    assert s.idle_gaps[0] == ("host", pytest.approx(1540e-6))
    assert s.idle_gaps[1] == ("sequencer.mix", pytest.approx(300e-6))
    assert s.kernel_seconds("render_kernel") == pytest.approx(110e-6)
    b = s.breakdown()
    assert b["device_ops"][0][0] == "render_kernel<true>"
    assert len(b["idle_gaps"]) == 2
