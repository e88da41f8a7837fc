"""The share of the traced sub-window in which no operation ran on the
device (the profiler's device activity), in %."""


def read(run):
    s = run.tracer.summary
    if s is None or s.window_s <= 0:
        return None
    return 100.0 * (1.0 - s.busy_s / s.window_s)
