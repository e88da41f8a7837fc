"""The voice-bank render kernels' share of their bound: the bound of the
traced jobs (``benchmark.harness.roofline``, counted from the reference's
voices) over the profiler's device time of ``setup_kernel``,
``render_kernel`` and ``span_kernel`` in the traced sub-window, in %."""

KERNELS = ("setup_kernel", "render_kernel", "span_kernel")


def read(run):
    summary = run.tracer.summary
    bound = run.extra.get("render_bound_s")
    if summary is None or not bound:
        return None
    t = summary.kernel_seconds(*KERNELS)
    return 100.0 * bound / t if t > 0 else None
