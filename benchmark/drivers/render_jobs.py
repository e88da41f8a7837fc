"""Offline render jobs from one renderer in a closed loop: each job starts
when the last one has its int16 frames on the host.

The configuration's kind makes the jobs from the seed (``kind.job``); a
kind has ``kind.shapes`` distinct job shapes (song lengths, files), of
which set-up renders the first ``kind.warm_shapes`` ``warm_calls`` times
each (the traffic parameter), so that every device program has reached
replay before the window.

End-to-end: ``render_x_realtime``, the audio seconds of the jobs completed
over the wall seconds from the window's start to the last completion.
"""

from __future__ import annotations

import time

import numpy as np

from benchmark.harness import stats
from benchmark.kinds.song import gap
from synthesizer_tpu_torch.utils import program as programs

SR = 44100


def captures() -> int:
    """CUDA-graph captures so far, summed over the program cache."""
    return sum(p.captures for p in list(programs._PROGRAMS.values()))


def run(run, kind) -> None:
    for j in range(run.params["warm_calls"] * kind.warm_shapes):
        kind.render(kind.job(1, j))
    # the jobs whose frames the check compares: the first of each length
    # where the kind asks for them, and one more drawn from the seed
    s = run.seed
    drawn = np.random.default_rng([s & 0xFFFFFFFF, s >> 32, 3])
    keep = set(range(kind.keep_first))
    keep.add(int(drawn.integers(kind.keep_first,
                                kind.keep_first + 2 * kind.shapes)))
    kept, lengths, traced = {}, {}, []
    audio = 0.0
    c0 = captures()
    if run.trace:
        run.tracer.begin()
    t0 = run.window_started()
    deadline = t0 + run.seconds
    j = 0
    while True:
        job = kind.job(2, j)
        out = kind.render(job)
        t_end = time.perf_counter()
        run.attempted += 1
        if run.tracer.active:
            traced.append((job, len(out)))
            if run.tracer.due():
                run.tracer.end()
        # a job of one shape always has one length
        if lengths.setdefault(j % kind.shapes, len(out)) != len(out):
            run.failed += 1
        if j in keep:
            kept[j] = (job, out)
        last = (job, out)
        audio += len(out) / SR
        j += 1
        if t_end >= deadline:
            break
    run.window_ended()
    if len(kept) < len(keep):
        # a short window ended before a job the check drew: it compares
        # the window's last job in its place
        kept[j - 1] = last
    run.counters["program.captures"] = captures() - c0
    run.results["render_x_realtime"] = stats.rate(audio, t0, t_end)
    run.extra["kept"] = kept
    kind.after_window()
    if traced:
        # the kernels' bound over the traced jobs, worked out after the
        # window from the reference's voice lists
        run.extra["render_bound_s"] = sum(kind.bound(jb, n)
                                          for jb, n in traced)


def check(run, kind) -> None:
    worst = 0.0
    for job, out in run.extra.pop("kept").values():
        worst = max(worst, gap(out, kind.reference(job)))
    run.check("render_lsb_gap", worst, run.cell["limits"]["render_lsb_gap"])
