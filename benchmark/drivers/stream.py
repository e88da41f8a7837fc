"""Realtime playback: one player pulls the song chunk by chunk from
``Song.mix_generator``, asking for the next chunk as soon as it holds the
last one (a player filling its buffer).  A pass is the song as written,
start to end with the master chain's tail; passes repeat for the window.

Traffic parameters: ``chunk_frames``; ``warm_passes``, the passes of
set-up, enough for every chunk shape's programs to reach replay.

End-to-end: ``chunk_p95_ms``, the 95th percentile over every chunk of the
window of the time from asking for it to its int16 frames on the host;
``render_x_realtime``, the audio seconds of those chunks over the
window's wall seconds.
"""

from __future__ import annotations

import hashlib
import time

import numpy as np

from benchmark.harness import stats
from benchmark.kinds.song import gap
from benchmark.drivers.render_jobs import captures
from synthesizer_tpu_torch.utils import profiling

SR = 44100


def _chunks(run, song, cf: int):
    """(seconds from asking to frames on the host, frames) per chunk."""
    gen = song.mix_generator(chunk_frames=cf)
    while True:
        t0 = time.perf_counter()
        with run.span("sequencer.stream_chunk"):
            chunk = next(gen, None)
            if chunk is None:
                return
            frames = chunk.get_frame_array()
        yield time.perf_counter() - t0, frames


def run(run, kind) -> None:
    p = run.params
    cf = p["chunk_frames"]
    text = kind.text()
    song = kind.load(text)
    for _ in range(p["warm_passes"]):
        for _ in _chunks(run, song, cf):
            pass
    lat, kept = [], {}
    frames_done = 0
    c0 = captures()
    if run.trace:
        run.tracer.begin()
    t0 = run.window_started()
    deadline = t0 + run.seconds
    t_end = t0
    with profiling.count_program_launches() as launches:
        while t_end < deadline:
            h, parts = hashlib.sha256(), []
            for dt, frames in _chunks(run, song, cf):
                t_end = time.perf_counter()
                lat.append(dt)
                frames_done += len(frames)
                run.attempted += 1
                h.update(frames.tobytes())
                parts.append(np.array(frames))
                if run.tracer.due():
                    run.tracer.end()
                if t_end >= deadline:
                    break
            else:
                d = h.hexdigest()
                if d not in kept:
                    kept[d] = np.concatenate(parts)
    run.window_ended()
    run.counters["program.captures"] = captures() - c0
    run.counters["program.launches"] = launches[0]
    run.counters["chunks"] = len(lat)
    run.results["chunk_p95_ms"] = stats.percentile(lat, 95) * 1e3
    run.results["render_x_realtime"] = stats.rate(frames_done / SR, t0,
                                                  t_end)
    if not kept:
        # no pass ended inside the window: the check compares the next one
        kept["after"] = np.concatenate([np.array(f) for _, f in
                                        _chunks(run, song, cf)])
    run.extra["kept"] = (text, kept)


def check(run, kind) -> None:
    text, kept = run.extra.pop("kept")
    want = kind.reference(text, stream=True)
    worst = max(gap(got, want) for got in kept.values())
    run.check("stream_lsb_gap", worst, run.cell["limits"]["stream_lsb_gap"])
