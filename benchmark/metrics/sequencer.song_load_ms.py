"""``Song.from_string`` per job: the median of the benchmark's host spans
around it in the measured window, in milliseconds."""

import statistics


def read(run):
    spans = run.spans.get("sequencer.song_load")
    return statistics.median(spans) * 1e3 if spans else None
