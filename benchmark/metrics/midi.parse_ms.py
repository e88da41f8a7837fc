"""``parse_midi`` and ``midi_to_voices`` per job: the median of the
benchmark's host spans around them in a traced run (which drives
``render_midi``'s steps one by one), in milliseconds."""

import statistics


def read(run):
    spans = run.spans.get("midi.parse")
    return statistics.median(spans) * 1e3 if spans else None
