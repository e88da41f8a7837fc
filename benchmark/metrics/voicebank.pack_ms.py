"""``pack_voices``, ``VoiceBank.for_voices`` and the sparse plan per job:
the median of the benchmark's host spans around them in a traced run, in
milliseconds."""

import statistics


def read(run):
    spans = run.spans.get("voicebank.pack")
    return statistics.median(spans) * 1e3 if spans else None
