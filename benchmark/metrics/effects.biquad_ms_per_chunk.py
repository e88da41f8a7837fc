"""The port's ``effects.biquad`` spans (the biquad processors' host work
a chunk, their program's launch included) summed over the measured window
outside the profiled sub-window, over the count of ``sequencer.chunk``
roots there, in milliseconds."""

from benchmark.kinds.tracker_song import ms_per_chunk


def read(run):
    return ms_per_chunk(run, "effects.biquad")
