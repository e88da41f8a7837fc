"""The port's ``sequencer.sidechain_key`` spans (the streaming sidechain
key provider: its host search of the key's hits and the key bus's
scatter) summed over the measured window outside the profiled
sub-window, over the count of ``sequencer.chunk`` roots there, in
milliseconds."""

from benchmark.kinds.tracker_song import ms_per_chunk


def read(run):
    return ms_per_chunk(run, "sequencer.sidechain_key")
