"""CUDA-graph captures of the device programs inside the measured window
(``Program.captures`` summed over the program cache); each is a stall of
up to seconds that warm-up should have taken."""


def read(run):
    return run.counters.get("program.captures")
