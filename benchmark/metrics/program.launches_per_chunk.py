"""Hand-written kernels and device programs launched per streamed chunk
(``utils.profiling.count_program_launches`` over the measured window)."""


def read(run):
    n = run.counters.get("chunks")
    launches = run.counters.get("program.launches")
    return launches / n if n and launches is not None else None
