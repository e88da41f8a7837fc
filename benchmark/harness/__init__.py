"""The cell-independent parts of a run: the manifest, statistics, spans
and counters, the profiler's trace, the roofline arithmetic and the import
guard."""
