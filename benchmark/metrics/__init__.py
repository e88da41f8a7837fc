"""One reader per per-layer metric, in a file named after the metric:
``read(run)`` returns the metric's value, or None where the run holds
nothing to read it from."""
