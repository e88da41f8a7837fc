"""Kinds of traffic: what a workload file's ``driver`` names.  A driver's
``run(run, kind)`` makes the set-up, warms up every shape the traffic
uses and measures the window; its ``check(run, kind)`` compares what the
window produced with the reference once the window has closed."""
