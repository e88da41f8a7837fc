"""Settings of every pytest run from this checkout that concern how the
tests run, not what they check.

``tests/conftest.py`` sets up the JAX package's CPU backend for its tests;
this file holds what the whole suite shares:

- one torch thread per process;
- ``LIMIT``, a wall-clock limit on every test's call;
- xdist's file queue in collection order, the heaviest files handed out
  a test function at a time;
- one XLA compile cache on disk for a run that has loaded jax.

It imports no jax, so the benchmark's own tests, which refuse a process
that has loaded jax, run under it too.
"""

import faulthandler
import os
import shutil
import signal
import sys
import tempfile

import pytest

#: Wall-clock seconds one test's call may take.  A test that runs past it
#: fails with its name, after faulthandler has printed every thread's
#: stack; the same dump, armed for the same moment, still prints where a
#: test is stuck inside native code, where the failure cannot be raised
#: until that code returns.  It is three times the slowest tests of a
#: whole tier-1 run on 8 cores (150-170 s; one took 267 s on a busier
#: machine): a new test that comes near it is too slow for the suite.
LIMIT = 480

#: Files that take more than about a tenth of the suite's summed worker
#: time (670, 430 and 374 of 4,039 s in a whole tier-1 run on 8 cores).
#: Handed out whole, by ``--dist loadfile``, the worker that draws one ends
#: the run well after the others; they go out one test function (all of
#: its cases) at a time instead.
SPLIT_FILES = ("tests/test_automation.py", "tests/test_effects.py",
               "tests/test_song_fx.py")


def pytest_configure(config):
    import torch

    # The port's tests share each process with the JAX tests, and the suite
    # runs as several xdist workers on one machine: one torch thread per
    # process keeps them from oversubscribing its cores.  It is set here,
    # once, because a worker imports every test module before it runs one,
    # so a per-module setting would only leave the last module's value in
    # force.
    torch.set_num_threads(1)
    # --dist loadfile hands out whole files, by default those with the most
    # tests first, which leaves the JAX package's heavy files of a few slow
    # tests for the end of the run.  In collection order they start early
    # and the many light port files (test_torch_*) fill the end instead.
    if hasattr(config.option, "loadscopereorder"):
        config.option.loadscopereorder = False
    if not hasattr(config, "workerinput"):
        _share_compiled_programs(config)


def _share_compiled_programs(config):
    """One XLA compile cache on disk for a run that has loaded jax, read
    and written by every xdist worker (they inherit the variable) and by
    the tests' subprocesses.

    The workers compile many of the same programs: a song's voice bank and
    master chain for each file that renders it, and whatever a worker used
    before ``tests/conftest.py``'s map-count clear.  With the cache each
    program that takes a second or more to compile is compiled once in the
    run and loaded wherever else it is asked for; a loaded executable is
    the same compiled code, so every result stays the same.  The directory
    lives only as long as the run; a value already set is used as it is.
    """
    jax = sys.modules.get("jax")
    if jax is None or os.environ.get("JAX_COMPILATION_CACHE_DIR"):
        return
    cache = tempfile.mkdtemp(prefix="jax-compile-cache-")
    os.environ["JAX_COMPILATION_CACHE_DIR"] = cache
    jax.config.update("jax_compilation_cache_dir", cache)
    config.add_cleanup(lambda: shutil.rmtree(cache, ignore_errors=True))


@pytest.hookimpl(optionalhook=True)
def pytest_xdist_make_scheduler(config, log):
    if config.getvalue("dist") != "loadfile":
        return None
    from xdist.scheduler import LoadFileScheduling

    class SplitHeavyFiles(LoadFileScheduling):
        def _split_scope(self, nodeid):
            path = nodeid.split("::", 1)[0]
            if path in SPLIT_FILES:
                return nodeid.split("[", 1)[0]
            return path

    return SplitHeavyFiles(config, log)


@pytest.hookimpl(hookwrapper=True)
def pytest_runtest_call(item):
    def past_limit(signum, frame):
        faulthandler.cancel_dump_traceback_later()
        faulthandler.dump_traceback(file=sys.__stderr__)
        pytest.fail(f"{item.nodeid} ran past the {LIMIT} s limit per test "
                    "(LIMIT in conftest.py)")

    previous = signal.signal(signal.SIGALRM, past_limit)
    signal.setitimer(signal.ITIMER_REAL, LIMIT)
    faulthandler.dump_traceback_later(LIMIT, file=sys.__stderr__)
    try:
        yield
    finally:
        signal.setitimer(signal.ITIMER_REAL, 0)
        faulthandler.cancel_dump_traceback_later()
        signal.signal(signal.SIGALRM, previous)
