"""The suite's own machinery: the root conftest.py's per-test time limit
and its run-wide compile cache, each checked in an inner pytest session in
a subprocess, inside an xdist worker, and its split of the heaviest files
into work units of one test function."""

import importlib.util
import os
import subprocess
import sys
import textwrap

SUITE_CONFTEST = os.path.join(
    os.path.dirname(os.path.dirname(os.path.abspath(__file__))), "conftest.py")

INNER_CONFTEST = textwrap.dedent("""
    import importlib.util

    import jax  # noqa: F401 -- loaded first, as tests/conftest.py does

    spec = importlib.util.spec_from_file_location("suite_conftest", {path!r})
    suite = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(suite)
    suite.LIMIT = {limit}
    pytest_configure = suite.pytest_configure
    pytest_runtest_call = suite.pytest_runtest_call
""")

INNER_TESTS = textwrap.dedent("""
    import time


    def test_sleeps_past_the_limit():
        time.sleep(120)


    def test_runs_after():
        pass
""")


INNER_CACHE_TESTS = textwrap.dedent("""
    import os

    import jax
    import jax.numpy as jnp
    import numpy as np
    from jax import monitoring

    HITS = []
    monitoring.register_event_listener(
        lambda event, **kw: HITS.append(event)
        if event == "/jax/compilation_cache/cache_hits" else None)
    X = np.linspace(-3.0, 3.0, 4096, dtype=np.float32).reshape(-1, 2)
    RESULTS = []


    def program():
        # a new function each call, so that jit's own cache cannot serve it
        return jax.jit(lambda x: jnp.cumsum(jnp.sin(x) * 3.0, axis=0))


    def test_first_user_compiles_and_stores():
        RESULTS.append(np.asarray(program()(X)))
        assert not HITS
        assert os.listdir(os.environ["JAX_COMPILATION_CACHE_DIR"])


    def test_second_user_loads_the_same_program():
        RESULTS.append(np.asarray(program()(X)))
        assert HITS
        np.testing.assert_array_equal(RESULTS[1], RESULTS[0])
""")

def _inner_session(tmp_path, tests, limit, **env_extra):
    """Run ``tests`` under the suite's conftest hooks in a new pytest
    process, in one xdist worker, whose temporary files go under
    ``tmp_path/"tmp"``."""
    (tmp_path / "conftest.py").write_text(INNER_CONFTEST.format(
        path=SUITE_CONFTEST, limit=limit))
    (tmp_path / "test_inner.py").write_text(tests)
    (tmp_path / "tmp").mkdir()
    env = dict(os.environ, JAX_PLATFORMS="cpu", TMPDIR=str(tmp_path / "tmp"),
               **env_extra)
    for name in ("PYTEST_XDIST_WORKER", "PYTEST_XDIST_WORKER_COUNT",
                 "JAX_COMPILATION_CACHE_DIR"):
        env.pop(name, None)
    return subprocess.run(
        [sys.executable, "-m", "pytest", "-q", "-p", "no:cacheprovider",
         "-p", "no:randomly", "-p", "xdist", "-n", "1",
         str(tmp_path / "test_inner.py")],
        cwd=tmp_path, env=env, capture_output=True, text=True, timeout=100)


def test_limit_fails_a_test_that_runs_past_it(tmp_path):
    run = _inner_session(tmp_path, INNER_TESTS, limit=1)
    out = run.stdout + run.stderr
    assert run.returncode == 1, out
    assert "1 failed, 1 passed" in out, out
    assert "test_sleeps_past_the_limit ran past the 1 s limit" in out, out
    # faulthandler's dump of every thread, the stuck one included
    assert "most recent call first" in out, out
    assert "in test_sleeps_past_the_limit" in out, out


def test_a_second_user_loads_the_compiled_program(tmp_path):
    """The run's compile cache: the second test asks for the same program
    through a new function, loads it from the cache and computes the same
    array; the cache goes with the run.  The inner run caches every
    program, however quick its compile."""
    run = _inner_session(tmp_path, INNER_CACHE_TESTS, limit=60,
                         JAX_PERSISTENT_CACHE_MIN_COMPILE_TIME_SECS="0")
    out = run.stdout + run.stderr
    assert run.returncode == 0, out
    assert "2 passed" in out, out
    assert not list((tmp_path / "tmp").glob("jax-compile-cache-*"))


def _suite_conftest():
    spec = importlib.util.spec_from_file_location("suite_conftest",
                                                  SUITE_CONFTEST)
    suite = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(suite)
    return suite


class _Config:
    """What xdist's schedulers read of the run's options."""

    def __init__(self, dist):
        self.values = {"dist": dist, "tx": ["6*popen"]}

    def getvalue(self, name):
        return self.values[name]


def test_heavy_files_go_out_a_test_function_at_a_time():
    suite = _suite_conftest()
    root = os.path.dirname(SUITE_CONFTEST)
    assert all(os.path.isfile(os.path.join(root, path))
               for path in suite.SPLIT_FILES)
    sched = suite.pytest_xdist_make_scheduler(_Config("loadfile"), None)
    heavy = suite.SPLIT_FILES[0]
    assert sched._split_scope(f"{heavy}::test_a[1000]") == f"{heavy}::test_a"
    assert sched._split_scope(f"{heavy}::test_a[4096]") == f"{heavy}::test_a"
    assert sched._split_scope(f"{heavy}::test_b") == f"{heavy}::test_b"
    # every other file stays one unit, as --dist loadfile has it
    assert sched._split_scope("tests/test_torch_synth.py::test_a[1]") == \
        "tests/test_torch_synth.py"
    assert suite.pytest_xdist_make_scheduler(_Config("load"), None) is None
