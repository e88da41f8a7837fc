"""One run of one cell of the benchmark of ``synthesizer_tpu_torch`` on
NVIDIA GPUs: set-up, warm-up, a measured window of ``--seconds``, then the
check of the window's outputs against the plain reference.

    python3 benchmark/run.py --workload demo_song.render --seed 7 \\
        --seconds 51 --trace 0

The last line of standard output is one JSON object: ``correct``,
``attempted``, ``failed``, ``metrics`` (the cell's end-to-end metrics, or
with ``--trace 1`` its per-layer metrics), ``device``, with ``--trace 1``
``breakdown``, ``build`` (the seconds of the kernel library's nvcc build
or look-up, and whether this run built it), and last ``checks``, each
number compared with its limit.
The last lines of standard error repeat the checks.  Without a CUDA device,
or without the program beside the benchmark, the run exits with code 2 and
prints no result; if JAX or the JAX package was loaded, with code 3.
"""

import time

T_PROCESS = time.perf_counter()

import argparse  # noqa: E402
import gc  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import shutil  # noqa: E402
import sys  # noqa: E402
import tempfile  # noqa: E402

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _fail(code: int, msg: str) -> int:
    print(f"error: {msg}", file=sys.stderr)
    return code


def _build_library() -> dict:
    """The program's nvcc build of its kernel library, which a checkout's
    first run makes under ``build/`` and later runs find: timed apart, and
    left inside ``setup_s``, which counts compilation in a run that
    compiles."""
    from synthesizer_tpu_torch.ops import kernels
    lib_dir = str(kernels.BUILD_DIR)

    def libs():
        return set(os.listdir(lib_dir)) if os.path.isdir(lib_dir) else set()
    before = libs()
    t = time.perf_counter()
    kernels.build_library()
    return {"build_s": time.perf_counter() - t,
            "built": bool(libs() - before)}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)

    # every build and kernel cache inside the checkout, at fixed paths
    cache = os.path.join(ROOT, "build", "benchmark-cache")
    os.environ["TRITON_CACHE_DIR"] = os.path.join(cache, "triton")
    os.environ["TORCH_EXTENSIONS_DIR"] = os.path.join(cache, "torch_ext")
    sys.path.insert(0, ROOT)
    from benchmark.harness import guard, manifest
    from benchmark.harness.context import Run

    man = manifest.load(ROOT)
    cell = manifest.cell(ROOT, args.workload)
    config = manifest.config(ROOT, cell["config"])

    import torch
    if not torch.cuda.is_available():
        return _fail(2, "no CUDA device")
    if torch.cuda.device_count() < cell["chips"]:
        return _fail(2, f"{cell['chips']} devices needed, "
                        f"{torch.cuda.device_count()} found")
    try:
        import synthesizer_tpu_torch  # noqa: F401
    except ImportError as e:
        return _fail(2, f"the program is not beside the benchmark: {e}")
    torch.set_num_threads(1)
    build = _build_library()
    print(f"kernel library: {'built' if build['built'] else 'found'} in "
          f"{build['build_s']:.3f} s", file=sys.stderr)

    driver = manifest.driver(cell["driver"])
    tmp = tempfile.mkdtemp(prefix="bench-")
    run = Run(cell=cell, config=config, seed=args.seed,
              seconds=args.seconds, trace=bool(args.trace), root=ROOT,
              t_process=T_PROCESS, tmpdir=tmp)
    try:
        kind = manifest.kind(config["kind"]).make(run)
        driver.run(run, kind)
        memory_peak = max(torch.cuda.max_memory_reserved(d)
                          for d in range(cell["chips"]))
        gc.collect()
        torch.cuda.empty_cache()
        driver.check(run, kind)
    finally:
        shutil.rmtree(tmp, ignore_errors=True)

    found = guard.forbidden_modules()
    if found:
        return _fail(3, "loaded: " + ", ".join(found))

    metrics = {}
    for m in manifest.metrics_for(man, args.workload, run.trace):
        if run.trace:
            value = manifest.reader(ROOT, m["name"]).read(run)
        elif m["name"] == "setup_s":
            value = run.setup_s
        else:
            value = run.results.get(m["name"])
        if value is not None:
            metrics[m["name"]] = {"value": value, "unit": m["unit"]}
    device = {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
              "count": cell["chips"], "memory_peak_bytes": memory_peak}
    line = {"correct": bool(run.checks) and all(c.ok for c in run.checks),
            "attempted": run.attempted, "failed": run.failed,
            "metrics": metrics, "device": device}
    summary = run.tracer.summary
    if summary is not None:
        device["busy_s"] = summary.busy_s
        device["window_s"] = summary.window_s
        line["breakdown"] = summary.breakdown()
    line["build"] = build
    line["checks"] = {c.name: {"value": c.value, "limit": c.limit}
                      for c in run.checks}
    for c in run.checks:
        print(f"check {c.name}: {c.value} (limit {c.limit}) "
              f"{'ok' if c.ok else 'FAIL'}", file=sys.stderr)
    print(json.dumps(line))
    return 0


if __name__ == "__main__":
    sys.exit(main())
