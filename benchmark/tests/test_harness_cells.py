"""A cell is found by its name: a throwaway cell added to a copy of the
benchmark as files alone is listed and loaded with no edit elsewhere."""

import json
import os
import shutil
import subprocess
import sys

from benchmark.harness import manifest

from .conftest import ROOT


def test_added_cell_needs_no_edit(tmp_path):
    shutil.copytree(os.path.join(ROOT, "benchmark"), tmp_path / "benchmark",
                    ignore=shutil.ignore_patterns("__pycache__"))
    shutil.copy(os.path.join(ROOT, "BENCHMARK.json"), tmp_path)
    before = {p: open(p, "rb").read() for p in
              (str(q) for q in (tmp_path / "benchmark").rglob("*")
               if q.is_file())}
    cell = dict(manifest.cell(ROOT, "demo_song.render"))
    cell["traffic"] = dict(cell["traffic"], repeats=[2])
    cell["why"] = "a throwaway cell"
    with open(tmp_path / "benchmark" / "workloads" /
              "demo_song.throwaway.json", "w") as f:
        json.dump(cell, f)
    man = manifest.load(str(tmp_path))
    man["workloads"].append({"name": "demo_song.throwaway",
                             "config": "demo_song", "traffic": "throwaway",
                             "chips": 1, "why": "a throwaway cell"})
    with open(tmp_path / "BENCHMARK.json", "w") as f:
        json.dump(man, f)
    root = str(tmp_path)
    assert "demo_song.throwaway" in manifest.cells(root)
    assert manifest.cell(root, "demo_song.throwaway")["traffic"][
        "repeats"] == [2]
    assert [m["name"] for m in manifest.metrics_for(
        manifest.load(root), "demo_song.throwaway", False)] == \
        ["render_x_realtime", "setup_s"]
    # no file that was there changed
    for p, body in before.items():
        assert open(p, "rb").read() == body
    # the copy's command reads the new cell and stops only for want of a
    # card: without one it exits 2 and prints no result
    env = dict(os.environ, CUDA_VISIBLE_DEVICES="")
    r = subprocess.run([sys.executable, "benchmark/run.py", "--workload",
                        "demo_song.throwaway", "--seed", "1", "--seconds",
                        "1"], cwd=root, env=env, capture_output=True,
                       text=True, timeout=300)
    assert r.returncode == 2, r.stderr
    assert r.stdout == ""
    assert "CUDA" in r.stderr or "program" in r.stderr


def test_alone_the_benchmark_does_not_run(tmp_path):
    """In a directory that holds only BENCHMARK.json and the benchmark,
    the command exits with an error and prints no result."""
    shutil.copytree(os.path.join(ROOT, "benchmark"), tmp_path / "benchmark",
                    ignore=shutil.ignore_patterns("__pycache__"))
    shutil.copy(os.path.join(ROOT, "BENCHMARK.json"), tmp_path)
    r = subprocess.run([sys.executable, "benchmark/run.py", "--workload",
                        "demo_song.render", "--seed", "1", "--seconds", "1"],
                       cwd=str(tmp_path), capture_output=True, text=True,
                       timeout=300, env=dict(os.environ, PYTHONPATH=""))
    assert r.returncode != 0
    assert r.stdout == ""
