"""``BENCHMARK.json`` and the files it names, found by name: a cell in
``workloads/<cell>.json``, a configuration in ``configs/<config>.json``,
a driver in ``drivers/<driver>.py``, a configuration's kind in
``kinds/<kind>.py`` and a per-layer metric's reader in
``metrics/<metric>.py``."""

from __future__ import annotations

import importlib
import importlib.util
import json
import os
import re

NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.\-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.\-]{1,16}$")


def bench_dir(root: str) -> str:
    return os.path.join(root, "benchmark")


def load(root: str) -> dict:
    with open(os.path.join(root, "BENCHMARK.json")) as f:
        return json.load(f)


def _json(root: str, sub: str, name: str) -> dict:
    if not NAME.match(name):
        raise ValueError(f"not a name: {name!r}")
    with open(os.path.join(bench_dir(root), sub, name + ".json")) as f:
        return json.load(f)


def cell(root: str, name: str) -> dict:
    return _json(root, "workloads", name)


def config(root: str, name: str) -> dict:
    return _json(root, "configs", name)


def cells(root: str) -> list:
    """The names of every cell file."""
    d = os.path.join(bench_dir(root), "workloads")
    return sorted(f[:-5] for f in os.listdir(d) if f.endswith(".json"))


def applies(metric: dict, cell_name: str) -> bool:
    return "workloads" not in metric or cell_name in metric["workloads"]


def metrics_for(manifest: dict, cell_name: str, trace: bool) -> list:
    """The metrics a run of the cell prints: the end-to-end ones, or with
    ``trace`` the per-layer ones."""
    group = manifest["per_layer" if trace else "end_to_end"]
    return [m for m in group if applies(m, cell_name)]


def driver(name: str):
    return importlib.import_module(f"benchmark.drivers.{name}")


def kind(name: str):
    return importlib.import_module(f"benchmark.kinds.{name}")


def reader(root: str, metric: str):
    """The metric's reader module (a file named after the metric)."""
    if not NAME.match(metric):
        raise ValueError(f"not a name: {metric!r}")
    path = os.path.join(bench_dir(root), "metrics", metric + ".py")
    spec = importlib.util.spec_from_file_location(
        "benchmark.metrics." + metric.replace(".", "_").replace("-", "_"),
        path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod
