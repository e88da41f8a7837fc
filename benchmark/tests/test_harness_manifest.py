"""BENCHMARK.json against the contract's names, units and limits, and
every file it names."""

import json
import os

import pytest

from benchmark.harness import manifest

from .conftest import ROOT

MAN = manifest.load(ROOT)
METRICS = MAN["end_to_end"] + MAN["per_layer"]
ONE_LINE = 200


def test_keys():
    assert set(MAN) == {"command", "paths", "run_seconds", "configs",
                        "workloads", "end_to_end", "per_layer"}
    assert 1 <= MAN["run_seconds"] <= 51
    assert len(json.dumps(MAN)) < 64 * 1024
    for p in MAN["paths"]:
        assert os.path.isdir(os.path.join(ROOT, p))
    assert len(MAN["command"]) <= 32


@pytest.mark.parametrize("entry", MAN["configs"] + MAN["workloads"]
                         + METRICS, ids=lambda e: e["name"])
def test_names_and_units(entry):
    assert manifest.NAME.match(entry["name"])
    if "unit" in entry:
        assert manifest.UNIT.match(entry["unit"])
        assert entry["better"] in ("lower", "higher")
    for key in ("why", "layer", "source"):
        if key in entry and key != "source":
            assert 1 <= len(entry[key]) <= ONE_LINE
            assert "\n" not in entry[key] and "\t" not in entry[key]


def test_unique_names():
    for group in (MAN["configs"], MAN["workloads"], METRICS):
        names = [e["name"] for e in group]
        assert len(names) == len(set(names))


@pytest.mark.parametrize("cell", MAN["workloads"], ids=lambda e: e["name"])
def test_cell_files(cell):
    c = manifest.cell(ROOT, cell["name"])
    assert c["config"] == cell["config"] and c["chips"] == cell["chips"]
    assert c["why"] == cell["why"]
    assert cell["name"] == f"{cell['config']}.{cell['traffic']}"
    cfg = manifest.config(ROOT, c["config"])
    manifest.driver(c["driver"])
    manifest.kind(cfg["kind"])
    e2e = manifest.metrics_for(MAN, cell["name"], trace=False)
    names = {m["name"] for m in e2e}
    assert "setup_s" in names and len(names) >= 2
    assert manifest.metrics_for(MAN, cell["name"], trace=True)


@pytest.mark.parametrize("cfg", MAN["configs"], ids=lambda e: e["name"])
def test_config_files(cfg):
    assert cfg["file"].startswith(MAN["paths"][0] + "/")
    with open(os.path.join(ROOT, cfg["file"])) as f:
        body = json.load(f)
    assert body["name"] == cfg["name"]
    assert body["reduced"] == cfg["reduced"]


@pytest.mark.parametrize("metric", MAN["per_layer"], ids=lambda e: e["name"])
def test_per_layer_readers(metric):
    mod = manifest.reader(ROOT, metric["name"])
    assert callable(mod.read)
    assert metric["moves"] in {m["name"] for m in MAN["end_to_end"]}
    for cell in metric["workloads"]:
        reported = manifest.metrics_for(MAN, cell, trace=False)
        assert metric["moves"] in {m["name"] for m in reported}


def test_bounds():
    for m in MAN["end_to_end"]:
        assert 0.01 <= m["bound"] <= 0.25
        assert m["source"] in ("host_clock", "device_trace")
