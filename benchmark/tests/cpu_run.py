"""A run of a cell on the CPU for the harness's tests: the look for a
card is stubbed, the configuration kinds render on the CPU, and a fault
can be planted in the program underneath."""

from __future__ import annotations

import contextlib
import io
import json
import os
import sys

import torch

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))
if ROOT not in sys.path:
    sys.path.insert(0, ROOT)


@contextlib.contextmanager
def cpu_card(monkeypatch, build=None):
    """torch.cuda answers as one card, the kernel library counts as
    built (or ``build`` stands in for its build), and the program renders
    on the CPU."""
    from benchmark.kinds import song
    from synthesizer_tpu_torch.ops import kernels
    monkeypatch.setattr(kernels, "build_library",
                        build or (lambda: (None, "")))
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 1)
    monkeypatch.setattr(torch.cuda, "get_device_name", lambda *a: "cpu")
    monkeypatch.setattr(torch.cuda, "max_memory_reserved", lambda *a: 0)
    monkeypatch.setattr(torch.cuda, "empty_cache", lambda: None)
    monkeypatch.setattr(torch.cuda, "synchronize", lambda *a: None)
    monkeypatch.setattr(song.SongKind, "device", "cpu")
    yield


def run_cell(monkeypatch, cell: str, seed: int = 1, seconds: float = 0.5,
             trace: int = 0, cell_edit=None, build=None):
    """-> (exit code, the result line or None, standard error)."""
    from benchmark import run as runmod
    from benchmark.harness import manifest
    if cell_edit is not None:
        orig = manifest.cell

        def edited(root, name):
            c = orig(root, name)
            cell_edit(c)
            return c
        monkeypatch.setattr(manifest, "cell", edited)
    out, err = io.StringIO(), io.StringIO()
    with cpu_card(monkeypatch, build), contextlib.redirect_stdout(out), \
            contextlib.redirect_stderr(err):
        code = runmod.main(["--workload", cell, "--seed", str(seed),
                            "--seconds", str(seconds),
                            "--trace", str(trace)])
    lines = out.getvalue().strip().splitlines()
    line = json.loads(lines[-1]) if code == 0 and lines else None
    return code, line, err.getvalue()
