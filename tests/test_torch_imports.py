"""The port stands alone: importing every module of synthesizer_tpu_torch
loads neither jax nor the JAX package."""

import pkgutil
import subprocess
import sys
from pathlib import Path

import synthesizer_tpu_torch

ROOT = Path(__file__).resolve().parents[1]


def _port_modules():
    names = ["synthesizer_tpu_torch"]
    for info in pkgutil.walk_packages(synthesizer_tpu_torch.__path__,
                                      "synthesizer_tpu_torch."):
        names.append(info.name)
    return names


def test_port_modules_found():
    names = set(_port_modules())
    for want in ("synthesizer_tpu_torch.models.voicebank",
                 "synthesizer_tpu_torch.models.spec",
                 "synthesizer_tpu_torch.ops.kernels",
                 "synthesizer_tpu_torch.ops.trig",
                 "synthesizer_tpu_torch.utils.wavio",
                 "synthesizer_tpu_torch.bench_song",
                 "synthesizer_tpu_torch.__main__"):
        assert want in names


def test_port_imports_no_jax():
    code = (
        "import importlib, sys\n"
        f"for name in {_port_modules()!r}:\n"
        "    importlib.import_module(name)\n"
        "bad = sorted(m for m in sys.modules if m == 'jax' or m.startswith"
        "('jax.') or m == 'synthesizer_tpu' or m.startswith"
        "('synthesizer_tpu.'))\n"
        "assert not bad, bad\n"
        "print('ok')\n")
    res = subprocess.run([sys.executable, "-c", code], cwd=ROOT,
                         capture_output=True, text=True, timeout=120)
    assert res.returncode == 0, res.stderr
    assert res.stdout.strip() == "ok"
