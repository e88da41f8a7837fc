"""The port stands alone: importing every module of synthesizer_tpu_torch,
or every module chip_smoke.py imports, loads neither jax nor the JAX
package."""

import ast
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
                 "synthesizer_tpu_torch.ops.pcm",
                 "synthesizer_tpu_torch.ops.effects",
                 "synthesizer_tpu_torch.ops.coeffs",
                 "synthesizer_tpu_torch.ops.loudness",
                 "synthesizer_tpu_torch.ops.resample",
                 "synthesizer_tpu_torch.ops.wave",
                 "synthesizer_tpu_torch.models.graph",
                 "synthesizer_tpu_torch.sample",
                 "synthesizer_tpu_torch.oscillators",
                 "synthesizer_tpu_torch.synth",
                 "synthesizer_tpu_torch.utils.device",
                 "synthesizer_tpu_torch.utils.wavio",
                 "synthesizer_tpu_torch.bench_song",
                 "synthesizer_tpu_torch.midi",
                 "synthesizer_tpu_torch.params",
                 "synthesizer_tpu_torch.sequencer",
                 "synthesizer_tpu_torch.__main__"):
        assert want in names


def test_port_sources_name_no_jax():
    """No module of the port (and not chip_smoke.py) has an import statement
    that names jax or the JAX package, at top level or inside a function."""
    files = sorted((ROOT / "synthesizer_tpu_torch").rglob("*.py"))
    assert len(files) >= 20
    for path in files + [ROOT / "chip_smoke.py"]:
        for node in ast.walk(ast.parse(path.read_text())):
            if isinstance(node, ast.Import):
                mods = [a.name for a in node.names]
            elif isinstance(node, ast.ImportFrom) and node.level == 0:
                mods = [node.module]
            else:
                continue
            assert not [m for m in mods if _is_jax(m)], (path, mods)


def _is_jax(name):
    return name.split(".")[0] in ("jax", "synthesizer_tpu")


def _chip_smoke_imports():
    """Every import statement of chip_smoke.py, at top level or in a
    function, as (module, names imported from it)."""
    tree = ast.parse((ROOT / "chip_smoke.py").read_text())
    imports = []
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            imports.extend((a.name, []) for a in node.names)
        elif isinstance(node, ast.ImportFrom):
            imports.append((node.module, [a.name for a in node.names]))
    return imports


def _loads_no_jax(imports):
    """Run the imports in a fresh interpreter, as ``from module import
    names`` runs them, and check that neither jax nor the JAX package was
    loaded."""
    code = (
        "import sys\n"
        f"for module, names in {imports!r}:\n"
        "    __import__(module, fromlist=names)\n"
        "bad = sorted(m for m in sys.modules if m == 'jax' or m.startswith"
        "('jax.') or m == 'synthesizer_tpu' or m.startswith"
        "('synthesizer_tpu.'))\n"
        "assert not bad, bad\n"
        "print('ok')\n")
    res = subprocess.run([sys.executable, "-c", code], cwd=ROOT,
                         capture_output=True, text=True, timeout=120)
    assert res.returncode == 0, res.stderr
    assert res.stdout.strip() == "ok"


def test_port_imports_no_jax():
    _loads_no_jax([(name, []) for name in _port_modules()])


def test_chip_smoke_imports_no_jax():
    imports = _chip_smoke_imports()
    modules = {m for m, _ in imports}
    assert {"torch", "synthesizer_tpu_torch.ops"} <= modules
    assert ("synthesizer_tpu_torch.ops", ["kernels"]) in imports
    names = modules | {f"{m}.{n}" for m, ns in imports for n in ns}
    assert not [n for n in names if _is_jax(n)], sorted(names)
    _loads_no_jax(imports)
