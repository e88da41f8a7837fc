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
                 "synthesizer_tpu_torch.ops.hits",
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
                 "synthesizer_tpu_torch.bench",
                 "synthesizer_tpu_torch.midi",
                 "synthesizer_tpu_torch.params",
                 "synthesizer_tpu_torch.sequencer",
                 "synthesizer_tpu_torch.effects",
                 "synthesizer_tpu_torch.streaming",
                 "synthesizer_tpu_torch.playback",
                 "synthesizer_tpu_torch.voice",
                 "synthesizer_tpu_torch.server",
                 "synthesizer_tpu_torch.utils.native",
                 "synthesizer_tpu_torch.utils.profiling",
                 "synthesizer_tpu_torch.utils.program",
                 "synthesizer_tpu_torch.utils.flac",
                 "synthesizer_tpu_torch.utils.decoders",
                 "synthesizer_tpu_torch.utils.codecs",
                 "synthesizer_tpu_torch.utils.libav",
                 "synthesizer_tpu_torch.utils.soxr",
                 "synthesizer_tpu_torch.utils.modules",
                 "synthesizer_tpu_torch.parallel",
                 "synthesizer_tpu_torch.parallel.mesh",
                 "synthesizer_tpu_torch.parallel.dryrun",
                 "synthesizer_tpu_torch.apps",
                 "synthesizer_tpu_torch.apps.trackmixer",
                 "synthesizer_tpu_torch.apps.keyboard_gui",
                 "synthesizer_tpu_torch.apps.jukebox",
                 "synthesizer_tpu_torch.apps.jukebox.backend",
                 "synthesizer_tpu_torch.apps.jukebox.box",
                 "synthesizer_tpu_torch.gpu_verify",
                 "synthesizer_tpu_torch.examples",
                 "synthesizer_tpu_torch.examples.fm_bell",
                 "synthesizer_tpu_torch.examples.midi_demo",
                 "synthesizer_tpu_torch.examples.render_server_demo",
                 "synthesizer_tpu_torch.examples.sharded_mixdown",
                 "synthesizer_tpu_torch.__main__"):
        assert want in names


def _reference_exports():
    """The names the JAX package's ``__init__.py`` imports into its top
    level (read from its source: importing it would load jax)."""
    tree = ast.parse((ROOT / "synthesizer_tpu" / "__init__.py").read_text())
    names = set()
    for node in tree.body:
        if isinstance(node, ast.ImportFrom):
            names.update(a.asname or a.name for a in node.names)
    return names


def test_top_level_exports_every_reference_name():
    ref = _reference_exports()
    assert len(ref) == 23 and {"Song", "RenderServer", "render_midi",
                               "RealtimeVoice", "StreamingLoudness"} <= ref
    assert ref <= set(synthesizer_tpu_torch.__all__)
    for name in synthesizer_tpu_torch.__all__:
        obj = getattr(synthesizer_tpu_torch, name)
        mod = getattr(obj, "__module__", None) or obj.__name__
        assert mod.startswith("synthesizer_tpu_torch"), (name, mod)


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


def test_gpu_verify_imports_no_jax_nor_tests():
    """The battery loads neither jax, the JAX package nor the JAX suite's
    oracles (it keeps its own copies), and names no test module."""
    tree = ast.parse((ROOT / "synthesizer_tpu_torch" / "gpu_verify.py")
                     .read_text())
    for node in ast.walk(tree):
        if isinstance(node, (ast.Import, ast.ImportFrom)):
            mods = ([a.name for a in node.names]
                    if isinstance(node, ast.Import) else [node.module or ""])
            assert not [m for m in mods if _is_jax(m)
                        or m.split(".")[0].startswith("test")], mods
    code = ("import sys\n"
            "import synthesizer_tpu_torch.gpu_verify\n"
            "bad = sorted(m for m in sys.modules if m.split('.')[0] in "
            "('jax', 'synthesizer_tpu', 'test_voicebank', 'tests'))\n"
            "assert not bad, bad\n"
            "print('ok')\n")
    res = subprocess.run([sys.executable, "-c", code], cwd=ROOT,
                         capture_output=True, text=True, timeout=120)
    assert res.returncode == 0, res.stderr
    assert res.stdout.strip() == "ok"
