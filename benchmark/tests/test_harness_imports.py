"""Nothing the benchmark runs loads JAX or the JAX package, and the
reference loads nothing of the program: top-level names compared whole."""

import json
import subprocess
import sys

from benchmark.harness.guard import forbidden_modules

from .conftest import ROOT


def _modules(code: str) -> list:
    r = subprocess.run([sys.executable, "-c", code + "\nimport sys, json\n"
                        "print(json.dumps(sorted(sys.modules)))"],
                       cwd=ROOT, capture_output=True, text=True,
                       timeout=300, env={"PATH": "/usr/bin:/bin",
                                         "PYTHONPATH": ROOT})
    assert r.returncode == 0, r.stderr
    return json.loads(r.stdout.splitlines()[-1])


def test_guard_compares_whole_top_level_names():
    mods = {"jax": 1, "jax.numpy": 1, "jaxlib.xla": 1, "flax": 1,
            "synthesizer_tpu": 1, "synthesizer_tpu.sequencer": 1,
            "synthesizer_tpu_torch": 1, "synthesizer_tpu_torch.midi": 1,
            "jaxtyping": 1, "benchmark.reference.song": 1}
    assert forbidden_modules(mods) == ["flax", "jax", "jax.numpy",
                                       "jaxlib.xla", "synthesizer_tpu",
                                       "synthesizer_tpu.sequencer"]


def test_the_harness_loads_no_jax():
    mods = _modules(
        "from benchmark.harness import manifest\n"
        "from benchmark import run\n"
        "root = run.ROOT\n"
        "man = manifest.load(root)\n"
        "for c in man['workloads']:\n"
        "    cell = manifest.cell(root, c['name'])\n"
        "    manifest.driver(cell['driver'])\n"
        "    manifest.kind(manifest.config(root, cell['config'])['kind'])\n"
        "for m in man['per_layer']:\n"
        "    manifest.reader(root, m['name'])\n"
        "import synthesizer_tpu_torch.sequencer, synthesizer_tpu_torch.midi\n")
    assert "synthesizer_tpu_torch" in mods
    assert forbidden_modules(dict.fromkeys(mods)) == []


def test_the_reference_loads_nothing_of_the_program():
    mods = _modules("import benchmark.reference.song\n"
                    "import benchmark.inputs.demo_song\n"
                    "import benchmark.inputs.kit\n")
    top = {m.split(".")[0] for m in mods}
    assert not top & {"jax", "jaxlib", "flax", "synthesizer_tpu",
                      "synthesizer_tpu_torch", "torch"}
