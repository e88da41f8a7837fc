"""The port's bench program (``synthesizer_tpu_torch.bench``) against the
root ``bench.py`` and the JAX package, on the CPU.

The root ``bench`` module is imported only to read its builders; the
workloads written inline in its ``main`` (the sparse notes, config 2's
voices, the patches of configs 1 and 4) are read from its source with
``ast`` and built with the JAX package's classes.  One tiny run of the
whole program (``--device cpu --tiny``) is shared by the tests of its line.
"""

import ast
import contextlib
import dataclasses
import io
import json
import math
from pathlib import Path

import jax
import numpy as np
import pytest
import torch

import bench
from synthesizer_tpu.models import graph as JG
from synthesizer_tpu.models import spec as JS
from synthesizer_tpu.models import voicebank as JV
from synthesizer_tpu.ops import effects as JF
from synthesizer_tpu.ops.resample import hq_resample as jax_hq_resample
from synthesizer_tpu_torch import bench as B
from synthesizer_tpu_torch import bench_song
from synthesizer_tpu_torch.ops.effects import BUDGETS

SR = 44100
ROOT = Path(__file__).resolve().parents[1]
LSB = 1.0 / 32767


def _bench_main():
    tree = ast.parse((ROOT / "bench.py").read_text())
    return next(n for n in tree.body
                if isinstance(n, ast.FunctionDef) and n.name == "main")


def _assigned(name):
    """The statement of bench.py's main (nested functions included) that
    assigns ``name``, and the statement after it."""
    for node in ast.walk(_bench_main()):
        body = getattr(node, "body", None)
        if not isinstance(body, list):
            continue
        for i, st in enumerate(body):
            if isinstance(st, ast.Assign) and any(
                    isinstance(t, ast.Name) and t.id == name
                    for t in st.targets):
                return body[i:i + 2]
    raise LookupError(name)


def _run(statements, **ns):
    ns.update(np=np, Spec=JS, BankVoice=JV.Voice)
    exec(compile(ast.Module(body=list(statements), type_ignores=[]),
                 "bench.py", "exec"), ns)
    return ns


def _bench_sparse_voices():
    rng, voices = _assigned("rng3")[0], _assigned("v3")[0]
    return _run([rng, voices], nnotes=600, dur=300.0)["v3"]


def _bench_config2_voices():
    return _run(_assigned("c2_voices"))["c2_voices"]


def _bench_config1_patch():
    call = _assigned("config1_rtf")[0].value
    return eval(compile(ast.Expression(call.args[0]), "bench.py", "eval"),
                {"Spec": JS})


def _bench_config4_patch():
    return _run(_assigned("patch4")[:1])["patch4"]


def _voices(vs):
    return [dataclasses.asdict(v) for v in vs]


def _json_line(argv):
    """main(argv) -> (exit code, the last line as a dict, all stdout)."""
    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        rc = B.main(argv)
    text = out.getvalue()
    return rc, json.loads(text.strip().splitlines()[-1]), text


@pytest.fixture(scope="module")
def tiny_run():
    return _json_line(["--device", "cpu", "--tiny"])


# -- (a) the keys -------------------------------------------------------------

def test_keys_are_bench_py_keys(tiny_run):
    dumps = next(n for n in ast.walk(_bench_main())
                 if isinstance(n, ast.Call) and getattr(n.func, "attr", "")
                 == "dumps" and isinstance(n.args[0], ast.Dict)
                 and len(n.args[0].keys) > 30)
    keys = tuple(k.value for k in dumps.args[0].keys)
    assert keys == B.BENCH_PY_KEYS and len(keys) == 32
    rc, line, _ = tiny_run
    assert rc == 0
    assert set(keys) <= set(line)
    assert list(line) == list(B.BENCH_PY_KEYS + B.EXTRA_KEYS)


# -- (b) the workloads are bench.py's -----------------------------------------

def test_workloads_match_bench_py():
    assert _voices(bench_song.build_song(64, 60.0)) == \
        _voices(bench.build_song(64, 60.0, SR))
    assert _voices(bench_song.sparse_voices(600, 300.0, 5)) == \
        _voices(_bench_sparse_voices())
    assert _voices(bench_song.config2_voices()) == \
        _voices(_bench_config2_voices())
    assert repr(bench_song.config1_patch()) == repr(_bench_config1_patch())
    assert repr(bench_song.config4_patch()) == repr(_bench_config4_patch())


def test_full_sizes_are_bench_py_sizes():
    f = B.FULL
    assert (f.headline, f.chunk, f.scale, f.long, f.sparse) == (
        (64, 60.0), 131072, (1024, 10.0), (64, 600.0), (600, 300.0, 5))
    assert (f.config3, f.fx_seconds) == ((16, 2.0, 1.0), 20.0)
    assert f.sha256 == bench_song.CONFIG5_SHA256 and f.reps >= 5
    assert f.long_past == 2 ** 24 and int(f.long[1] * SR) > 2 ** 24 + 16384


# -- (c) the sparse keys against the JAX plan ---------------------------------

def test_sparse_keys_match_jax():
    bank, vp, total, plan = B.sparse_bank("cpu", 600, 300.0, 5, 131072)
    assert plan is not None
    jv = _bench_sparse_voices()
    jvp, jly = JV.pack_voices(jv, SR, num_harmonics=8, sort_by_wave=True)
    jbank = JV.VoiceBank.for_voices(jv, SR, chunk_frames=131072,
                                    num_harmonics=8, layout=jly,
                                    nvoices=jly.nvoices)
    _, jidx, jpad, jn = jbank.sparse_plan(jvp, total)
    _, idx, pad, n = plan
    assert bank.layout.nvoices == jly.nvoices == 600
    assert idx.shape[1] == np.asarray(jidx).shape[1]
    assert np.array_equal(idx.numpy(), np.asarray(jidx))
    assert (pad, n) == (jpad, jn)


# -- (d) the workloads' outputs against the JAX package -----------------------

def _jax_bank16(voices, nharm, chunk, total):
    vp, ly = JV.pack_voices(voices, SR, num_harmonics=nharm,
                            sort_by_wave=True)
    bank = JV.VoiceBank.for_voices(voices, SR, chunk_frames=chunk,
                                   num_harmonics=nharm, layout=ly,
                                   nvoices=ly.nvoices)
    return np.asarray(bank.to_int16(bank.render_song(vp, total)))


def _lsb16(got, want):
    got, want = np.asarray(got), np.asarray(want)
    assert got.shape == want.shape
    return int(np.abs(got.astype(np.int64) - want.astype(np.int64)).max())


def test_headline_matches_jax():
    bank, vp, total = bench_song.song_bank(8, 2.0, "cpu", 8192)
    got = B.render16(bank, vp, total).numpy()
    want = _jax_bank16(bench.build_song(8, 2.0, SR), 8, 8192, total)
    assert np.abs(want).max() > 1000 and _lsb16(got, want) <= 1


def test_config2_matches_jax():
    bank, vp, total = B.config2_bank("cpu")
    got = B.render16(bank, vp, total).numpy()
    want = _jax_bank16(_bench_config2_voices(), 4, 16384, total)
    assert np.abs(want).max() > 1000 and _lsb16(got, want) <= 1


@pytest.mark.parametrize("config", ["config1", "config4"])
def test_patch_configs_match_jax(config):
    port, ref, total, block = {
        "config1": (bench_song.config1_patch, _bench_config1_patch,
                    2 * SR, 32768),
        "config4": (bench_song.config4_patch, _bench_config4_patch,
                    1470 * 30, 1470)}[config]
    got = B.patch_render(port(), total, block, "cpu").numpy()
    state, step = JG.lower(ref(), SR, block)
    step = jax.jit(step)
    want = []
    for i in range(-(-total // block)):
        vals, state = step(state, i * block)
        want.append(np.asarray(vals))
    want = np.concatenate(want)
    assert got.shape == want.shape == (-(-total // block) * block,)
    assert np.abs(want).max() > 0.5
    assert np.abs(got.astype(np.float64) - want).max() <= LSB


# -- (e) the fx ops against the JAX package -----------------------------------

def _jax_fx(name, n):
    return {
        "reverb": lambda f: JF.reverb(f, SR, 0.85, 0.4, 0.35, 0.6, 1.0,
                                      SR // 2)[:n],
        "stretch": lambda f: JF.stretch(f, 1.5)[:n],
        "chorus": lambda f: JF.chorus(f, SR, 0.5, 0.002, 0.02, 3, 0.4,
                                      1.0)[:n],
        "hq_resample": lambda f: jax_hq_resample(f, 160, 147, n)[:n],
    }[name]


@pytest.mark.parametrize("name", ["reverb", "stretch", "chorus",
                                  "hq_resample"])
def test_fx_matches_jax(name):
    n = SR // 4
    sig = B.fx_signal(n)
    assert np.array_equal(sig, B.fx_signal(2 * n)[:n])
    got = B.fx_ops(n)[name](torch.from_numpy(sig)).numpy()
    want = np.asarray(jax.jit(_jax_fx(name, n))(sig))
    assert got.dtype == np.int32 and got.shape == (n, 2)
    assert np.abs(want.astype(np.int64)).max() > 1000
    assert _lsb16(got, want) <= BUDGETS[name]


# -- (f)-(h) the program ------------------------------------------------------

def test_tiny_run_gives_every_key(tiny_run):
    rc, line, text = tiny_run
    assert rc == 0 and "FAIL" not in text
    assert line["vs_baseline"] == line["value"] > 0
    assert line["device"] == "cpu" and line["metric"] == \
        "realtime_factor_64voice_stereo_mixdown"
    for key, v in line.items():
        if isinstance(v, (int, float)) and not isinstance(v, bool):
            assert math.isfinite(v), key
    for key in B.RATE_KEYS:
        assert line[key] > 0, key
    for key, sp in line["spread"].items():
        assert sp["min"] <= line[key] <= sp["max"], key
        assert sp["n"] >= 1
    assert line["tf32_capable_kernels"] == []
    assert line["sparse_midi_voices"] == 24
    sections = [ln for ln in text.splitlines() if ln.startswith("[")
                and ln.endswith(")")]
    assert len(sections) == len(B.SECTIONS)


def test_wrong_digest_fails_without_a_number(monkeypatch):
    monkeypatch.setattr(B, "TINY", dataclasses.replace(B.TINY,
                                                       sha256="0" * 64))
    monkeypatch.setattr(B, "SECTIONS", B.SECTIONS[:1])
    rc, line, _ = _json_line(["--device", "cpu", "--tiny"])
    assert rc == 1
    assert "error" in line and "value" not in line
    assert any("sha256" in f for f in line["failed"])


def test_no_card_exits_without_running(monkeypatch):
    def refuse(run):
        raise AssertionError("the bench ran without a card")
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    monkeypatch.setattr(B, "run_bench", refuse)
    rc, line, _ = _json_line([])
    assert rc != 0 and "error" in line and "value" not in line


def test_bench_imports_no_reference():
    """The program names neither jax, the JAX package nor the root bench."""
    tree = ast.parse((ROOT / "synthesizer_tpu_torch" / "bench.py")
                     .read_text())
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            mods = [a.name for a in node.names]
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            mods = [node.module]
        else:
            continue
        assert not [m for m in mods if m.split(".")[0] in
                    ("jax", "synthesizer_tpu", "bench")], mods
