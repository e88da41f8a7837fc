"""The on-card battery (``synthesizer_tpu_torch.gpu_verify``) on the CPU.

- Its oracle copies equal the JAX package's test oracles
  (``tests/test_voicebank.py``) on the same voices, bit for bit, and its
  glide and MIDI twins reproduce the reference battery's checks on the JAX
  package's own renders, with the reference's bounds.
- The port's plain render holds against ``oracle_voice`` for every wave
  (3 LSB, a share over it under 1e-4, as the battery holds the card).
- Each section runs on ``device="cpu"`` at a reduced size with no FAIL,
  and every check name of ``TPU_VERIFY.txt`` is present, mapped in the
  module's docstring, or reported ``N/A`` with a reason.
"""

import dataclasses
import re
from pathlib import Path

import numpy as np
import pytest
import torch

import jax  # noqa: F401  (the JAX package below runs on the CPU)

from synthesizer_tpu.models import spec as JS
from synthesizer_tpu.models import voicebank as JV
from synthesizer_tpu_torch import gpu_verify as GV
from synthesizer_tpu_torch.models import voicebank as TV
from test_voicebank import _glide_phase_twin, oracle_voice as ref_oracle

torch.set_num_threads(2)

ROOT = Path(__file__).resolve().parents[1]
SR = 44100
CPU = torch.device("cpu")
WAVES = list(TV.WAVE_IDS)


def _voice(wave, fm, i=1):
    kw = {}
    if wave == "harmonics":
        kw["harmonics"] = (1.0, 0.5, 0.25)
    if wave == "pulse":
        kw["pulse_width"] = 0.3
    if wave in ("white_noise", "pluck"):
        kw["seed"] = 7 + i
    if wave == "pluck":
        kw["damping"] = 1.5
    if wave == "wavetable":
        kw["table"] = tuple(float(x) for x in np.random.default_rng(13)
                            .uniform(-1, 1, 48))
    return JV.Voice(wave=wave, frequency=110.0 * (i + 1) * 1.01,
                    amplitude=0.15, phase=0.1 * i, pan=(i - 1.5) / 2,
                    start=0.002 * i, duration=0.05, attack=0.004,
                    decay=0.01, sustain_level=0.7, release=0.02,
                    fm_frequency=6.0 if fm else 0.0,
                    fm_depth=0.02 if fm else 0.0, **kw)


def _port(v):
    return TV.Voice(**dataclasses.asdict(v))


@pytest.mark.parametrize("fm", [False, True], ids=["plain", "fm"])
@pytest.mark.parametrize("wave", WAVES)
def test_oracle_voice_equals_reference(wave, fm):
    """The battery's oracle_voice on a port Voice == the JAX suite's
    oracle_voice on the same JAX Voice, every wave, with and without FM
    (where the reference's FM twin refuses the wave, so does the copy)."""
    for i in (0, 3):
        v = _voice(wave, fm, i)
        try:
            want = ref_oracle(v, 3000)
        except ValueError as e:
            with pytest.raises(ValueError, match=re.escape(str(e))):
                GV.oracle_voice(_port(v), 3000)
            assert fm and wave == "wavetable"
            return
        got = GV.oracle_voice(_port(v), 3000)
        assert got.dtype == want.dtype == np.float32
        np.testing.assert_array_equal(got, want)
    # the FM twin, like the reference's, draws the wave without its
    # harmonics table: a harmonics voice with FM is silent in both
    assert (np.abs(got).max() > 0.01) != (fm and wave == "harmonics")


@pytest.mark.parametrize("case", [(880.0, 220.0, 0.05, 0.01),
                                  (220.0, 1760.0, 0.2, 0.0),
                                  (440.0, 430.0, 0.001, 0.3)])
def test_glide_twin_equals_reference(case):
    f, f0, gt, st = case
    want = _glide_phase_twin(f, f0, gt, st, SR, 20000)
    np.testing.assert_array_equal(
        GV.glide_phase_twin(f, f0, gt, st, SR, 20000), want)


def _jax_render(voices, total, nh=0, chunk=2048):
    vp, layout = JV.pack_voices(voices, SR, num_harmonics=nh,
                                sort_by_wave=True)
    bank = JV.VoiceBank.for_voices(voices, SR, chunk_frames=chunk,
                                   num_harmonics=nh, layout=layout,
                                   nvoices=layout.nvoices)
    return np.asarray(bank.render_song(vp, total))[:, 0]


def test_bend_twin_on_the_reference():
    """The pitch-bend twin from the port's segments equals the one from the
    JAX package's, and holds the JAX render within the reference's 1e-6."""
    curve = ((0.0, 1.0), (0.05, 2.0 ** (2 / 12)), (0.12, 2.0 ** (-1 / 12)))
    tseg = TV.compile_pitch_segments(curve, 440.0, SR)
    jseg = JV.compile_pitch_segments(curve, 440.0, SR)
    for a, b in zip(tseg, jseg):
        np.testing.assert_array_equal(np.asarray(a), np.asarray(b))
    total, s0 = int(0.35 * SR), int(0.01 * SR)
    phs = GV.bend_phase_twin(tseg[0], tseg[2], tseg[3], total - s0)
    out = _jax_render([JV.Voice(
        wave="sine", frequency=440.0, pitch_curve=curve, start=0.01,
        duration=0.3, amplitude=0.5, attack=0.0, decay=0.0,
        sustain_level=1.0, release=0.01)], total)
    lo, hi = s0 + 10, s0 + int(0.29 * SR)
    ref = 0.5 * np.sin(2 * np.pi * np.asarray(
        phs[lo - s0:hi - s0], np.float64) / 2 ** 32)
    assert np.max(np.abs(out[lo:hi] - ref)) < 1e-6


def test_amp_and_vibrato_twins_on_the_reference():
    """The amplitude-curve and CC1-vibrato twins hold the JAX package's
    renders within the reference battery's bounds (1 LSB, 8e-6)."""
    s0 = int(0.01 * SR)
    inc = int(JS.phase_increment(440.0, SR))
    acurve = ((0.0, 1.0), (0.05, 0.2), (0.1, 0.6))
    atotal = int(0.3 * SR)
    aout = _jax_render([JV.Voice(
        wave="sine", frequency=440.0, amp_curve=acurve, start=0.01,
        duration=0.25, amplitude=0.5, attack=0.0, decay=0.0,
        sustain_level=1.0, release=0.01)], atotal)
    aph = (np.arange(atotal, dtype=np.uint64) * inc) % 2 ** 32
    aref = 0.5 * np.sin(2 * np.pi * aph / 2 ** 32) * GV.amp_curve_gain(
        [(int(t * SR), g) for t, g in acurve], s0, atotal)
    lo, hi = s0 + 10, s0 + int(0.24 * SR)
    assert GV.max_lsb(aout[lo:hi], aref[lo:hi]).max() <= 1

    dcurve = ((0.0, 0.0), (0.04, 0.02), (0.1, 0.005), (0.18, 0.029))
    dout = _jax_render([JV.Voice(
        wave="sine", frequency=440.0, fm_frequency=5.5,
        fm_depth_curve=dcurve, start=0.01, duration=0.25, amplitude=0.5,
        attack=0.0, decay=0.0, sustain_level=1.0, release=0.01)],
        int(0.3 * SR))
    dhi = s0 + int(0.24 * SR)
    dref = GV.vibrato_twin(inc, int(JS.phase_increment(5.5, SR)),
                           [(int(t * SR), d) for t, d in dcurve], s0, dhi,
                           lfo_from_start=True)
    assert np.max(np.abs(dout[s0 + 1:dhi] - dref[s0 + 1:dhi])) < 8e-6


def test_depth_at_matches_the_reference_forms():
    """depth_at is the reference battery's _depth_at, and with
    clamp_before its _pdepth (the first value before the first point)."""
    pts = [(100, 0.0), (300, 0.02), (700, 0.005)]
    assert GV.depth_at(pts, 50) == pytest.approx(0.0 - 0.02 * 50 / 200)
    assert GV.depth_at(pts, 50, clamp_before=True) == 0.0
    assert GV.depth_at(pts, 200) == pytest.approx(0.01)
    assert GV.depth_at(pts, 500) == pytest.approx(0.0125)
    assert GV.depth_at(pts, 900) == 0.005


@pytest.mark.parametrize("wave", WAVES)
def test_plain_render_vs_oracle_voice(wave):
    """The port's plain render against the oracle, per wave (half the
    voices with FM where the wave allows it): the battery's 3 LSB bound,
    a share over it under 1e-4."""
    fm_ok = wave in ("sine", "triangle")
    voices = [_port(_voice(wave, fm_ok and i % 2, i)) for i in range(4)]
    got, plain = GV._kernel_and_plain(voices, CPU, 4096)
    np.testing.assert_array_equal(got, plain)
    want = sum(GV.oracle_voice(v, 4096) for v in voices)
    d = GV.max_lsb(got, want)
    assert (d > 3).mean() < 1e-4 and np.abs(want).max() > 0.05


#: each section at a reduced size on the CPU
SECTIONS = {
    "graph": lambda check: GV.section_graph(CPU, check, n=SR // 8,
                                            blocksize=2048),
    "bank": lambda check: GV.section_bank(CPU, check, n=2048,
                                          sparse_voices=24),
    "configs": lambda check: GV.section_configs(CPU, check),
    "effects": lambda check: GV.section_effects(CPU, check),
}


@pytest.fixture(scope="module")
def results():
    """{section: [(name, ok, detail), ...]}, filled by the section tests
    (and by the coverage test for any section not run before it)."""
    return {}


def _run(section, results):
    if section not in results:
        rows = []
        SECTIONS[section](lambda name, ok, detail="":
                          rows.append((name, ok, detail)))
        results[section] = rows
    return results[section]


@pytest.mark.parametrize("section", list(SECTIONS))
def test_section_passes_on_cpu(section, results):
    rows = _run(section, results)
    assert len(rows) >= 12
    failed = [(n, d) for n, ok, d in rows if ok is not None and not ok]
    assert not failed
    for name, ok, detail in rows:
        assert ok is not False and detail, name
    na = [n for n, ok, _ in rows if ok is None]
    assert na == (["fx/chorus_banded_vs_gather"] if section == "effects"
                  else [])


def test_every_tpu_verify_name_is_covered(results):
    """Each check of TPU_VERIFY.txt runs under its own name, or under the
    name the docstring's table maps it to, or prints N/A."""
    ref = [line.split()[1] for line in
           (ROOT / "TPU_VERIFY.txt").read_text().splitlines()
           if line.startswith(("PASS", "FAIL"))]
    assert len(ref) == 147
    ours = {n for s in SECTIONS for n, _, _ in _run(s, results)}
    table = {}
    for left, right in re.findall(r"``([a-z0-9_/<>]+)``\s+``([a-z0-9_/<>]+)``",
                                  GV.__doc__):
        table[left] = right
    table["fx/chorus_banded_vs_gather"] = "fx/chorus_banded_vs_gather"
    missing = []
    for name in ref:
        wave = re.match(r"bank/([a-z_]+)/xla_vs_pallas_compiled$", name)
        key = "bank/<wave>/xla_vs_pallas_compiled" if wave else name
        mapped = table.get(key, name)
        if wave:
            mapped = mapped.replace("<wave>", wave.group(1))
        if mapped not in ours:
            missing.append((name, mapped))
    assert not missing
    assert len(ours) == len(ref)


def test_main_needs_a_card(monkeypatch, capsys):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    assert GV.main([]) == 2
    assert "no CUDA device" in capsys.readouterr().out


def test_main_reports_and_fails(monkeypatch, capsys):
    """main prints one line per check, the largest LSB per section, the
    wall time with the device line, and exits 1 on any FAIL."""
    def good(device, check):
        check("x/one", True, "max 3 LSB")
        check("x/skip", None, "a reason")

    def bad(device, check):
        check("y/two", False, "max 9 LSB")
    monkeypatch.setattr(GV, "SECTIONS", (("graph", good), ("bank", bad)))
    assert GV.main(["--device", "cpu"]) == 1
    out = capsys.readouterr().out.splitlines()
    assert out[0] == "cpu"
    assert "PASS  x/one  max 3 LSB" in out and "N/A   x/skip  a reason" in out
    assert "largest LSB per section: graph 3, bank 9" in out
    assert out[-1] == "FAILURES: ['y/two']"
    monkeypatch.setattr(GV, "SECTIONS", (("graph", good), ("bank", bad)))
    assert GV.main(["--device", "cpu", "--fast"]) == 0
    assert capsys.readouterr().out.splitlines()[-1] == "ALL PASS"
