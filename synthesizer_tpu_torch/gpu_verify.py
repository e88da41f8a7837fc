"""On-card fidelity battery: holds the port on the GPU against the numpy
oracles directly.

    python3 -m synthesizer_tpu_torch.gpu_verify [--device cuda|cpu] [--fast]

The CPU tests hold the port's plain versions against the JAX package, and
``chip_smoke.py`` holds each kernel against its plain version on the card.
This battery closes the chain: every result it checks is computed on the
card and compared with ``goldref`` (or a numpy / Python-int twin), so a
Hopper trap -- TF32 in a convolution, an FMA contraction that breaks the
float-float error-free transforms, a division turned into a reciprocal
multiply, cuFFT's rounding -- shows here even where the CPU suite cannot
see it.  It is the counterpart of ``scripts/tpu_verify.py`` and keeps its
checks and bounds, in four sections:

  A. ``section_graph``: every waveform x {plain, fm, adsr, echo} (+ PWM on
     pulse) through ``models.graph`` against ``goldref.osc.render_oracle``;
  B. ``section_bank``: every bank waveform, the render kernel against its
     plain version (bit-exact) and against the per-voice oracle; glide,
     pluck, the MIDI curves against their integer / f64 twins; the sparse
     render against the flat one; the wavetable gather;
  C. ``section_configs``: biquads against a sequential f64 oracle and the
     five configs of ``BASELINE.json``;
  D. ``section_effects``: the effects rack against ``goldref.effects``,
     streaming == offline, the float-float scan and the wide ratecv.

It runs on ``cuda``; without a card it exits 2 unless ``--device cpu`` is
given (the battery's self-check: there is no quiet fallback).  It prints
one ``PASS`` / ``FAIL`` (or ``N/A``) line per check, then the wall time and
the card's name and power limit, and exits nonzero on any failure.  Each
section is a function of ``(device, check)``, ``check(name, ok, detail)``
with ``ok`` None for a check the port cannot run (``N/A``, the reason in
``detail``), so that ``chip_smoke.py`` can run it under its own checks.

Names.  Every check of ``TPU_VERIFY.txt`` runs here under its own name,
except these, which the port maps or cannot run:

=========================================  ===================================
``TPU_VERIFY.txt``                         here
=========================================  ===================================
``bank/<wave>/xla_vs_pallas_compiled``     ``bank/<wave>/kernel_vs_plain``:
                                           ``render_stereo`` against
                                           ``render_stereo_reference`` on the
                                           same device, bit-exact (the
                                           reference allows 1e-4)
``bank/glide/xla_vs_int_twin``             ``bank/glide/plain_vs_int_twin``
``bank/glide/pallas_vs_int_twin``          ``bank/glide/kernel_vs_int_twin``
``pallas/wavetable_gather_probe``          ``kernel/wavetable_gather``: the
                                           kernel's wavetable voices equal
                                           ``np.take_along_axis`` of their
                                           tables at the kernel's indices
                                           (the Mosaic tripwire means nothing
                                           on the card: the gather is wave 11
                                           of ``voicebank_render.cu``)
``fx/chorus_banded_vs_gather``             ``N/A``: the banded chorus is a
                                           TPU layout
                                           (``CHORUS_BANDED_MAX_TAPS``); the
                                           port has one chorus program, held
                                           by ``fx/chorus_banded_vs_oracle``
                                           on a signal of the same length
=========================================  ===================================

Imports: torch, numpy, this package and ``goldref`` (numpy oracles) only.
The oracle copies below come from the JAX package's test suite and are
held equal to it by ``tests/test_torch_gpu_verify.py``.
"""

from __future__ import annotations

import argparse
import math
import re
import subprocess
import sys
import time

import numpy as np
import torch

import goldref.osc as go

SR = 44100
#: waveforms with an infinite-slope edge: phase rounding puts isolated
#: samples on the other side of the edge (the graph section's budget)
EDGE_KINDS = {"semicircle", "square", "pulse", "square_bl", "sawtooth",
              "sawtooth_bl", "sawtooth_h", "square_h"}
GRAPH_KINDS = ("sine", "triangle", "square", "sawtooth", "pulse",
               "square_h", "sawtooth_h", "harmonics", "white_noise",
               "semicircle", "pointy", "sawtooth_bl", "square_bl",
               "wavetable", "pluck")


def max_lsb(got_f32, want_f32) -> np.ndarray:
    """|int16(got) - int16(want)| per sample, both rounded from f64."""
    g = np.clip(np.rint(np.asarray(got_f32, np.float64) * 32767),
                -32768, 32767)
    w = np.clip(np.rint(np.asarray(want_f32, np.float64) * 32767),
                -32768, 32767)
    return np.abs(g - w)


def _np(t) -> np.ndarray:
    return t.detach().cpu().numpy() if isinstance(t, torch.Tensor) \
        else np.asarray(t)


def _idiff(a, b) -> int:
    """Max |a - b| of two int arrays, 0 for empty ones."""
    d = np.abs(np.asarray(a).astype(np.int64) - np.asarray(b).astype(np.int64))
    return int(d.max()) if d.size else 0


# -- the oracle copies (numpy; from the JAX package's tests) -----------------

def env_args(v, sr: int = SR):
    """(attack, decay, sustain seconds, sustain level, release) of a bank
    voice: the gate is whole frames."""
    gate = int(v.duration * sr) / sr
    sus = max(gate - v.attack - v.decay, 0.0)
    return (v.attack, v.decay, sus, v.sustain_level, v.release)


def env_spec(v, sr: int = SR):
    from .models import spec as S
    a, d, s, sl, r = env_args(v, sr)
    return S.Envelope(S.Const(0.0), a, d, s, sl, r)


def pluck_shim(v, n: int, num_harmonics: int = 4, sr: int = SR) -> np.ndarray:
    """Spec twin of the bank's pluck voice (``goldref/spec.py``): absolute
    DDS phase, decay from the voice's start frame; ``num_harmonics`` is the
    bank's."""
    start = int(v.start * sr)
    K = max(1, num_harmonics)
    inc = int(round(v.frequency / sr * 2 ** 32)) & 0xFFFFFFFF
    ratio = np.float32(np.float32(inc) * np.float32(2.0 ** -32))
    active = [k for k in range(1, K + 1) if inc and k * inc < 2 ** 31]
    u = go.noise_values(np.asarray(active or [1], np.uint32), v.seed)
    denom = np.float32(max(np.abs(u.astype(np.float64)).sum(), 1e-30))
    nn = np.arange(n, dtype=np.int64)
    p0 = int(round((v.phase % 1.0) * 2 ** 32)) & 0xFFFFFFFF
    p = (np.uint64(p0) + nn.astype(np.uint64) * np.uint64(inc)) \
        & np.uint64(0xFFFFFFFF)
    nrel = np.maximum(nn - start, 0).astype(np.float32)
    acc = np.zeros(n, np.float32)
    for j, k in enumerate(active):
        a = np.float32(u[j] / denom)
        phi = go.noise_u32(np.asarray([K + k], np.uint32), v.seed)[0]
        g = np.float32(np.cos(np.float32(np.pi) * np.float32(k) * ratio))
        alpha = np.float32(np.float32(v.damping) * ratio
                           * np.log(max(g, np.float32(1e-30))))
        pk = (p * np.uint64(k) + np.uint64(phi)) & np.uint64(0xFFFFFFFF)
        x = pk.astype(np.uint32).astype(np.float32) * np.float32(2.0 ** -32)
        acc = acc + (a * np.exp(nrel * alpha)
                     * np.sin(np.float32(2 * np.pi) * x).astype(np.float32))
    return (np.float32(v.bias)
            + np.float32(v.amplitude) * acc).astype(np.float32)


def fm_twin(v, n: int, sr: int = SR) -> np.ndarray:
    """f64 closed-form FM phase p_n = p0 + inc*n + inc*d*S_n, the waveform
    through ``goldref.osc``."""
    from .models import spec as S
    inc = S.phase_increment(v.frequency, sr)
    finc = S.phase_increment(v.fm_frequency, sr)
    p0 = S.phase_offset(v.phase)
    fp0 = S.phase_offset(v.fm_phase)
    b = finc / 2 ** 32
    phi = fp0 / 2 ** 32
    k = np.arange(n, dtype=np.float64)
    s_n = ((math.cos(2 * math.pi * phi - math.pi * b)
            - np.cos(2 * np.pi * (b * k + phi) - math.pi * b))
           / (2 * math.sin(math.pi * b)))
    p = (p0 + inc * k + inc * v.fm_depth * s_n) % 2 ** 32
    p_u32 = p.astype(np.uint64).astype(np.uint32)
    node = S.Osc(v.wave, v.frequency, v.amplitude, v.phase, v.bias,
                 pulse_width=v.pulse_width)
    w = go._wave_values(node, p_u32, sr, np.arange(n), None)
    return (np.float32(v.bias) + np.float32(v.amplitude) * w) \
        .astype(np.float32)


def oracle_voice(v, n: int, num_harmonics: int = 4,
                 sr: int = SR) -> np.ndarray:
    """One bank voice -> stereo f32 [n, 2]: the ``goldref`` patch oracle
    (non-FM voices), the f64 FM twin, or the pluck shim, under the bank's
    envelope (shifted to the voice's start frame, zero outside
    [start, start + total)) and pan gains."""
    from .models import spec as S
    start = int(v.start * sr)
    if v.wave == "pluck":
        mono = pluck_shim(v, n, num_harmonics, sr)
    elif v.fm_depth != 0.0:
        mono = fm_twin(v, n, sr)
    else:
        kw = {}
        if v.wave == "pulse":
            kw["pulse_width"] = v.pulse_width
        if v.wave == "harmonics":
            kw["harmonics"] = tuple((float(i + 1), float(a))
                                    for i, a in enumerate(v.harmonics))
        if v.wave == "white_noise":
            kw["seed"] = v.seed
        freq = v.frequency
        if v.wave == "wavetable":
            from .models.voicebank import bank_table
            kw["table"] = tuple(float(x) for x in bank_table(v.table))
            freq = v.frequency or sr
        osc = S.Osc(v.wave, freq, v.amplitude, v.phase, v.bias, **kw)
        mono = go.render_oracle(osc, n, sr)
    g = go.envelope_gains(np.arange(n) - start, sr, env_spec(v, sr))
    mono = (mono * g).astype(np.float32)
    ea = env_args(v, sr)
    total = sum(ea[:3]) + ea[4]
    t = (np.arange(n) - start) / sr
    mono = np.where((t >= 0) & (t < total), mono, 0.0).astype(np.float32)
    lg = np.float32(min(1.0, 1.0 - v.pan))
    rg = np.float32(min(1.0, 1.0 + v.pan))
    return np.stack([mono * lg, mono * rg], axis=1)


def glide_phase_twin(freq, glide_from, glide_time, start, sr, total):
    """Exact Python-int twin of the glide chirp's phase (mod 2^32)."""
    from .models import spec as S
    inc0 = int(S.phase_increment(glide_from, sr))
    inc1 = int(S.phase_increment(freq, sr))
    G = max(1, int(glide_time * sr))
    d = (inc1 - inc0) // G
    m = np.arange(total, dtype=object) - int(start * sr)
    triG = (G * (G - 1)) // 2
    ph = [(inc0 * int(mm) + d * ((int(mm) * (int(mm) - 1)) // 2)) if mm < G
          else (inc0 * G + d * triG + (int(mm) - G) * (inc0 + d * G))
          for mm in m]
    return np.asarray([p % (2 ** 32) for p in ph], np.float64)


def bend_phase_twin(starts, incs, ds, nframes: int) -> list:
    """Per-frame iterative integer DDS through pitch segments: the phase
    at note-relative frames 0..nframes (exact mod 2^32)."""
    phi, out = 0, []
    for m in range(nframes + 1):
        out.append(phi)
        cur = 0
        while cur + 1 < len(starts) and m >= starts[cur + 1]:
            cur += 1
        phi = (phi + incs[cur] + (m - starts[cur]) * ds[cur]) % (2 ** 32)
    return out


def amp_curve_gain(points, s0: int, total: int) -> np.ndarray:
    """f64 linear-ramp twin of an amplitude curve ((frame, gain), ...)
    relative to the note start s0, at absolute frames [0, total)."""
    mm = np.arange(total) - s0
    gain = np.ones(total)
    for j, (f0, g0) in enumerate(points):
        if j + 1 < len(points):
            f1, g1 = points[j + 1]
            sel = (mm >= f0) & (mm < f1)
            gain[sel] = g0 + (mm[sel] - f0) * (g1 - g0) / (f1 - f0)
        else:
            gain[mm >= f0] = g0
    return gain


def depth_at(points, u, clamp_before: bool = False) -> float:
    """A depth curve ((frame, depth), ...) at note-relative frame u,
    linear between points, the last value after them; with
    ``clamp_before`` the first value before the first point."""
    if clamp_before and u <= points[0][0]:
        return points[0][1]
    for j in range(len(points) - 1):
        if u < points[j + 1][0]:
            f0, d0 = points[j]
            f1, d1 = points[j + 1]
            return d0 + (d1 - d0) * (u - f0) / (f1 - f0)
    return points[-1][1]


def vibrato_twin(inc: int, fm_inc: int, points, s0: int, hi: int,
                 lfo_from_start: bool, amplitude: float = 0.5,
                 clamp_before: bool = False) -> np.ndarray:
    """f64 per-frame accumulation twin of a time-varying FM depth: the
    sine at phase n*inc + inc * sum_{k<m} depth(k) sin(lfo_k), frames
    [s0, hi) (zeros before).  The LFO runs from the note start
    (``lfo_from_start``, the CC1 form) or from frame 0 (pressure)."""
    ref = np.zeros(hi)
    acc = 0.0
    for n_ in range(s0, hi):
        m = n_ - s0
        p = ((n_ * inc) % 2 ** 32 + inc * acc) / 2 ** 32
        ref[n_] = amplitude * np.sin(2 * np.pi * (p % 1.0))
        lfo = (((s0 + m) if lfo_from_start else n_) * fm_inc) % 2 ** 32
        acc += depth_at(points, m, clamp_before) * np.sin(
            2 * np.pi * lfo / 2 ** 32)
    return ref


# -- section A: graph engine per waveform ------------------------------------

def section_graph(device, check, n: int = SR // 4, blocksize: int = 4096):
    from .models import graph as G
    from .models import spec as S

    def osc(kind, **over):
        kw = dict(amplitude=0.8, phase=0.13, bias=0.01)
        if kind in ("square_h", "sawtooth_h"):
            kw["num_harmonics"] = 8
        if kind == "harmonics":
            kw["harmonics"] = ((1.0, 1.0), (2.0, 0.5), (3.0, 0.25),
                               (5.0, 0.1))
        if kind == "pulse":
            kw["pulse_width"] = 0.3
        if kind == "white_noise":
            kw["seed"] = 42
        if kind == "wavetable":
            rng = np.random.default_rng(7)
            kw["table"] = tuple(float(x) for x in rng.uniform(-1, 1, 64))
        if kind == "pluck":
            kw["num_harmonics"] = 12
            kw["seed"] = 5
        kw.update(over)
        freq = SR if kind == "white_noise" else 440.0
        return S.Osc(kind, freq, **kw)

    for kind in GRAPH_KINDS:
        variants = {"plain": osc(kind)}
        if kind != "white_noise":
            variants["fm"] = osc(kind, fm_lfo=S.Osc("sine", 6.0, 0.015))
        variants["adsr"] = S.Envelope(osc(kind), 0.01, 0.03, 0.08, 0.6, 0.05)
        variants["echo"] = S.Echo(
            S.Envelope(osc(kind), 0.0, 0.0, 0.05, 1.0, 0.01),
            0.02, 3, 0.03, 0.5)
        if kind == "pulse":
            variants["pwm"] = osc(kind, pwm_lfo=S.Osc(
                "sine", 3.0, amplitude=0.2, bias=0.5))
        for vn, node in variants.items():
            want = go.render_oracle(node, n, SR)
            got = _np(G.render_patch(node, n, SR, blocksize, device=device))
            d = max_lsb(got, want)
            if kind in EDGE_KINDS:
                # isolated edge samples may land on the other side of a
                # discontinuity; everything else must hold 1 LSB
                ok = (d > 1).mean() < 2e-3 and d.max() <= 2 * 32767 * 0.82
                detail = f"max {d.max():.0f} LSB, frac>1 {(d > 1).mean():.1e}"
            else:
                ok = d.max() <= 1
                detail = f"max {d.max():.0f} LSB"
            check(f"graph/{kind}/{vn}", ok, detail)


# -- section B: the voice bank, kernel vs plain vs oracle ---------------------

def _bank(voices, device, nh: int, chunk: int):
    from .models.voicebank import VoiceBank, pack_voices
    vp, layout = pack_voices(voices, SR, num_harmonics=nh, sort_by_wave=True,
                             device=device)
    bank = VoiceBank.for_voices(voices, SR, chunk_frames=chunk,
                                num_harmonics=nh, layout=layout,
                                nvoices=layout.nvoices, device=device)
    return bank, vp


def _kernel_and_plain(voices, device, total: int, nh: int = 4,
                      chunk: int = 1024):
    """The bank's render (the kernel on a card) and its plain version on
    the same device -> two f32 [total, 2] arrays."""
    from .ops import kernels as K
    bank, vp = _bank(voices, device, nh, chunk)
    kern = bank.render_song(vp, total)
    plain = K.render_stereo_reference(
        vp, 0, nframes=total, samplerate=SR, layout=bank._kernel_layout(vp),
        **bank._flags())
    return _np(kern), _np(plain)


def section_bank(device, check, n: int = 4096, sparse_voices: int = 48):
    from .midi import (VIBRATO_RATE_HZ, MidiNote, midi_to_voices, parse_midi,
                       render_notes, write_midi)
    from .models import spec as Spec
    from .models.voicebank import Voice, WAVE_IDS, compile_pitch_segments
    from .sequencer import SynthDef

    for wave in WAVE_IDS:
        kw = {}
        if wave == "harmonics":
            kw["harmonics"] = (1.0, 0.5, 0.25)
        if wave == "pulse":
            kw["pulse_width"] = 0.3
        if wave == "white_noise":
            kw["seed"] = 7
        if wave == "wavetable":
            rngw = np.random.default_rng(13)
            kw["table"] = tuple(float(x) for x in rngw.uniform(-1, 1, 48))
        if wave == "pluck":
            kw["seed"] = 21
            kw["damping"] = 1.5
        fm_ok = wave in ("sine", "triangle")
        voices = [Voice(
            wave=wave, frequency=110.0 * (i + 1) * 1.01,
            amplitude=0.15, phase=0.1 * i, pan=(i - 1.5) / 2,
            start=0.002 * i, duration=0.05,
            attack=0.004, decay=0.01, sustain_level=0.7, release=0.02,
            fm_frequency=6.0 if (fm_ok and i % 2) else 0.0,
            fm_depth=0.02 if (fm_ok and i % 2) else 0.0, **kw)
            for i in range(4)]
        got, plain = _kernel_and_plain(voices, device, n)
        dd = float(np.abs(got - plain).max())
        check(f"bank/{wave}/kernel_vs_plain", np.array_equal(got, plain),
              f"max f32 diff {dd:.2e} (bit-exact required)")
        want = np.zeros((n, 2), np.float32)
        for v in voices:
            want = want + oracle_voice(v, n)
        d = max_lsb(got, want)
        tol = 3
        check(f"bank/{wave}/vs_oracle", (d > tol).mean() < 1e-4,
              f"max {d.max():.0f} LSB, frac>tol {(d > tol).mean():.1e}")

    # portamento: the integer-chirp glide phase must match the exact
    # Python-int twin in the kernel and in the plain version (the tri(m)
    # halving relies on modular u32 multiply semantics)
    gv = [Voice(wave="sine", frequency=880.0, glide_from=220.0,
                glide_time=0.05, start=0.01, duration=0.3, amplitude=0.5,
                attack=0.0, decay=0.0, sustain_level=1.0, release=0.01)]
    total = int(0.35 * SR)
    gk, gp = _kernel_and_plain(gv, device, total)
    ph = glide_phase_twin(880.0, 220.0, 0.05, 0.01, SR, total)
    ref = 0.5 * np.sin(2 * np.pi * ph / 2 ** 32)
    s0 = int(0.01 * SR)
    lo, hi = s0 + 100, s0 + int(0.29 * SR)
    dp = np.max(np.abs(gp[lo:hi, 0] - ref[lo:hi]))
    dk = np.max(np.abs(gk[lo:hi, 0] - ref[lo:hi]))
    check("bank/glide/plain_vs_int_twin", dp < 1e-6, f"max {dp:.2e}")
    check("bank/glide/kernel_vs_int_twin", dk < 1e-6, f"max {dk:.2e}")

    # glide + polyBLEP: the antialiasing dt tracks the instantaneous chirp
    # increment; kernel and plain version within the 1-LSB contract
    bv = [Voice(wave=w, frequency=1760.0, glide_from=110.0,
                glide_time=0.15, start=0.005, duration=0.2, amplitude=0.4)
          for w in ("sawtooth_bl", "square_bl")]
    ba, bb = _kernel_and_plain(bv, device, SR // 4, nh=0)
    dblep = max_lsb(ba, bb).max()
    check("bank/glide/blep_inst_dt_parity", dblep <= 1,
          f"max {dblep:.0f} LSB")

    # glide excludes pluck (its spectral decay is pinned to one pitch):
    # glided pluck == plain pluck bit-exactly, in both
    pv = dict(wave="pluck", frequency=440.0, start=0.005, duration=0.3,
              amplitude=0.5, seed=7)
    gk_, gp_ = _kernel_and_plain([Voice(glide_from=110.0, glide_time=0.05,
                                        **pv)], device, 8192, nh=8)
    nk_, np_ = _kernel_and_plain([Voice(**pv)], device, 8192, nh=8)
    eq_k, eq_p = np.array_equal(gk_, nk_), np.array_equal(gp_, np_)
    check("bank/glide/pluck_excluded", eq_k and eq_p,
          f"kernel=={eq_k} plain=={eq_p}")

    # continuous MIDI pitch bend: piecewise integer chirp segments vs the
    # exact per-frame iterative integer DDS twin
    curve = ((0.0, 1.0), (0.05, 2.0 ** (2 / 12)), (0.12, 2.0 ** (-1 / 12)))
    cv = [Voice(wave="sine", frequency=440.0, pitch_curve=curve,
                start=0.01, duration=0.3, amplitude=0.5, attack=0.0,
                decay=0.0, sustain_level=1.0, release=0.01)]
    ctotal = int(0.35 * SR)
    cout = _kernel_and_plain(cv, device, ctotal, nh=0, chunk=2048)[0][:, 0]
    starts, _, incs, ds = compile_pitch_segments(curve, 440.0, SR)
    s0 = int(0.01 * SR)
    phs = bend_phase_twin(starts, incs, ds, ctotal - s0)
    lo, hi = s0 + 10, s0 + int(0.29 * SR)
    cref = 0.5 * np.sin(2 * np.pi * np.asarray(
        phs[lo - s0:hi - s0], np.float64) / 2 ** 32)
    dc = np.max(np.abs(cout[lo:hi] - cref))
    check("midi/bend_curve_vs_int_twin", dc < 1e-6, f"max {dc:.2e}")

    # continuous CC7/CC11 amplitude curve vs the f64 linear-ramp twin
    acurve = ((0.0, 1.0), (0.05, 0.2), (0.1, 0.6))
    av = [Voice(wave="sine", frequency=440.0, amp_curve=acurve, start=0.01,
                duration=0.25, amplitude=0.5, attack=0.0, decay=0.0,
                sustain_level=1.0, release=0.01)]
    atotal = int(0.3 * SR)
    aout = _kernel_and_plain(av, device, atotal, nh=0, chunk=2048)[0][:, 0]
    inc = int(Spec.phase_increment(440.0, SR))
    aph = (np.arange(atotal, dtype=np.uint64) * inc) % 2 ** 32
    gain = amp_curve_gain([(int(t * SR), g) for t, g in acurve], s0, atotal)
    aref = 0.5 * np.sin(2 * np.pi * aph / 2 ** 32) * gain
    alo, ahi = s0 + 10, s0 + int(0.24 * SR)
    da = max_lsb(aout[alo:ahi], aref[alo:ahi]).max()
    check("midi/amp_curve_vs_f64_twin", da <= 1, f"max {da:.0f} LSB")

    # CC1 mod-wheel vibrato: the per-segment weighted-trig-sum closed form
    # vs the f64 per-frame accumulation twin (budget ~0.2 LSB at full
    # scale, 8e-6 at amplitude 0.5)
    dcurve = ((0.0, 0.0), (0.04, 0.02), (0.1, 0.005), (0.18, 0.029))
    dv = [Voice(wave="sine", frequency=440.0, fm_frequency=5.5,
                fm_depth_curve=dcurve, start=0.01, duration=0.25,
                amplitude=0.5, attack=0.0, decay=0.0, sustain_level=1.0,
                release=0.01)]
    dtotal = int(0.3 * SR)
    dout = _kernel_and_plain(dv, device, dtotal, nh=0, chunk=2048)[0][:, 0]
    fm_inc = int(Spec.phase_increment(5.5, SR))
    dhi = s0 + int(0.24 * SR)
    dref = vibrato_twin(inc, fm_inc, [(int(t * SR), d) for t, d in dcurve],
                        s0, dhi, lfo_from_start=True)
    dd = np.max(np.abs(dout[s0 + 1:dhi] - dref[s0 + 1:dhi]))
    check("midi/vibrato_cc1_vs_f64_twin", dd < 8e-6, f"max {dd:.2e}")

    # channel-pressure aftertouch: a pressure-sweep SMF takes the same
    # depth-curve engine end to end (parse -> merge-by-max ->
    # fm_depth_curve -> closed form) through render_notes on the device
    psd = SynthDef(wave="sine", amplitude=0.5, attack=0.0, decay=0.0,
                   sustain_level=1.0, release=0.01)
    pdata = write_midi([MidiNote(0.01, 0.28, 69, 127, 0)],
                       pressures=[(0.05, 0, 20), (0.15, 0, 100),
                                  (0.25, 0, 127)])
    pnotes = parse_midi(pdata)
    pv0 = midi_to_voices(pnotes, instruments={0: psd})[0]
    psmp = render_notes(pnotes, instruments={0: psd}, samplerate=SR,
                        device=device)
    pout = psmp.get_frame_array()[:, 0].astype(np.float64) / 32767.0
    ps0 = int(pv0.start * SR)
    pfm_inc = int(Spec.phase_increment(VIBRATO_RATE_HZ, SR))
    phi_ = ps0 + int(0.26 * SR)
    pref = vibrato_twin(inc, pfm_inc,
                        [(int(t * SR), d) for t, d in pv0.fm_depth_curve],
                        ps0, phi_, lfo_from_start=False, clamp_before=True)
    pdd = np.max(np.abs(pout[ps0 + 1:phi_] - pref[ps0 + 1:phi_]))
    check("midi/aftertouch_pressure_vs_f64_twin",
          pdd < 8e-6 + 0.5 / 32767.0, f"max {pdd:.2e}")

    # sparse bucketed song render: per-chunk active-voice rows + sentinel
    # pad row vs the flat grouped render, within 1 LSB at int16 (the plan
    # must exist: a comparison with the flat route would be vacuous)
    sprng = np.random.default_rng(11)
    spv = []
    st = 0.0
    for i in range(sparse_voices):
        st += float(sprng.uniform(0.02, 0.25))
        spv.append(Voice(
            wave=("sine", "sawtooth_bl", "harmonics")[i % 3],
            frequency=float(sprng.uniform(100, 1500)),
            amplitude=float(sprng.uniform(0.05, 0.2)),
            pan=float(sprng.uniform(-1, 1)), start=round(st, 3),
            duration=float(sprng.uniform(0.05, 0.4)), attack=0.005,
            decay=0.05, sustain_level=0.7, release=0.1,
            harmonics=(1.0, 0.5, 0.25) if i % 3 == 2 else ()))
    sbank, svp = _bank(spv, device, 8, 4096)
    stot = int((st + 1.0) * SR)
    splan = sbank.sparse_plan(svp, stot)
    sflat = _np(sbank.to_int16(sbank.render_song(svp, stot)))
    ssp = _np(sbank.to_int16(sbank.render_song_sparse(svp, stot)))
    sd = _idiff(sflat, ssp)
    check("bank/sparse_bucketed_vs_flat", splan is not None and sd <= 1
          and int(np.abs(sflat.astype(np.int64)).max()) > 1000,
          f"max {sd} LSB (budget 1), "
          f"K={0 if splan is None else splan[1].shape[1]}")

    wavetable_gather(device, check)


def wavetable_gather(device, check, nvoices: int = 8, n: int = 4096):
    """``kernel/wavetable_gather``: the kernel's per-voice table gather.
    Each voice's increment and phase are multiples of 2^24, so every frame
    reads one table entry exactly (no interpolation) at index p >> 24; one
    bus per voice (``render_song_grouped``) keeps the voices apart, and
    amplitude 1, pan 0 and a flat envelope pass the value through
    unchanged."""
    from .models.voicebank import BANK_TABLE_LEN, Voice
    rng = np.random.default_rng(5)
    tables = rng.standard_normal((nvoices, BANK_TABLE_LEN)).astype(np.float32)
    voices = [Voice(wave="wavetable",
                    frequency=(3 + 5 * i) * SR / BANK_TABLE_LEN,
                    phase=(17 * i % BANK_TABLE_LEN) / BANK_TABLE_LEN,
                    amplitude=1.0, table=tuple(float(x) for x in tables[i]),
                    start=0.0, duration=n / SR + 1.0, attack=0.0, decay=0.0,
                    sustain_level=1.0, release=0.01)
              for i in range(nvoices)]
    bank, vp = _bank(voices, device, 0, n)
    V = vp.wave.shape[0]
    seg = torch.arange(V, dtype=torch.int32, device=vp.device)
    out = _np(bank.render_song_grouped(vp, seg, V, n))[:, :nvoices]
    inc = _np(vp.base_inc)[:nvoices].astype(np.uint64)
    p0 = _np(vp.phase0)[:nvoices].astype(np.uint64)
    frames = np.arange(n, dtype=np.uint64)
    p = (p0[:, None] + frames[None, :] * inc[:, None]) & np.uint64(0xFFFFFFFF)
    idx = (p >> np.uint64(24)).astype(np.int64)
    want = np.take_along_axis(_np(vp.table)[:nvoices], idx, axis=1).T
    exact = (np.array_equal(out[:, :, 0], want)
             and np.array_equal(out[:, :, 1], want))
    check("kernel/wavetable_gather", exact,
          f"{nvoices} voices x {n} frames == np.take_along_axis of the "
          f"tables at p >> 24" + ("" if exact else ": DIFFERS"))


# -- section C: filters and the five BASELINE configs -------------------------

def section_configs(device, check):
    import goldref.sample as gs
    from .models import graph as G
    from .models import spec as S
    from .models.voicebank import Voice
    from .ops.hits import _mixdown_kernel
    from .sample import Sample
    from .sequencer import Song, SynthDef
    from .synth import WaveSynth

    # biquad filters: the parallel scan vs the sequential f64 oracle
    fsrc = S.Osc("sawtooth", 330.0, 0.8)
    for kind, fc, q, tol in [("lowpass", 1000.0, 0.7071, 2),
                             ("lowpass", 500.0, 8.0, 24),
                             ("highpass", 300.0, 0.7071, 16),
                             ("bandpass", 800.0, 4.0, 3)]:
        fnode = S.Biquad(fsrc, kind, fc, q)
        want = go.render_oracle(fnode, SR // 4, SR)
        got = _np(G.render_patch(fnode, SR // 4, SR, 2048, device=device))
        d = max_lsb(got, want)
        check(f"filter/{kind}_q{q}", d.max() <= tol, f"max {d.max():.0f} LSB")
    swept = S.Biquad(fsrc, "lowpass", 800.0, 1.0,
                     cutoff_lfo=S.Osc("sine", 0.5, amplitude=2.0))
    want = go.render_oracle(swept, SR // 4, SR)
    got = _np(G.render_patch(swept, SR // 4, SR, 2048, device=device))
    d = max_lsb(got, want)
    check("filter/lowpass_swept", d.max() <= 6, f"max {d.max():.0f} LSB")

    # config 1: 2 s 440 Hz sine -> 16-bit mono
    node = S.Osc("sine", 440.0, 0.9999)
    want = go.to_int_samples(go.render_oracle(node, 2 * SR, SR), 2)
    got = _np(G.to_int_device(G.render_patch(node, 2 * SR, SR, 32768,
                                             device=device), 2))
    d = _idiff(got, want)
    check("config1/sine_2s", d <= 1, f"max {d} LSB")

    # config 2: 8-voice FM + harmonics + ADSR bank -> stereo
    voices = []
    for i in range(8):
        fm = i % 2 == 0
        voices.append(Voice(
            wave="harmonics" if i % 4 == 3 else "sine",
            frequency=220.0 * 2 ** (i / 12), amplitude=0.1,
            pan=(i - 3.5) / 4, start=0.01 * i, duration=0.4,
            attack=0.01, decay=0.05, sustain_level=0.7, release=0.1,
            fm_frequency=5.0 if fm else 0.0, fm_depth=0.02 if fm else 0.0,
            harmonics=(1.0, 0.5, 0.33) if i % 4 == 3 else ()))
    n = SR // 2
    got = _kernel_and_plain(voices, device, n, nh=4, chunk=4096)[0]
    want = np.zeros((n, 2), np.float32)
    for v in voices:
        want = want + oracle_voice(v, n)
    d = max_lsb(got, want)
    check("config2/fm_bank_8v", (d > 3).mean() < 1e-4,
          f"max {d.max():.0f} LSB, frac>3 {(d > 3).mean():.1e}")

    # config 3: 16-track Sample-op mixdown vs the goldref per-hit loop
    synth = WaveSynth(samplerate=22050, samplewidth=2, device=device)
    total = Sample.from_raw_frames(b"", 2, SR, 2, device=device)
    gtotal = gs.Sample(np.zeros((0, 2), np.int16), SR, 2, 2)
    for t in range(16):
        nd = S.Osc("sine", 100.0 + 50 * t, 0.4)
        s = synth.sine(100.0 + 50 * t, 0.25, amplitude=0.4)
        s.resample(SR).amplify(0.5 + 0.02 * t).fadein(0.02).fadeout(0.05) \
            .stereo()
        total.mix_at(0.05 * t, s)
        ga = go.to_int_samples(go.render_oracle(nd, int(0.25 * 22050),
                                                22050), 2)
        g = gs.Sample(ga[:, None], 22050, 2, 1)
        g.resample(SR).amplify(0.5 + 0.02 * t).fadein(0.02).fadeout(0.05) \
            .stereo()
        gtotal.mix_at(0.05 * t, g)
    d = _idiff(total.get_frame_array(), gtotal.frames)
    check("config3/16track_mixdown", d <= 2, f"max {d} LSB")

    # config 4: LFO-modulated graph + echo at streaming chunk size
    patch = S.Echo(S.AmpMod(S.Osc("sawtooth", 330.0, 0.7,
                                  fm_lfo=S.Osc("sine", 5.0, 0.01)),
                            S.Osc("sine", 2.0, amplitude=0.4, bias=0.6)),
                   0.05, 4, 0.07, 0.6)
    n4 = 1470 * 30
    want = go.render_oracle(patch, n4, SR)
    got = _np(G.render_patch(patch, n4, SR, 1470, device=device))
    d = max_lsb(got, want)
    check("config4/lfo_echo_chunks", (d > 1).mean() < 2e-3 and d.max() <= 3,
          f"max {d.max():.0f} LSB, frac>1 {(d > 1).mean():.1e}")
    whole = _np(G.render_patch(patch, n4, SR, 32768, device=device))
    same = np.array_equal(got, whole)
    check("config4/chunk_invariance", same,
          "1470-frame blocks == 32768-frame blocks bit-exact" if same
          else "DIFFERS")

    # config 5: pattern-sequencer song: the drum scatter vs the per-hit
    # oracle loop, and streaming chunks == the offline slice
    ws = WaveSynth(samplerate=SR, samplewidth=2, device=device)
    kick = ws.sine(60, 0.1, amplitude=0.8).fadeout(0.08).stereo()
    hat = ws.white_noise(duration=0.04, amplitude=0.4, seed=5) \
        .fadeout(0.03).stereo()
    song = Song(device=device)
    song.bpm = 240
    song.ticks = 4
    song.add_instrument("kick", kick)
    song.add_instrument("hat", hat)
    song.add_synth("lead", SynthDef(wave="square_bl", amplitude=0.2,
                                    release=0.05))
    song.add_pattern("a", {"kick": "x... x...", "hat": "x.x. x.x.",
                           "lead": "C4 .. E4 .. G4 .. C5 .."})
    song.pattern_sequence = ["a", "a"]
    off = song.mix(normalize=False).get_frame_array()
    sched = song.compile_schedule()
    # per-hit oracle loop at exact frame offsets
    gout = np.zeros((off.shape[0], 2), np.int64)
    for inst_i, start in sched.hits:
        arr = song.instruments[sched.instruments[inst_i]].get_frame_array()
        m = min(len(arr), len(gout) - start)
        gout[start:start + m] += arr[:m].astype(np.int64)
    gout = np.clip(gout, -2 ** 31, 2 ** 31 - 1)      # the int32 domain
    drums = _np(torch.clamp(_mixdown_kernel(
        torch.from_numpy(sched.bank).to(device),
        torch.from_numpy(sched.hits[:, 0].astype(np.int32)).to(device),
        torch.from_numpy(sched.hits[:, 1].astype(np.int32)).to(device),
        off.shape[0]), -32768, 32767))
    d = _idiff(drums, np.clip(gout, -32768, 32767))
    check("config5/drum_scatter_vs_oracle", d == 0, f"max {d} LSB (int exact)")
    chunks = [c.get_frame_array()
              for c in song.mix_generator(chunk_frames=1470)]
    got_stream = np.concatenate(chunks)
    check("config5/streaming_equals_offline",
          np.array_equal(got_stream, off[:len(got_stream)]),
          f"{len(chunks)} chunks")


# -- section D: the effects rack ----------------------------------------------

def _stream_vs_offline(song, chunk: int = 1470):
    off = song.mix(normalize=False, tail_seconds=0.0).get_frame_array()
    got = np.concatenate([c.get_frame_array()
                          for c in song.mix_generator(chunk_frames=chunk)])
    return off, got


def section_effects(device, check):
    """The effects rack on the device against ``goldref.effects`` with the
    budgets documented there, and streaming == offline of the master and
    track chains (the scans and FFT paths, the recurrences under
    automation, the float-float scan and the wide ratecv)."""
    import goldref.effects as gfx
    import goldref.sample as gs
    from goldref import pcm as gpcm
    from .effects import (StreamingChorus, StreamingCompressor,
                          StreamingLimiter, StreamingPhaser, StreamingReverb,
                          SweptEQBand)
    from .ops import effects as dfx
    from .ops import resample as drs
    from .ops.coeffs import (biquad_coeffs, chorus_inc_grid,
                             chorus_phase_grid, compressor_coeff_grids,
                             curve_grid, ff_split, limiter_ceiling,
                             reverb_feedback_grid)
    from .ops.loudness import StreamingLoudness
    from .sample import Sample
    from .sequencer import Song, SynthDef
    from .synth import WaveSynth

    def dev_t(a):
        return torch.from_numpy(np.ascontiguousarray(a)).to(device)

    rng = np.random.default_rng(0xFACADE)
    a = rng.integers(-15000, 15000, size=(4000, 2)).astype(np.int16)

    def pair():
        return (gs.Sample(a.copy(), SR, 2, 2),
                Sample.from_raw_frames(a.tobytes(), 2, SR, 2, device=device))

    def fx(name, op, budget, gold_op=None, suffix=""):
        gold, dev = pair()
        d = _idiff(op(dev).get_frame_array(), (gold_op or op)(gold).frames)
        check(name, d <= budget, f"max {d} LSB{suffix}")

    fx("fx/compress", lambda s: s.compress(
        threshold_db=-15.0, ratio=4.0, attack=0.003, release=0.08,
        makeup_db=2.0), 2)

    # soft knee: a level ramp through the knee region (the random signal
    # pegs the detector above it, where soft == hard)
    ramp_amp = 10 ** (np.linspace(-40, -2, 8000) / 20.0)
    ramp = (np.sin(2 * np.pi * 220 * np.arange(8000) / SR)
            * ramp_amp * 32767.0).astype(np.int16)
    ramp2 = np.stack([ramp, ramp], axis=1)
    kw = dict(threshold_db=-15.0, ratio=4.0, attack=0.003, release=0.08,
              knee_db=12.0)
    gk = gs.Sample(ramp2.copy(), SR, 2, 2).compress(**kw).frames
    dk = Sample.from_raw_frames(ramp2.tobytes(), 2, SR, 2, device=device) \
        .compress(**kw).get_frame_array()
    d = _idiff(dk, gk)
    check("fx/compress_soft_knee", d <= 2, f"max {d} LSB")

    fx("fx/reverb", lambda s: s.reverb(roomsize=0.8, damping=0.4, wet=0.3,
                                       dry=0.6, tail=0.1), 4)

    # hq polyphase resampler (a TF32 tap sum would show here), up and down
    for outr in (48000, 8000):
        fx(f"fx/hq_resample_{outr}",
           lambda s: s.resample(outr, quality="hq"), 1)

    # the streaming hq twin is bit-identical to the offline op at any
    # chunking, for the heavy downsample at a small and a practical chunk
    rng_s = np.random.default_rng(23)
    xs = rng_s.integers(-32768, 32768, size=(882, 2)).astype(np.int16)
    g_ = math.gcd(SR, 8000)
    Ls, Ms = 8000 // g_, SR // g_
    off_ = _np(drs.hq_resample(dev_t(xs), Ls, Ms,
                               drs.nframes_out(len(xs), Ms, Ls)))
    for ck in (21, 441):
        rs_ = drs.StreamingHQResampler(SR, 8000, nchannels=2, device=device)
        outs_ = []
        for i0 in range(0, len(xs), ck):
            y_, c_ = rs_.push(dev_t(xs[i0:i0 + ck]))
            if c_:
                outs_.append(_np(y_))
        y_, c_ = rs_.flush()
        if c_:
            outs_.append(_np(y_))
        got_ = np.concatenate(outs_)
        check(f"fx/hq_stream_bitexact_chunk{ck}",
              got_.shape == off_.shape and np.array_equal(got_, off_),
              f"{got_.shape[0]} rows vs offline")

    fx("fx/chorus", lambda s: s.chorus(rate=1.5, depth=0.003, delay=0.015), 2)

    # one second of chorus: the reference routes inputs >= 16384 frames to
    # a banded TPU layout; the port has one program for every length
    check("fx/chorus_banded_vs_gather", None,
          "the banded chorus is a TPU layout (CHORUS_BANDED_MAX_TAPS); the "
          "port's chorus has one program at every length, held against the "
          "oracle below")
    ab = rng.integers(-15000, 15000, size=(SR, 2)).astype(np.int16)
    kwb = dict(rate=1.5, depth=0.003, delay=0.015, voices=3,
               wet=0.4, dry=1.0)
    long_ch = _np(dfx.chorus(dev_t(ab), SR, **kwb))
    gref = gs.Sample(ab.copy(), SR, 2, 2).chorus(**kwb).frames
    dgb = _idiff(long_ch, gref)
    check("fx/chorus_banded_vs_oracle", dgb <= 2, f"max {dgb} LSB (1 s)")

    # FFT convolution (cuFFT on the card)
    gold, dev = pair()
    ir = (rng.normal(0, 0.2, size=300)
          * np.exp(-np.arange(300) / 75.0) * 20000).astype(np.int16)[:, None]
    g = gold.convolve(gs.Sample(ir.copy(), SR, 2, 1), wet=0.05, dry=0.5)
    d = _idiff(dev.convolve(Sample.from_raw_frames(ir.tobytes(), 2, SR, 1,
                                                   device=device),
                            wet=0.05, dry=0.5).get_frame_array(), g.frames)
    budget = max(8, 1e-4 * np.abs(g.frames).max())
    check("fx/convolve_fft", d <= budget, f"max {d} LSB (budget {budget:.0f})")

    fx("fx/sample_filter", lambda s: s.filter("lowpass", 900.0, q=2.0), 4)
    fx("fx/gate", lambda s: s.gate(threshold_db=-25.0, range_db=60.0,
                                   attack=0.001, release=0.02), 2)
    # parametric EQ: the low shelf and mid bands run the float-float scan
    fx("fx/eq_three_band", lambda s: s.eq(
        low_db=4.0, mid_db=-6.0, high_db=3.0, mid_freq=900.0, mid_q=1.4), 8,
        suffix=" (ff scan)")

    # BS.1770 loudness and true peak: the EBU 3341 anchor (a -23 dBFS
    # stereo 997 Hz sine reads -23 LUFS) and the f64 oracle
    t = np.arange(SR)
    tone23 = np.rint(10 ** (-23 / 20) * 32767.0
                     * np.sin(2 * np.pi * 997.0 / SR * t)).astype(np.int16)
    st = np.repeat(tone23[:, None], 2, 1)
    dev = Sample.from_raw_frames(st.tobytes(), 2, SR, 2, device=device)
    gold = gs.Sample(st.copy(), SR, 2, 2)
    li, lg = dev.loudness_lufs(), gold.loudness_lufs()
    tp, tg = dev.true_peak_dbtp(), gold.true_peak_dbtp()
    check("fx/loudness_lufs", abs(li + 23.0) < 0.1 and abs(li - lg) < 0.01,
          f"dev {li:.3f} LUFS oracle {lg:.3f}")
    check("fx/true_peak", abs(tp - tg) < 0.01,
          f"dev {tp:.3f} dBTP oracle {tg:.3f}")

    # live loudness meter: chunk-fed StreamingLoudness == the whole-signal
    # stats (the K-weighting biquad state carried across chunks)
    sl = StreamingLoudness(SR, 2)
    for i in range(0, len(st), 4410):
        sl.update(dev_t(st[i:i + 4410]))
    live = sl.stats()
    whole = dev.loudness_stats()
    dmom = abs(live["momentary_max"] - whole["momentary_max"])
    dint = abs(live["integrated"] - whole["integrated"])
    check("fx/live_loudness_meter", dmom < 0.02 and dint < 0.02,
          f"Mmax live {live['momentary_max']:.3f} whole "
          f"{whole['momentary_max']:.3f}, I live {live['integrated']:.3f} "
          f"whole {whole['integrated']:.3f}")

    # phase-vocoder stretch: batched FFT + phase cumsum vs the f64 oracle
    tt = np.arange(9000) / SR
    tone = np.clip(np.rint((0.4 * np.sin(2 * np.pi * 440 * tt)
                            + 0.25 * np.sin(2 * np.pi * 661 * tt)) * 32767),
                   -32768, 32767).astype(np.int16)[:, None]
    g = gs.Sample(tone.copy(), SR, 2, 1).stretch(1.5, frame=1024, hop=256)
    d = _idiff(Sample.from_raw_frames(tone.tobytes(), 2, SR, 1, device=device)
               .stretch(1.5, frame=1024, hop=256).get_frame_array(), g.frames)
    check("fx/stretch_pv", d <= 64, f"max {d} LSB (budget 64)")

    # master [fx] chain: streaming chunk processors == offline ops
    ws = WaveSynth(samplerate=SR, samplewidth=2, device=device)

    def song_of(tracks, sequence=("a", "a"), **sounds):
        """A 240 bpm song of one pattern ``a``: ``sounds`` maps a track to
        a Sample (drums), a SynthDef or a (Sample, keywords) pair (a
        pitched sampler); ``tracks`` maps the track to its line."""
        s = Song(device=device)
        s.bpm = 240
        s.ticks = 4
        for name, snd in sounds.items():
            if isinstance(snd, SynthDef):
                s.add_synth(name, snd)
            elif isinstance(snd, tuple):
                s.add_sampler(name, snd[0], **snd[1])
            else:
                s.add_instrument(name, snd)
        s.add_pattern("a", tracks)
        s.pattern_sequence = list(sequence)
        return s

    song = song_of({"kick": "x.x. x..."}, kick=ws.sine(
        60, 0.1, amplitude=0.8).fadeout(0.08).stereo())
    song.add_fx("chorus", rate=2.0, depth=0.002, delay=0.012, wet=0.4)
    song.add_fx("compress", threshold_db=-15.0, ratio=4.0, attack=0.002,
                release=0.05)
    song.add_fx("reverb", roomsize=0.7, wet=0.3, dry=0.7, tail=0.15)
    off, got = _stream_vs_offline(song)
    d = _idiff(got, off) if len(got) == len(off) else -1
    check("fx/chain_stream_eq_offline", len(got) == len(off) and d <= 8,
          f"max {d} LSB over {len(got)} frames")

    # per-synth-track fx: the grouped render's segment buses and the track
    # chain agree between the offline bus and the streaming processors
    song2 = song_of(
        {"lead": "C4 .. E4 G4 - .. C5 ..", "pad": "C3 - - - G2 - - -",
         "kick": "x.x.x.x."},
        lead=SynthDef(wave="square_bl", amplitude=0.25, attack=0.005,
                      release=0.05, pan=0.2),
        pad=SynthDef(wave="sine", amplitude=0.2, attack=0.02, release=0.1,
                     pan=-0.3),
        kick=ws.sine(60, 0.1, amplitude=0.5).fadeout(0.06).stereo())
    song2.add_track_fx("lead", [("compress", "threshold_db=-18 ratio=4"),
                                ("reverb",
                                 "roomsize=0.6 wet=0.3 dry=0.7 tail=0.15")])
    off2, got2 = _stream_vs_offline(song2)
    d2 = _idiff(got2, off2) if len(got2) == len(off2) else -1
    check("fx/synth_track_stream_eq_offline",
          len(got2) == len(off2) and d2 <= 8,
          f"max {d2} LSB over {len(got2)} frames")

    # the continuation strip: feedback echo, stereo width, lookahead
    # limiter, swept-allpass phaser, each vs its goldref oracle
    fx("fx/feedback_echo", lambda s: s.feedback_echo(
        delay=0.02, feedback=0.55, wet=0.6, dry=0.9), 1)
    fx("fx/stereo_width", lambda s: s.stereo_width(1.7), 1)

    gold, dev = pair()
    kw = dict(ceiling_db=-6.0, release=0.05, lookahead=0.003)
    d = _idiff(dev.limit(**kw).get_frame_array(), gold.limit(**kw).frames)
    peak = int(np.abs(dev.get_frame_array().astype(np.int64)).max())
    check("fx/limiter", d <= 2 and peak <= limiter_ceiling(-6.0, 2),
          f"max {d} LSB, peak {peak}")

    fx("fx/phaser", lambda s: s.phaser(rate=0.8, depth=1.0, min_freq=300.0,
                                       max_freq=3000.0, stages=4), 10,
       suffix=" (budget 2+2*stages)")
    kw = dict(rate=0.8, depth=1.0, min_freq=60.0, max_freq=2000.0,
              stages=4, q=1.0)
    fx("fx/phaser_ff_low_floor", lambda s: s.phaser(**kw), 2,
       gold_op=lambda s: s.phaser(grids_dtype=np.float64, **kw),
       suffix=" (ff scan)")

    # rate/depth-swept phaser: host-mirrored cumulative u32 phase and a
    # per-frame depth grid vs the per-sample oracle
    x = a
    npts = len(x)
    tickf = SR / 8.0
    rate_c = [(0.0, 0.3), (8.0, 5.0)]
    depth_c = [(0.0, 0.2), (8.0, 1.0)]
    kw = dict(rate=0.5, depth=1.0, min_freq=300.0, max_freq=3000.0,
              stages=3, q=0.7071, wet=0.6, dry=0.9)
    proc = StreamingPhaser(SR, 2, rate_curve=rate_c, depth_curve=depth_c,
                           tickf=tickf, device=device, **kw)
    got = _np(proc.process(dev_t(x)))
    P, _ = chorus_phase_grid(
        chorus_inc_grid(curve_grid(rate_c, 0, npts, tickf), SR), 0)
    want = gfx.phaser(x, 2, SR, P=P,
                      depth_curve=curve_grid(depth_c, 0, npts, tickf), **kw)
    d = _idiff(got, want)
    check("fx/phaser_rate_depth_swept", d <= 8, f"max {d} LSB")

    # release-swept limiter: per-element decay through the decaying-max
    # scan vs the oracle
    rel_c = [(0.0, 0.004), (8.0, 0.4)]
    Lh = max(1, int(0.003 * SR))
    proc = StreamingLimiter(SR, 2, ceiling_db=-6.0, lookahead=0.003,
                            release_curve=rel_c, tickf=tickf, device=device)
    got = _np(proc.process(dev_t(np.concatenate(
        [x, np.zeros((Lh, 2), x.dtype)]))))
    want = gfx.limiter(x, 2, SR, ceiling_db=-6.0,
                       release=curve_grid(rel_c, 0, len(x), tickf),
                       lookahead=0.003)
    d = _idiff(got, want)
    check("fx/limiter_release_swept", d <= 2, f"max {d} LSB")

    # LFO gain fx: host grids through the house gain rule, bit-exact
    for name, kw in (("tremolo", dict(rate=5.0, depth=0.7)),
                     ("autopan", dict(rate=2.0, depth=0.9))):
        gold, dev = pair()
        eq = np.array_equal(getattr(dev, name)(**kw).get_frame_array(),
                            getattr(gold, name)(**kw).frames)
        check(f"fx/{name}", eq, "bit-exact")

    song_n = song_of({"kick": "x.x. x..."}, kick=ws.sine(
        60, 0.1, amplitude=0.9).fadeout(0.08).stereo())
    song_n.add_fx("echo", delay=0.09, feedback=0.45, wet=0.4)
    song_n.add_fx("phaser", rate=0.9, depth=1.0, wet=0.5)
    song_n.add_fx("width", amount=1.4)
    song_n.add_fx("limiter", ceiling_db=-2.0, lookahead=0.004)
    song_n.add_automation("fx.echo.wet", "0:0.1 8:0.6")
    song_n.add_automation("fx.limiter.ceiling_db", "0:-1 8:-8")
    offn, gotn = _stream_vs_offline(song_n)
    dn = _idiff(gotn, offn) if len(gotn) == len(offn) else -1
    check("fx/new_strip_stream_eq_offline",
          len(gotn) == len(offn) and dn <= 12,
          f"max {dn} LSB over {len(gotn)} frames")

    # automation: per-hit velocity rint-exact, the master fade bit-equal
    # between the two paths
    song3 = song_of({"kick": "x...x...x...x..."}, ["a"], kick=ws.sine(
        60, 0.08, amplitude=0.6).fadeout(0.05).stereo())
    song3.add_automation("track.kick.volume", "0:1 12:0.25")
    song3.add_automation("master.volume", "0:1 16:0.1")
    off3, got3 = _stream_vs_offline(song3)
    exact = len(got3) == len(off3) and np.array_equal(got3, off3)
    kick = song3.instruments["kick"].get_frame_array().astype(np.float64)
    tickf3 = song3.tick_duration * SR
    s2 = int(8 * tickf3)       # the third hit: velocity 0.5
    vel = np.rint(kick * np.float32(0.5)).astype(np.float32)
    nn = (s2 + np.arange(len(kick))).astype(np.float32)
    gg = np.interp(nn / np.float32(tickf3), [0.0, 16.0], [1.0, 0.1]) \
        .astype(np.float32)
    expect = np.clip(np.rint(vel * gg[:, None]), -32768, 32767)
    d3 = _idiff(off3[s2:s2 + len(kick)], expect)
    check("fx/automation_velocity_and_fade", exact and d3 <= 1,
          f"stream==offline {exact}, hit3 max {d3} LSB")

    # fx.filter.cutoff automation: per-frame coefficients through the
    # companion scan, offline whole-signal vs streaming chunks
    song4 = song_of({"saw": "C3 - - - C3 - - - C3 - - - C3 - - -"}, ["a"],
                    saw=SynthDef(wave="sawtooth_bl", amplitude=0.4,
                                 attack=0.002, release=0.05))
    song4.add_fx("filter", kind="lowpass", cutoff=1000.0, q=2.0)
    song4.add_automation("fx.filter.cutoff", "0:300 8:6000 16:300")
    off4, got4 = _stream_vs_offline(song4)
    d4 = _idiff(got4, off4) if len(got4) == len(off4) else -1
    check("fx/automation_filter_sweep", len(got4) == len(off4) and d4 <= 8,
          f"max {d4} LSB over {len(got4)} frames")

    # pitched sampler tracks: rate-1 passthrough bit-exact, streaming ==
    # offline bit-exact
    gtr = ws.pluck(261.6255653005986, 0.25, amplitude=0.6, seed=3) \
        .fadeout(0.04).stereo()
    pad = ws.sine(261.6255653005986, 0.1, amplitude=0.4).stereo()
    song5 = song_of(
        {"gtr": "C4 .. E4 G4 .. .. C5 C3", "pad": "E3 - - - - - - -"},
        ["a"], gtr=(gtr, dict(base_note="C4")),
        pad=(pad, dict(base_note="C4", loop_start=0.02, loop_end=0.08,
                       release=0.02)))                  # DDS sustain loop
    off5, got5 = _stream_vs_offline(song5)
    solo = song_of({"gtr": "C4 .. .. .. .. .. .. .."}, ["a"],
                   gtr=(gtr, dict(base_note="C4")))
    src = solo.samplers["gtr"].sample.get_frame_array()
    rate1 = solo.mix(normalize=False,
                     tail_seconds=0.0).get_frame_array()[:len(src)]
    se = np.array_equal(got5, off5[:len(got5)])
    r1 = np.array_equal(rate1, src)
    check("fx/sampler_tracks", se and r1,
          f"stream==offline {se}, rate1 passthrough {r1}")

    # recurrence-internal automation: the swept-coefficient compressor,
    # the roomsize-swept reverb and the constant-rate chorus identity
    xa = a[:3000]
    att_c = [(0.0, 0.001), (8.0, 0.05)]
    rel_c = [(0.0, 0.02), (8.0, 0.4)]
    proc = StreamingCompressor(SR, threshold_db=-20.0, ratio=4.0,
                               attack_curve=att_c, release_curve=rel_c,
                               tickf=tickf, device=device)
    got_c = _np(proc.process(dev_t(xa)))
    alpha, decay = compressor_coeff_grids(
        curve_grid(att_c, 0, 3000, tickf),
        curve_grid(rel_c, 0, 3000, tickf), SR)
    lvl = np.max(np.abs(xa.astype(np.float32) / np.float32(32767.0)),
                 axis=1).astype(np.float32)
    gains = gfx.compressor_gains_swept(lvl, alpha, decay, np.float32(-20.0),
                                       np.float32(0.75))
    dc = _idiff(got_c, gfx._gain_floor(xa, gains[:, None], 2))
    check("fx/auto_compress_coeff_grids", dc <= 2, f"max {dc} LSB (budget 2)")

    room_c = [(0.0, 0.2), (8.0, 0.9)]
    procr = StreamingReverb(SR, 2, roomsize=0.5, damping=0.4, wet=0.3,
                            dry=0.7, tail=0.0, roomsize_curve=room_c,
                            tickf=tickf, device=device)
    got_r = _np(procr.process(dev_t(xa)))
    want_r = gfx.reverb(xa, 2, SR, roomsize=0.5, damping=0.4, wet=0.3,
                        dry=0.7, tail_frames=0, feedback_curve=(
                            reverb_feedback_grid(curve_grid(room_c, 0, 3000,
                                                            tickf))))
    dr2 = _idiff(got_r, want_r)
    check("fx/auto_reverb_roomsize", dr2 <= 4, f"max {dr2} LSB (budget 4)")

    ckw = dict(rate=1.5, depth=0.002, delay=0.012, voices=3, wet=0.5,
               dry=0.9, device=device)
    yc = _np(StreamingChorus(SR, 2, rate_curve=[(0.0, 1.5)], tickf=tickf,
                             **ckw).process(dev_t(xa)))
    ys = _np(StreamingChorus(SR, 2, **ckw).process(dev_t(xa)))
    check("fx/auto_chorus_const_rate_exact", np.array_equal(yc, ys),
          "P_n == n*inc identity")

    # swept EQ band: per-frame RBJ coefficient grids through the companion
    # scan (the float-float one where the band needs it) vs the oracle
    gain_c = [(0.0, -10.0), (8.0, 8.0)]
    pe = SweptEQBand(SR, 2, "peaking", 1500.0, 1.2, gain_c, tickf,
                     device=device)
    got_e = _np(pe.process(dev_t(xa)))
    want_e = gfx.eq_swept(xa, 2, SR, "peaking", 1500.0, 1.2,
                          curve_grid(gain_c, 0, len(xa), tickf),
                          grids_dtype=np.float64 if pe._ff else None)
    de = _idiff(got_e, want_e)
    check("fx/auto_eq_gain_grids", de <= 4, f"max {de} LSB (budget 4)")

    # the float-float compensated scan on the card: Dekker/Knuth EFTs
    # assume exact IEEE f32 add and mul, which an FMA contraction breaks.
    # Pathological high-pass (Q=30 at 40 Hz): the plain scan drifts far
    # from the f64 oracle, the ff path must stay within 2 LSB
    co_ff = biquad_coeffs("highpass", 40.0, 30.0, SR)
    xs32 = xa.astype(np.float32) / np.float32(32767.0)
    b0, b1, b2, a1, a2 = (np.float64(c) for c in co_ff)
    sd = xs32.astype(np.float64)
    outd = np.empty_like(sd)
    for ch in range(2):
        x1 = x2 = y1 = y2 = 0.0
        v = sd[:, ch]
        for i in range(len(v)):
            yv = b0 * v[i] + b1 * x1 + b2 * x2 - a1 * y1 - a2 * y2
            x2, x1 = x1, v[i]
            y2, y1 = y1, yv
            outd[i, ch] = yv
    want_ff = np.rint(np.clip(outd * 32767, -32768, 32767))

    def lsb_ff(y):
        return np.abs(np.rint(np.clip(_np(y).astype(np.float64) * 32767,
                                      -32768, 32767)) - want_ff).max()

    d_plain = lsb_ff(dfx.biquad_apply(dev_t(xs32), co_ff)[0])
    d_ff = lsb_ff(dfx.biquad_apply_ff(dev_t(xs32),
                                      tuple(ff_split(c) for c in co_ff))[0])
    check("fx/ff_scan_eft_on_hw", d_ff <= 2 and d_plain > 100,
          f"ff {d_ff:.0f} LSB vs f64 oracle (plain {d_plain:.0f})")

    # the general wide-division ratecv: reduced rates at full int32 range,
    # bit-exact vs the int64 oracle (audioop's rule)
    xr = rng.integers(-2 ** 31, 2 ** 31, size=(400, 2),
                      dtype=np.int64).astype(np.int32)
    xr[0] = (-2 ** 31, 2 ** 31 - 1)
    yw, stw = drs.resample(xr, 44100, 96001, width=4, device=device)
    wb, wst = gpcm.ratecv(gpcm.tobytes(xr.reshape(-1), 4), 4, 2,
                          44100, 96001, None)
    wantw = gpcm.frombytes(wb, 4).reshape(-1, 2)
    check("fx/ratecv_wide_division",
          np.array_equal(yw, wantw) and stw.to_audioop(4) == wst,
          f"{len(wantw)} frames, width 4, reduced outr 96001")


SECTIONS = (("graph", section_graph), ("bank", section_bank),
            ("configs", section_configs), ("effects", section_effects))


def card_line() -> str:
    """The card's name and power limit as nvidia-smi prints them."""
    try:
        out = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True, text=True,
            timeout=60).stdout.strip().splitlines()
    except (OSError, subprocess.SubprocessError) as e:
        return f"nvidia-smi: {type(e).__name__}"
    return out[0] if out else "nvidia-smi: no output"


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--device", default="cuda", choices=("cuda", "cpu"),
                    help="where the port runs (default: the card; cpu is "
                         "the battery's self-check)")
    ap.add_argument("--fast", action="store_true",
                    help="skip section B (the bank) for quick iteration")
    args = ap.parse_args(argv)
    if args.device == "cuda" and not torch.cuda.is_available():
        print("ERROR: no CUDA device; the battery runs on the card "
              "(--device cpu for its self-check)")
        return 2
    device = torch.device(args.device)
    card = card_line() if device.type == "cuda" else "cpu"
    print(card, flush=True)
    if device.type == "cuda":
        print(f"device: {torch.cuda.get_device_name(0)}, torch "
              f"{torch.__version__}, CUDA {torch.version.cuda}", flush=True)
    failures, worst = [], {}

    def check(name, ok, detail=""):
        word = "N/A " if ok is None else "PASS" if ok else "FAIL"
        print(f"{word}  {name}  {detail}", flush=True)
        if ok is not None and not ok:
            failures.append(name)
        found = re.search(r"max (\d+) LSB", detail)
        if found:
            sec = current[0]
            worst[sec] = max(worst.get(sec, 0), int(found.group(1)))

    current = [""]
    t0 = time.perf_counter()
    for name, fn in SECTIONS:
        if args.fast and name == "bank":
            continue
        current[0] = name
        fn(device, check)
    wall = time.perf_counter() - t0
    print(f"\nlargest LSB per section: "
          + ", ".join(f"{k} {v}" for k, v in worst.items()))
    print(f"battery wall time {wall:.1f}s on {card}")
    print("ALL PASS" if not failures else f"FAILURES: {failures}")
    return 1 if failures else 0


if __name__ == "__main__":
    sys.exit(main())
