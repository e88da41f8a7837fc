"""Randomized oscillator-patch fuzzing of the port: ``models.graph`` on
``device="cpu"`` against the oracle.

The counterpart of ``tests/test_fuzz_patches.py``, with its seeds,
generator and tolerances: random patch DAGs (waveforms, FM/PWM routing,
envelopes, mixes, amp-mod, delay/echo/clip/abs).  FM is restricted to
continuous waveforms (a discontinuous one can flip a whole step on a 1-ulp
phase difference at the edge).
"""

import numpy as np
import pytest
import torch

import goldref.osc as go
from synthesizer_tpu_torch.models import graph as G
from synthesizer_tpu_torch.models import spec as S

torch.set_num_threads(2)

SR = 44100
N = 8192

CONTINUOUS = ["sine", "triangle", "semicircle", "pointy", "sawtooth_bl"]
DISCONTINUOUS = ["square", "sawtooth", "pulse", "square_bl"]
ADDITIVE = ["square_h", "sawtooth_h"]


def rand_lfo(rng):
    kind = ["sine", "triangle"][rng.integers(2)]
    return S.Osc(kind, float(rng.uniform(0.5, 10.0)),
                 amplitude=float(rng.uniform(0.001, 0.03)),
                 phase=float(rng.uniform(0, 1)))


def rand_osc(rng, allow_fm=True):
    pool = CONTINUOUS + DISCONTINUOUS + ADDITIVE + ["harmonics", "white_noise"]
    kind = pool[rng.integers(len(pool))]
    kw = dict(amplitude=float(rng.uniform(0.1, 0.9)),
              phase=float(rng.uniform(0, 1)),
              bias=float(rng.uniform(-0.05, 0.05)))
    freq = float(rng.uniform(30, 3000))
    if kind in CONTINUOUS and kind != "sawtooth_bl" and allow_fm and rng.random() < 0.5:
        kw["fm_lfo"] = rand_lfo(rng)
    if kind == "pulse":
        if rng.random() < 0.5:
            kw["pwm_lfo"] = S.Osc("sine", float(rng.uniform(0.5, 5.0)),
                                  amplitude=0.3, bias=0.5)
        else:
            kw["pulse_width"] = float(rng.uniform(0.05, 0.95))
    if kind in ADDITIVE:
        kw["num_harmonics"] = int(rng.integers(2, 12))
    if kind == "harmonics":
        nh = int(rng.integers(1, 6))
        kw["harmonics"] = tuple((float(k + 1), float(rng.uniform(0.1, 1.0) / (k + 1)))
                                for k in range(nh))
    if kind == "white_noise":
        kw["seed"] = int(rng.integers(0, 2**31))
        freq = float(rng.choice([0.0, 100.0, 5000.0])) or SR
    return S.Osc(kind, freq, **kw)


def rand_patch(rng, depth=0):
    if depth >= 2 or rng.random() < 0.4:
        return rand_osc(rng)
    choice = rng.integers(6)
    if choice == 0:
        return S.Envelope(rand_patch(rng, depth + 1),
                          float(rng.uniform(0, 0.02)), float(rng.uniform(0, 0.03)),
                          float(rng.uniform(0.01, 0.1)), float(rng.uniform(0.3, 1.0)),
                          float(rng.uniform(0, 0.05)))
    if choice == 1:
        k = int(rng.integers(2, 4))
        return S.Mix(tuple(rand_patch(rng, depth + 1) for _ in range(k)))
    if choice == 2:
        return S.AmpMod(rand_patch(rng, depth + 1),
                        S.Osc("sine", float(rng.uniform(0.5, 8.0)),
                              amplitude=0.4, bias=0.6))
    if choice == 3:
        return S.Delay(rand_patch(rng, depth + 1), float(rng.uniform(0, 0.05)))
    if choice == 4:
        return S.Echo(rand_patch(rng, depth + 1), float(rng.uniform(0, 0.03)),
                      int(rng.integers(1, 4)), float(rng.uniform(0.005, 0.03)),
                      float(rng.uniform(0.3, 0.7)))
    return S.Clip(rand_patch(rng, depth + 1), -0.8, 0.8) if rng.random() < 0.5 \
        else S.Abs(rand_patch(rng, depth + 1))


def count_risky(node) -> int:
    """Ops that can each contribute ~1 LSB (FMA/1-ulp effects)."""
    n = 0
    if isinstance(node, S.Osc):
        n += 1
        if node.fm_lfo is not None:
            n += 1 + count_risky(node.fm_lfo)
        if node.pwm_lfo is not None:
            n += count_risky(node.pwm_lfo)
        if node.kind in ADDITIVE:
            n += node.num_harmonics
        if node.kind == "harmonics":
            n += len(node.harmonics)
    for attr in ("source", "modulator"):
        if hasattr(node, attr):
            n += count_risky(getattr(node, attr))
    if isinstance(node, S.Mix):
        for s in node.sources:
            n += count_risky(s)
    if isinstance(node, S.Envelope):
        n += 1
    return n


@pytest.mark.parametrize("seed", range(20))
def test_random_patch_matches_oracle(seed):
    rng = np.random.default_rng(seed + 1000)
    patch = rand_patch(rng)
    want = go.to_int_samples(go.render_oracle(patch, N, SR), 2)
    got = G.to_int_device(G.render_patch(patch, N, SR, blocksize=1024,
                                         device="cpu"), 2).numpy()
    d = np.abs(got.astype(np.int64) - want.astype(np.int64))
    tol = max(2, count_risky(patch))
    # discontinuous waveforms under PWM can flip single samples at the
    # comparator edge; allow a vanishing fraction of larger outliers
    bad = (d > tol)
    assert bad.mean() < 2e-4, \
        f"seed {seed}: {bad.sum()} samples beyond tol={tol} (max {d.max()})\n{patch}"


@pytest.mark.parametrize("seed", [3, 7])
def test_random_patch_blocksize_invariance(seed):
    rng = np.random.default_rng(seed + 2000)
    patch = rand_patch(rng)
    a = G.render_patch(patch, N, SR, blocksize=512, device="cpu").numpy()
    b = G.render_patch(patch, N, SR, blocksize=4096, device="cpu").numpy()
    np.testing.assert_array_equal(a, b)
