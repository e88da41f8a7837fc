"""The port's loudness meters (``synthesizer_tpu_torch.ops.loudness``)
against the JAX package's ``ops.loudness`` and the f64 oracle
(``goldref.effects``), on the CPU.

Budgets, as the reference's own tests hold its device path: integrated
loudness, the R128 meter set and true peak within 0.01 LU / dB of the
JAX package (the same f32 K-weighting scans and FIR, summed in another
order) and of the oracle; the live meter within 0.02 LU of the
whole-signal meter.  The JAX K-weighting runs once per signal shape.
"""

import math

import numpy as np
import pytest
import torch

import goldref.effects as gfx
from synthesizer_tpu.ops import loudness as JL
from synthesizer_tpu_torch.ops import loudness as TL

SR = 48000


def sine(freq, dbfs, seconds, nch=2):
    t = np.arange(int(seconds * SR))
    a = 10 ** (dbfs / 20) * 32767.0 * np.sin(2 * np.pi * freq / SR * t)
    return np.repeat(np.rint(a).astype(np.int16)[:, None], nch, 1)


def programme(seconds=5.0):
    rng = np.random.default_rng(0x10FD)
    frames = np.concatenate([sine(997.0, -33.0, seconds / 2),
                             sine(440.0, -23.0, seconds / 2)])
    frames += rng.integers(-400, 400, size=frames.shape).astype(np.int16)
    return frames


def _jax_frames(a):
    import jax.numpy as jnp
    return jnp.asarray(a)


@pytest.fixture(scope="module")
def prog():
    """A 5 s programme with a quiet half, and its JAX measurements (one
    compile of the JAX K-weighting program for the module)."""
    a = programme()
    ja = _jax_frames(a)
    return a, {"hops": JL.kweighted_hop_sums(ja, SR),
               "lufs": JL.loudness_integrated(ja, SR),
               "stats": JL.loudness_stats(ja, SR),
               "tp": JL.true_peak_norm(ja)}


def test_hop_sums_and_integrated(prog):
    a, j = prog
    hops = TL.kweighted_hop_sums(torch.from_numpy(a), SR)
    assert hops.shape == j["hops"].shape and hops.dtype == np.float32
    # the K-weighting's 38 Hz high-pass has poles near z = 1: the f32 scan
    # carries ~1e-3 relative error in a hop's energy (XLA rounds the 2x2
    # products inside fused dot products, eager PyTorch rounds each one),
    # 0.02 dB at most; integrated values average it away
    gold = gfx._kweighted_hop_sums_f64(a, 2, SR)[0]
    for got in (hops, j["hops"]):
        assert (np.abs(got - gold) / gold).max() < 1e-2
    li = TL.loudness_integrated(torch.from_numpy(a), SR)
    assert abs(li - j["lufs"]) < 0.01
    assert abs(li - gfx.loudness_lufs(a, 2, SR)) < 0.01


def test_stats(prog):
    a, j = prog
    st = TL.loudness_stats(torch.from_numpy(a), SR)
    gold = gfx.loudness_stats(a, 2, SR)
    for k in ("integrated", "lra", "momentary_max", "short_term_max"):
        assert abs(st[k] - j["stats"][k]) < 0.01, k
        assert abs(st[k] - gold[k]) < 0.02, k


def test_true_peak(prog):
    a, j = prog
    tp = TL.true_peak_norm(torch.from_numpy(a))
    assert abs(20 * math.log10(tp) - 20 * math.log10(j["tp"])) < 0.01
    assert abs(20 * math.log10(tp) - gfx.true_peak_dbtp(a, 2, SR)) < 0.01


def test_true_peak_sees_the_intersample_peak():
    """A sine at fs/4 sampled 45 degrees off its peaks reads 3 dB above the
    sampled peak; the oversampled signal is the full convolution of the
    zero-stuffed signal with the 48-tap FIR."""
    n = np.arange(4000)
    a = np.rint(0.5 * 32767 * np.sin(np.pi / 2 * n + np.pi / 4)) \
        .astype(np.int16)[:, None]
    tp = TL.true_peak_norm(torch.from_numpy(a))
    assert 20 * math.log10(tp) > 20 * math.log10(np.abs(a).max() / 32767) \
        + 2.5
    assert abs(20 * math.log10(tp) - gfx.true_peak_dbtp(a, 2, SR)) < 0.01
    x = np.random.default_rng(3).integers(-3000, 3000, (50, 1)) \
        .astype(np.int16)
    y = TL.true_peak_oversampled(torch.from_numpy(x))[:, 0].numpy()
    h = TL.true_peak_filter()
    stuffed = np.zeros(4 * 50 - 3)
    stuffed[::4] = x[:, 0] / 32767.0
    ref = np.convolve(stuffed, h)
    assert y.shape == ref.shape
    np.testing.assert_allclose(y, ref, atol=1e-6)
    assert TL.true_peak_norm(torch.zeros((0, 2), dtype=torch.int16)) == 0.0


def test_short_and_silent_programmes():
    s = TL.loudness_stats(torch.from_numpy(sine(997.0, -20.0, 0.5)), SR)
    assert math.isfinite(s["momentary_max"])
    assert s["short_term_max"] == float("-inf") and s["lra"] == 0.0
    z = torch.zeros((SR // 5, 2), dtype=torch.int16)
    assert TL.loudness_integrated(z, SR) == float("-inf")
    assert TL.kweighted_hop_sums(z[:100], SR).shape == (0, 2)


@pytest.mark.parametrize("chunk", [1470, 4800, 373])
def test_live_meter_matches_whole_signal(chunk):
    frames = programme(4.0)
    whole = TL.loudness_stats(torch.from_numpy(frames), SR)
    sl = TL.StreamingLoudness(SR, 2)
    for i in range(0, len(frames), chunk):
        sl.update(torch.from_numpy(frames[i:i + chunk]))
    live = sl.stats()
    for k in ("integrated", "lra", "momentary_max", "short_term_max"):
        assert abs(live[k] - whole[k]) < 0.02, (k, live[k], whole[k])


def test_live_meter_host_path_matches_reference_and_device_path():
    """The host path is the reference's numpy pipeline: equal to the JAX
    package's ``update_host`` readings; the device path within 0.02 LU."""
    frames = programme(4.0)
    a, b = TL.StreamingLoudness(SR, 2), TL.StreamingLoudness(SR, 2)
    ref = JL.StreamingLoudness(SR, 2)
    for i in range(0, len(frames), 2400):
        ma, sa = a.update(torch.from_numpy(frames[i:i + 2400]))
        mb, sb = b.update_host(frames[i:i + 2400])
        assert (mb, sb) == ref.update_host(frames[i:i + 2400])
        for u, v in ((ma, mb), (sa, sb)):
            if math.isfinite(u) or math.isfinite(v):
                assert abs(u - v) < 0.02, (u, v)
    sta, stb = a.stats(), b.stats()
    for k in ("integrated", "lra", "momentary_max", "short_term_max"):
        assert abs(sta[k] - stb[k]) < 0.02, k
    assert stb == ref.stats()
    with pytest.raises(ValueError, match="channels"):
        a.update(torch.zeros((10, 1), dtype=torch.int16))
    assert a.update(torch.zeros((0, 2), dtype=torch.int16)) == \
        (a.momentary, a.short_term)
