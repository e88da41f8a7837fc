"""The voice bank's segment buses (``render_block(seg=, nseg=)``,
``VoiceBank.render_song_grouped`` / ``render_chunk_grouped``) in the port
against the JAX package, on the CPU.

Tolerances: the port's plain render gives each voice to its own bus and
sums a bus's voices serially in packed order; the reference scatters the
pan gains into a [V, 2*nseg] matrix for one HIGHEST matmul, where the other
buses' voices add exact zeros.  So the two agree within 1 LSB at int16 (the
matmul's summation order), and in the port each bus equals the flat render
of its own voices bit for bit.  The CUDA kernel's bus mode is held against
this plain version on the card by ``chip_smoke.py`` (phase 17).
"""

import dataclasses

import numpy as np
import pytest
import torch

from synthesizer_tpu.models import voicebank as J
from synthesizer_tpu_torch.models import voicebank as T
from synthesizer_tpu_torch.ops import kernels as K
from test_voicebank import VOICES as BANK_VOICES
from test_voicebank import rand_voice

torch.set_num_threads(2)

SR = 44100


def to_port(voices):
    return [T.Voice(**dataclasses.asdict(v)) for v in voices]


def _lsb(a, b):
    a = np.clip(np.rint(np.asarray(a, np.float32) * np.float32(32767)),
                -32768, 32767).astype(np.int64)
    b = np.clip(np.rint(np.asarray(b, np.float32) * np.float32(32767)),
                -32768, 32767).astype(np.int64)
    assert a.shape == b.shape, (a.shape, b.shape)
    return int(np.abs(a - b).max())


def _bank(seed, nseg):
    """Voices of several waveforms (FM and glide included), each with a bus
    tag, packed grouped by waveform in both packages."""
    rng = np.random.default_rng(seed)
    voices = list(BANK_VOICES) + [rand_voice(rng) for _ in range(10)]
    voices = [dataclasses.replace(v, start=float(rng.uniform(0.0, 0.05)),
                                  duration=float(rng.uniform(0.02, 0.1)))
              for v in voices]
    tags = [int(t) for t in rng.integers(0, nseg, len(voices))]
    jvp, jly, jseg = J.pack_voices(voices, SR, num_harmonics=8,
                                   sort_by_wave=True, tags=tags)
    tvp, tly, tseg = T.pack_voices(to_port(voices), SR, num_harmonics=8,
                                   sort_by_wave=True, tags=tags, device="cpu")
    assert np.array_equal(jseg, tseg) and jly.groups == tly.groups
    return voices, (jvp, jly, jseg), (tvp, tly, tseg)


CASES = [(0, 2), (1, 3), (2, 5)]


@pytest.fixture(scope="module", params=CASES, ids=lambda c: f"seed{c[0]}-"
                f"nseg{c[1]}")
def bank(request):
    seed, nseg = request.param
    return (nseg,) + _bank(seed, nseg)


def test_render_block_buses_match_jax(bank):
    nseg, voices, (jvp, jly, jseg), (tvp, tly, tseg) = bank
    n0, n = 700, 2048
    want = np.asarray(J.render_block(jvp, n0, n, SR, 8, jly, seg=jseg,
                                     nseg=nseg))
    got = T.render_block(tvp, n0, n, SR, 8, tly, seg=tseg, nseg=nseg)
    assert got.shape == (n, nseg, 2) and want.shape == got.shape
    assert np.abs(want).max() > 0.01
    assert _lsb(want, got.numpy()) <= 1


def test_bus_equals_its_solo_render(bank):
    """Bus b of the grouped render == the flat render of bus b's voices
    (the same layout's groups, restricted to them), bit for bit; the
    buses' sum is the flat render of all voices within float rounding."""
    nseg, voices, _, (tvp, tly, tseg) = bank
    n = 3000
    buses = T.render_block(tvp, 0, n, SR, 8, tly, seg=tseg, nseg=nseg)
    for b in range(nseg):
        sub, ly = K.solo_params(tvp, tly, np.flatnonzero(tseg == b))
        solo = T.render_block(sub, 0, n, SR, 8, ly)
        assert torch.equal(buses[:, b], solo), b
    flat = T.render_block(tvp, 0, n, SR, 8, tly)
    assert _lsb(buses.sum(dim=1).numpy(), flat.numpy()) <= 1


def test_song_grouped_matches_jax_and_chunks(bank):
    """render_song_grouped within 1 LSB of the JAX bank's, and equal bit for
    bit to its render_chunk_grouped chunks concatenated."""
    nseg, voices, (jvp, jly, jseg), (tvp, tly, tseg) = bank
    total, cf = 5000, 2048
    jbank = J.VoiceBank.for_voices(voices, SR, chunk_frames=cf,
                                   num_harmonics=8, layout=jly,
                                   nvoices=jly.nvoices)
    want = np.asarray(jbank.render_song_grouped(jvp, jseg, nseg, total))
    tbank = T.VoiceBank.for_voices(to_port(voices), SR, chunk_frames=cf,
                                   num_harmonics=8, layout=tly,
                                   nvoices=tly.nvoices, device="cpu")
    got = tbank.render_song_grouped(tvp, tseg, nseg, total)
    assert got.shape == (total, nseg, 2)
    assert _lsb(want, got.numpy()) <= 1
    chunks = torch.cat([tbank.render_chunk_grouped(tvp, tseg, nseg, c0)
                        for c0 in range(0, total, cf)])[:total]
    assert torch.equal(chunks, got)


def test_render_stereo_reference_takes_buses(bank):
    """The kernel's plain version (what render_stereo runs on CPU tensors)
    with buses == render_block with buses; a voice whose id lies outside
    [0, nseg) sounds on no bus, as in the kernel."""
    nseg, _, _, (tvp, tly, tseg) = bank
    seg = torch.from_numpy(tseg)
    got = K.render_stereo(tvp, 512, nframes=1500, samplerate=SR, layout=tly,
                          seg=seg, nseg=nseg)
    want = T.render_block(tvp, 512, 1500, SR, 8, tly, seg=tseg, nseg=nseg)
    assert torch.equal(got, want)
    out_of_range = seg.clone()
    out_of_range[0] = nseg
    dropped = K.render_stereo_reference(tvp, 512, nframes=1500,
                                        samplerate=SR, layout=tly,
                                        seg=out_of_range, nseg=nseg)
    keep = np.arange(1, len(tseg))
    sub, ly = K.solo_params(tvp, tly, keep)
    assert torch.equal(dropped, T.render_block(sub, 512, 1500, SR, 8, ly,
                                               seg=tseg[1:], nseg=nseg))


def test_one_bus_is_the_flat_render():
    """nseg = 1 with every voice on bus 0: the flat render, bit for bit."""
    _, _, (tvp, tly, tseg) = _bank(3, 1)
    flat = T.render_block(tvp, 100, 1024, SR, 8, tly)
    one = T.render_block(tvp, 100, 1024, SR, 8, tly, seg=tseg, nseg=1)
    assert torch.equal(one[:, 0], flat)


def test_bus_arguments_are_checked():
    vp = T.pack_voices(to_port(BANK_VOICES[:2]), SR, device="cpu")
    with pytest.raises(ValueError, match="one bus"):
        T.render_block(vp, 0, 64, SR, 8, seg=[0, 1], nseg=2)
    with pytest.raises(ValueError, match="one bus"):
        T.render_block(vp, 0, 64, SR, 8, seg=[2] * 8, nseg=2)
    with pytest.raises(ValueError, match="nseg without seg"):
        T.render_block(vp, 0, 64, SR, 8, nseg=2)
    bank = T.VoiceBank(8, SR, chunk_frames=64, device="cpu")
    with pytest.raises(ValueError, match="one bus"):
        bank.render_song_grouped(vp, [0] * 7 + [3], 2, 100)
    with pytest.raises(ValueError, match="sparse rows"):
        K.render_stereo_reference(vp, 0, nframes=64, samplerate=SR,
                                  layout=T.BankLayout.ungrouped(8, 8),
                                  seg=torch.zeros(8, dtype=torch.int32),
                                  nseg=1, idx=torch.zeros((1, 8),
                                                          dtype=torch.int32),
                                  chunk_frames=64)
