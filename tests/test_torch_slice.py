"""The port's main path as a whole: config 5's song (bench.build_song)
packed, rendered through VoiceBank.render_song and quantized with
to_int16, against the JAX reference on the same song.  Cut to 2 s and a
8192-frame chunk to stay CPU-cheap; all 64 voices."""

import dataclasses
import functools

import jax
import numpy as np
import pytest
import torch

import bench
from __graft_entry__ import _demo_voices
from synthesizer_tpu.models import voicebank as J
from synthesizer_tpu_torch import bench_song
from synthesizer_tpu_torch.models import voicebank as T

SR = 44100


@pytest.fixture(scope="module")
def song():
    voices = bench_song.build_song(64, 2.0, SR)
    vp, ly = T.pack_voices(voices, SR, num_harmonics=8, sort_by_wave=True,
                           device="cpu")
    return voices, vp, ly


def _port_bank(voices, ly, chunk):
    return T.VoiceBank.for_voices(voices, SR, chunk_frames=chunk,
                                  num_harmonics=8, layout=ly,
                                  nvoices=ly.nvoices, device="cpu")


def test_build_song_matches_bench():
    for nv, dur in ((64, 2.0), (64, 60.0), (1024, 10.0)):
        want = bench.build_song(nv, dur, SR)
        got = bench_song.build_song(nv, dur, SR)
        assert [dataclasses.asdict(v) for v in got] == \
            [dataclasses.asdict(v) for v in want]


def test_demo_voices_match_graft_entry():
    assert [dataclasses.asdict(v) for v in bench_song.demo_voices(64)] == \
        [dataclasses.asdict(v) for v in _demo_voices(64)]


def test_config5_song_matches_jax(song):
    voices, vp, ly = song
    total = int(2.0 * SR)
    jv = bench.build_song(64, 2.0, SR)
    jvp, jly = J.pack_voices(jv, SR, num_harmonics=8, sort_by_wave=True)
    assert jly.groups == ly.groups and len(ly.groups) == 8
    assert all(has_fm for (_, has_fm, _, _) in ly.groups)
    jbank = J.VoiceBank.for_voices(jv, SR, chunk_frames=8192, num_harmonics=8,
                                   layout=jly, nvoices=jly.nvoices)
    jmix = jbank.render_song(jvp, total)
    want = np.asarray(jbank.to_int16(jmix)).astype(np.int64)
    bank = _port_bank(voices, ly, 8192)
    mix = bank.render_song(vp, total)
    got = bank.to_int16(mix)
    assert got.dtype == torch.int16 and got.shape == (total, 2)
    got = got.numpy().astype(np.int64)
    assert np.abs(want).max() > 1000
    d = np.abs(got - want)
    fd = np.abs(mix.numpy() - np.asarray(jmix)).max()
    # the reference sums voices with a [N,V]x[V,2] matmul, the port
    # serially in packed order: summation order only
    assert d.max() <= 1, f"max {d.max()} LSB, f32 max diff {fd:.3g}"


def test_chunk_invariance_bit_exact(song):
    voices, vp, ly = song
    n = 12000
    a = _port_bank(voices, ly, 512).render_song(vp, n)
    b = _port_bank(voices, ly, 4096).render_song(vp, n)
    assert torch.equal(a, b)


def test_streaming_matches_offline_bit_exact(song):
    voices, vp, ly = song
    bank = _port_bank(voices, ly, 8192)
    off = bank.render_song(vp, 6 * 8192)
    chunks = [bank.render_chunk(vp, i * 8192) for i in range(6)]
    assert torch.equal(torch.cat(chunks), off)


def test_mixed_layout_demo_bank_matches_jax():
    # __graft_entry__.entry's ungrouped bank: one mixed group
    jvp = J.pack_voices(_demo_voices(64), SR, num_harmonics=8)
    fn = jax.jit(functools.partial(J.render_block, blocksize=2048,
                                   samplerate=SR, num_harmonics=8))
    want = np.asarray(fn(jvp, np.int32(0)))
    vp = T.pack_voices(bench_song.demo_voices(64), SR, num_harmonics=8,
                       device="cpu")
    bank = T.VoiceBank(vp.wave.shape[0], SR, chunk_frames=2048, device="cpu")
    got = bank.render_chunk(vp, 0).numpy()
    w16 = np.clip(np.rint(want * 32767), -32768, 32767)
    g16 = np.clip(np.rint(got * 32767), -32768, 32767)
    assert np.abs(want).max() > 0.01
    assert np.abs(g16 - w16).max() <= 1


def test_to_int16_matches_jax():
    rng = np.random.default_rng(4)
    x = np.concatenate([
        np.array([[2.0, -2.0], [1.0, -1.0], [0.5, -0.5], [1e9, -1e9]],
                 np.float32),
        rng.uniform(-1.2, 1.2, (999, 2)).astype(np.float32)])
    for gain in (1.0, 0.5, 2.0):
        want = np.asarray(J.VoiceBank.to_int16(x, gain))
        got = T.VoiceBank.to_int16(torch.from_numpy(x), gain).numpy()
        assert got.dtype == np.int16
        np.testing.assert_array_equal(got, want)
    got = T.VoiceBank.to_int16(torch.from_numpy(x)).numpy()
    assert got[0, 0] == 32767 and got[0, 1] == -32768
    assert got[3, 0] == 32767 and got[3, 1] == -32768
    # a gain of 1/32767 makes the f32 scale exactly 1.0, so these values
    # sit exactly halfway between integers (round half to even), inside
    # and beyond the int16 range
    halves = np.arange(-33000, 33000, 7, dtype=np.float32) + np.float32(0.5)
    x = np.stack([halves, -halves], 1)
    want = np.asarray(J.VoiceBank.to_int16(x, 1 / 32767))
    got = T.VoiceBank.to_int16(torch.from_numpy(x), 1 / 32767).numpy()
    np.testing.assert_array_equal(got, want)
    assert got[0, 0] == -32768 and got[-1, 0] == 32767
    assert (got.astype(np.int64) % 2 == 0)[np.abs(x) < 32767].all()


def test_bank_rejects_params_on_another_device(song):
    voices, vp, ly = song
    bank = T.VoiceBank.for_voices(voices, SR, layout=ly, nvoices=ly.nvoices,
                                  device="meta")
    with pytest.raises(ValueError, match="bank on meta"):
        bank.render_chunk(vp, 0)


def test_bank_golden_checksum_drift_alarm():
    """The bank of tests/test_golden_checksums.py::test_bank_render_checksum
    through the port.  The digest pins the port's own CPU bytes (a drift
    alarm: a PyTorch upgrade may shift a float path by an ulp; look, then
    update); the contract is the second half: within 1 LSB of the
    reference's render of the same bank."""
    import hashlib

    def bank_of(M, **cpu):
        vs = [M.Voice("harmonics", 110.0, amplitude=0.3,
                      harmonics=[1, 0.5, 0.25], duration=0.2),
              M.Voice("square_bl", 220.0, amplitude=0.3, duration=0.2,
                      pan=0.5),
              M.Voice("sine", 440.0, amplitude=0.3, duration=0.2,
                      fm_frequency=6.0, fm_depth=0.02)]
        vp, lay = M.pack_voices(vs, SR, num_harmonics=4, sort_by_wave=True,
                                **cpu)
        bank = M.VoiceBank.for_voices(vs, SR, chunk_frames=2048,
                                      num_harmonics=4, layout=lay,
                                      nvoices=lay.nvoices, **cpu)
        return np.asarray(bank.to_int16(bank.render_song(vp, SR // 4)))

    got = bank_of(T, device="cpu")
    want = bank_of(J)
    assert got.shape == want.shape == (SR // 4, 2)
    d = np.abs(got.astype(np.int32) - want.astype(np.int32))
    assert d.max() <= 1
    sha = hashlib.sha256(np.ascontiguousarray(got).tobytes()).hexdigest()[:16]
    assert sha == "dfa1fbf3c42c6f55"
