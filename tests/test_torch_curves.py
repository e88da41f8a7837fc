"""Pitch, amplitude and FM-depth curves in the port's plain render
(synthesizer_tpu_torch.models.voicebank) against the JAX reference: the
same seeded voices through both packages' render_block, within 1 LSB at
int16 (the reference sums with a matmul, the port serially); the u32
phases and BLEP increments of _phases/_inst_inc bit-exact; streaming
equal to offline bit for bit."""

import dataclasses
import functools

import jax
import numpy as np
import pytest
import torch

from synthesizer_tpu.models import voicebank as J
from synthesizer_tpu_torch.models import voicebank as T
from test_torch_voicebank import assert_lsb, jax_fields, to_port

torch.set_num_threads(1)

SR = 44100
WAVE_NAMES = sorted(J.WAVE_IDS, key=J.WAVE_IDS.get)
KINDS = ("bend", "amp", "depth", "all")


def _extras(wave, rng):
    kw = {}
    if wave == "harmonics":
        kw["harmonics"] = (1.0, 0.5, 0.33, 0.25, 0.2)
    if wave == "pulse":
        kw["pulse_width"] = float(rng.uniform(0.1, 0.9))
    if wave in ("white_noise", "pluck"):
        kw["seed"] = int(rng.integers(0, 1000))
    if wave == "pluck":
        kw["damping"] = float(rng.uniform(0.3, 3.0))
    if wave == "wavetable":
        kw["table"] = tuple(float(x) for x in rng.uniform(-1, 1, 37))
    return kw


def _curves(kind, rng):
    kw = {}
    if kind in ("bend", "all"):
        kw["pitch_curve"] = ((0.0, 1.0),
                             (0.02, float(rng.uniform(0.7, 1.5))),
                             (0.05, float(rng.uniform(0.7, 1.5))),
                             (0.09, float(rng.uniform(0.9, 1.1))))
    if kind in ("amp", "all"):
        kw["amp_curve"] = ((0.0, float(rng.uniform(0.2, 1.0))),
                           (0.03, float(rng.uniform(0.2, 1.5))),
                           (0.07, float(rng.uniform(0.0, 1.0))))
    if kind in ("depth", "all"):
        kw["fm_frequency"] = float(rng.uniform(3.0, 9.0))
        kw["fm_depth_curve"] = ((0.0, 0.0),
                                (0.04, float(rng.uniform(0.005, 0.03))),
                                (0.1, float(rng.uniform(0.0, 0.03))))
    return kw


def curve_voices(kind, seed=0, start=0.0):
    """One voice of every waveform with curves of ``kind``, plus a
    curve-free voice of each wave family beside them."""
    rng = np.random.default_rng(seed)
    voices = []
    for i, wave in enumerate(WAVE_NAMES):
        base = dict(wave=wave, frequency=float(rng.uniform(60, 3000)),
                    amplitude=float(rng.uniform(0.1, 0.25)),
                    phase=float(rng.uniform(0, 1)),
                    pan=float(rng.uniform(-1, 1)),
                    start=start + 0.004 * i, duration=0.09, attack=0.005,
                    decay=0.01, sustain_level=0.7, release=0.02,
                    **_extras(wave, rng))
        voices.append(J.Voice(**base, **_curves(kind, rng)))
        if i % 4 == 0:
            voices.append(J.Voice(**{**base, "frequency": 220.0 + i}))
    return voices


@functools.lru_cache(maxsize=None)
def _jax_block(blocksize, H, layout, used, use_fm, flags):
    return jax.jit(functools.partial(
        J.render_block, blocksize=blocksize, samplerate=SR, num_harmonics=H,
        layout=layout, used_waves=used, use_fm=use_fm, **dict(flags)))


def _flags(bank):
    return (("use_glide", bank.use_glide), ("use_bend", bank.use_bend),
            ("use_amp", bank.use_amp), ("use_dmod", bank.use_dmod))


def render_pair(voices, n, grouped=True, n0=0):
    """(reference, port) render_block of the same packed bank, and the
    port's packed params and layout."""
    if grouped:
        vpj, ly = J.pack_voices(voices, SR, num_harmonics=8, sort_by_wave=True)
    else:
        vpj, ly = J.pack_voices(voices, SR, num_harmonics=8), None
    bank = J.VoiceBank.for_voices(voices, SR, num_harmonics=8, layout=ly)
    fn = _jax_block(n, bank.num_harmonics, ly, bank.used_waves, bank.use_fm,
                    _flags(bank))
    want = np.asarray(fn(vpj, np.int32(n0)))
    tly = None if ly is None else T.BankLayout(ly.groups, ly.nvoices,
                                               ly.num_harmonics)
    vpt = T.voice_params_from_numpy(jax_fields(vpj), device="cpu")
    got = T.render_block(vpt, n0, n, SR, bank.num_harmonics, tly,
                         bank.used_waves, bank.use_fm,
                         **dict(_flags(bank))).numpy()
    return want, got, vpj, vpt


def assert_phases_exact(vpj, vpt, n0, n, **flags):
    nj = np.arange(n0, n0 + n, dtype=np.int32)
    want = np.asarray(J._phases(vpj, nj, True, **flags)).astype(np.int64)
    got = T._phases(vpt, torch.arange(n0, n0 + n), True, **flags).numpy()
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("grouped", [True, False], ids=["grouped", "mixed"])
@pytest.mark.parametrize("kind", KINDS)
def test_curves_match_jax(kind, grouped):
    voices = curve_voices(kind, seed=KINDS.index(kind))
    want, got, vpj, vpt = render_pair(voices, 6144, grouped)
    assert np.abs(want).max() > 0.05
    assert_lsb(want, got)
    if grouped:
        assert_phases_exact(vpj, vpt, 0, 6144, use_bend=True, use_dmod=True)


def test_curves_change_the_render():
    # the curves are live: dropping them changes the output
    voices = curve_voices("all", seed=3)
    _, got, _, _ = render_pair(voices, 4096)
    plain = [dataclasses.replace(v, pitch_curve=(), amp_curve=(),
                                 fm_depth_curve=()) for v in voices]
    _, flat, _, _ = render_pair(plain, 4096)
    assert np.abs(got - flat).max() > 0.01


def test_blep_under_bend_inst_inc_exact():
    voices = [J.Voice(w, 880.0, amplitude=0.4, start=0.002, duration=0.12,
                      pitch_curve=((0.0, 0.5), (0.05, 3.0), (0.1, 1.0)))
              for w in ("sawtooth_bl", "square_bl")]
    voices.append(J.Voice("sawtooth_bl", 440.0, amplitude=0.2))
    want, got, vpj, vpt = render_pair(voices, 6144)
    assert_lsb(want, got)
    nj = np.arange(6144, dtype=np.int32)
    inc_j = np.asarray(J._inst_inc(vpj, nj, False, True)).astype(np.int64)
    inc_t = T._inst_inc(vpt, torch.arange(6144), False, True).numpy()
    np.testing.assert_array_equal(inc_t, inc_j)
    assert len(np.unique(inc_t[0])) > 100              # the dt really moves


def test_pluck_excluded_from_bend():
    base = dict(wave="pluck", frequency=440.0, start=0.003, duration=0.1,
                amplitude=0.5, seed=7)
    bent = [J.Voice(pitch_curve=((0.0, 1.0), (0.05, 1.5)), **base),
            J.Voice("sine", 330.0, amplitude=0.1,
                    pitch_curve=((0.0, 1.0), (0.05, 1.2)))]
    want, got, _, _ = render_pair(bent, 4096)
    assert_lsb(want, got)
    vp = T.pack_voices(to_port(bent[:1]), SR, device="cpu")
    plain = T.pack_voices(to_port([J.Voice(**base)]), SR, device="cpu")
    a = T.render_block(vp, 0, 4096, SR, 8, use_bend=True)
    b = T.render_block(plain, 0, 4096, SR, 8)
    assert torch.equal(a, b)


def test_glide_beside_curve_voices():
    voices = [J.Voice("sine", 660.0, glide_from=330.0, glide_time=0.03,
                      start=0.002, duration=0.1, amplitude=0.3),
              J.Voice("sawtooth_bl", 1500.0, glide_from=200.0,
                      glide_time=0.05, duration=0.1, amplitude=0.3)]
    voices += curve_voices("all", seed=9)[:6]
    want, got, vpj, vpt = render_pair(voices, 6144)
    assert_lsb(want, got)
    assert_phases_exact(vpj, vpt, 0, 6144, use_glide=True, use_bend=True,
                        use_dmod=True)


def test_curve_points_on_one_frame():
    # points closer than a frame collapse (the later one wins) and a ramp
    # of one frame is a step
    f = 1.0 / SR
    voices = [
        J.Voice("sine", 440.0, amplitude=0.3, duration=0.08,
                pitch_curve=((0.0, 1.0), (0.2 * f, 1.3), (0.01, 1.3),
                             (0.01 + f, 0.8))),
        J.Voice("triangle", 330.0, amplitude=0.3, duration=0.08,
                amp_curve=((0.0, 0.3), (0.5 * f, 1.0), (0.02, 1.0),
                           (0.02 + f, 0.1))),
        J.Voice("square", 220.0, amplitude=0.3, duration=0.08,
                fm_frequency=6.0,
                fm_depth_curve=((0.0, 0.0), (0.3 * f, 0.02), (0.03, 0.02),
                                (0.03 + f, 0.0))),
    ]
    want, got, vpj, vpt = render_pair(voices, 4096)
    assert_lsb(want, got)
    assert_phases_exact(vpj, vpt, 0, 4096, use_bend=True, use_dmod=True)


def test_curves_past_2_pow_24_frames():
    voices = curve_voices("all", seed=5, start=400.0)
    n0 = int(400.0 * SR) - 500
    assert n0 > 2 ** 24
    want, got, vpj, vpt = render_pair(voices, 6144, n0=n0)
    assert np.abs(want).max() > 0.05
    assert_lsb(want, got)
    assert_phases_exact(vpj, vpt, n0, 6144, use_bend=True, use_dmod=True)


@pytest.mark.parametrize("grouped", [True, False], ids=["grouped", "mixed"])
def test_curves_streaming_equals_offline(grouped):
    voices = to_port(curve_voices("all", seed=11))
    if grouped:
        vp, ly = T.pack_voices(voices, SR, sort_by_wave=True, device="cpu")
    else:
        vp, ly = T.pack_voices(voices, SR, device="cpu"), None
    total = 7000
    out = {}
    for chunk in (1024, 3000, 8192):
        bank = T.VoiceBank.for_voices(voices, SR, chunk_frames=chunk,
                                      layout=ly, device="cpu")
        assert bank.use_bend and bank.use_amp and bank.use_dmod
        out[chunk] = bank.render_song(vp, total)
        streamed = torch.cat([bank.render_chunk(vp, i * chunk)
                              for i in range(-(-total // chunk))])[:total]
        assert torch.equal(streamed, out[chunk])
    assert torch.equal(out[1024], out[3000]) and torch.equal(out[3000],
                                                             out[8192])
