"""Port's voice bank (synthesizer_tpu_torch.models.voicebank) vs the JAX
reference: host packing bit-exact on every field, and the plain render
(render_block) within 1 LSB at int16 on every waveform, FM, glide and
layout.  Inputs are the Voice lists the reference's own tests use plus
seeded random banks; both packages get the same voices."""

import dataclasses
import functools

import jax
import numpy as np
import pytest
import torch

from synthesizer_tpu.models import voicebank as J
from synthesizer_tpu_torch import bench_song
from synthesizer_tpu_torch import midi as TM
from synthesizer_tpu_torch.models import voicebank as T
from test_pallas_kernel import VOICES as KERNEL_VOICES
from test_voicebank import VOICES as BANK_VOICES
from test_voicebank import rand_voice

torch.set_num_threads(1)

SR = 44100


def to_port(voices):
    return [T.Voice(**dataclasses.asdict(v)) for v in voices]


def jax_fields(vp) -> dict:
    return {k: np.asarray(v) for k, v in vp._asdict().items()}


def _special_voices():
    rng = np.random.default_rng(31)
    return [
        J.Voice("sine", 660.0, glide_from=330.0, glide_time=0.04,
                start=0.005, duration=0.2, amplitude=0.4),
        J.Voice("wavetable", 220.0, amplitude=0.2, duration=0.08,
                table=tuple(float(x) for x in rng.uniform(-1, 1, 48))),
        J.Voice("pluck", 440.0, amplitude=0.5, seed=7, damping=1.3),
        J.Voice("sine", 440.0, amplitude=0.3,
                pitch_curve=((0.0, 1.0), (0.05, 1.5), (0.1, 0.8))),
        J.Voice("triangle", 330.0, amplitude=0.3,
                amp_curve=((0.0, 0.2), (0.05, 1.0), (0.2, 0.5))),
        J.Voice("sine", 550.0, amplitude=0.3, fm_frequency=5.0,
                fm_depth_curve=((0.0, 0.0), (0.1, 0.02))),
    ]


def _rand_bank(seed):
    rng = np.random.default_rng(seed + 9000)
    return [rand_voice(rng) for _ in range(int(rng.integers(4, 16)))]


def _gm_small():
    """The port's MIDI front on a seeded 300-note GM file (bends, CC fades,
    vibrato, pedal), as the reference's voices."""
    data = bench_song.gm_file(300, 20.0, seed=21)
    voices = TM.midi_to_voices(TM.parse_midi(data))
    return [J.Voice(**dataclasses.asdict(v)) for v in voices]


#: a bend of 300 points (decimated to MAX_CURVE_SEGS)
_DENSE = tuple((0.002 * k, 2.0 ** (np.sin(0.1 * k) / 6.0)) for k in range(300))
#: two points on one frame with different values, two with equal t (the
#: (t, value) sort's tie), a first point after 0, given out of order
_TIES = ((0.05, 1.2), (0.01, 0.9), (0.05, 0.7), (0.03, 1.1),
         (0.03 + 0.2 / SR, 1.4), (0.2, 1.0))


def _curve_edges():
    def v(**kw):
        return J.Voice(**{**dict(wave="sine", frequency=440.0, amplitude=0.2,
                                 duration=0.3), **kw})
    return [
        v(pitch_curve=_DENSE),
        v(wave="square_bl", pitch_curve=_TIES, start=0.01),
        v(amp_curve=_TIES),
        v(amp_curve=tuple((t, g) for t, g in reversed(_DENSE))),
        v(fm_frequency=5.5, fm_phase=0.3, start=400.0,
          fm_depth_curve=((0.01, 0.0), (0.02, 0.01), (0.02, 0.005),
                          (0.25, 0.03))),
        v(fm_frequency=7.0, fm_depth_curve=tuple(
            (t, 0.01 * g) for t, g in _DENSE)),
        v(frequency=660.0, glide_from=330.0, glide_time=0.04),
        v(wave="wavetable", table=tuple(np.linspace(-1, 1, 37).tolist())),
        v(wave="harmonics", harmonics=(1.0, 0.5, 0.25, 0.125)),
        v(wave="pluck", seed=11, damping=1.3, amp_curve=((0.1, 0.5),)),
        v(wave="white_noise", frequency=3000.0, seed=5),
    ]


PACK_CASES = {
    "bank_voices": lambda: BANK_VOICES,
    "kernel_voices": lambda: KERNEL_VOICES,
    "special": _special_voices,
    "random0": lambda: _rand_bank(0),
    "random1": lambda: _rand_bank(1),
    "random2": lambda: _rand_bank(2),
    "gm_small": _gm_small,
    "curve_edges": _curve_edges,
}


@pytest.mark.parametrize("sort_by_wave", [False, True])
@pytest.mark.parametrize("case", sorted(PACK_CASES))
def test_pack_voices_bit_exact(case, sort_by_wave):
    voices = PACK_CASES[case]()
    want = J.pack_voices(voices, SR, num_harmonics=8, sort_by_wave=sort_by_wave)
    got = T.pack_voices(to_port(voices), SR, num_harmonics=8,
                        sort_by_wave=sort_by_wave, device="cpu")
    if sort_by_wave:
        (want, wly), (got, gly) = want, got
        assert (gly.groups, gly.nvoices, gly.num_harmonics) == \
            (wly.groups, wly.nvoices, wly.num_harmonics)
    assert T.VoiceParams._fields == J.VoiceParams._fields
    assert len(T.VoiceParams._fields) == 37
    wf = jax_fields(want)
    for name in T.VoiceParams._fields:
        w, g = wf[name], getattr(got, name).numpy()
        assert g.shape == w.shape, name
        if name in T.U32_FIELDS:
            assert w.dtype == np.uint32 and g.dtype == np.int64, name
            np.testing.assert_array_equal(g, w.astype(np.int64), err_msg=name)
        else:
            assert g.dtype == w.dtype, name
            # bit-exact, NaN-safe: compare the raw bytes
            assert g.tobytes() == w.tobytes(), name
    # carrying the reference's packed fields across gives the same tensors
    carried = T.voice_params_from_numpy(wf, device="cpu")
    for name in T.VoiceParams._fields:
        a, b = getattr(carried, name), getattr(got, name)
        assert a.dtype == b.dtype and torch.equal(a, b), name


def _rand_curve(rng, k):
    """A seeded control curve, out of order; by ``k``, one of the edges the
    per-voice compile meets: a curve past ``MAX_CURVE_SEGS`` points, equal t
    with different values (the (t, value) sort's tie), several points on
    one frame, a first point after 0, a single point."""
    n = int(rng.integers(2, 40))
    t = rng.uniform(0.0, 1.0, n)
    v = rng.uniform(0.5, 2.0, n)
    edge = k % 5
    if edge == 0:
        n = int(rng.integers(129, 400))
        t, v = rng.uniform(0.0, 3.0, n), rng.uniform(0.5, 2.0, n)
    elif edge == 1:
        t, v = np.round(t * 20) / 20, np.round(v, 1)
    elif edge == 2:
        t = (np.floor(t * 100) + rng.uniform(0, 0.5, n) / SR * 100) / 100
    elif edge == 3:
        t = t + 0.05
    elif k % 10 == 4:
        t, v = t[:1], v[:1]
    pts = list(zip(t.tolist(), v.tolist()))
    rng.shuffle(pts)
    return tuple(pts)


def _assert_same_segments(got, want, names, what):
    """Segment lists equal the reference's element for element: the same
    Python type and the same bits."""
    for name, g, w in zip(names, got, want):
        g, w = list(g), list(w)
        assert len(g) == len(w), \
            f"{what}: {len(g)} {name}, the reference {len(w)}"
        for k, (a, b) in enumerate(zip(g, w)):
            assert type(a) is type(b) and repr(a) == repr(b), \
                f"{what}: {name}[{k}] = {a!r}, the reference {b!r}"


def test_one_voice_compilers_match_the_reference():
    """The three public curve compilers, one voice each through the batched
    columns, against the reference's per-voice loops on 50 seeded curves
    and their edges (decimation, ties, one frame, a late first point, an
    LFO phase past 2**24 frames)."""
    rng = np.random.default_rng(2101)
    for k in range(50):
        curve = _rand_curve(rng, k)
        freq = float(rng.uniform(30.0, 4000.0))
        what = f"curve {k} ({len(curve)} points)"
        _assert_same_segments(
            T.compile_pitch_segments(curve, freq, SR),
            J.compile_pitch_segments(curve, freq, SR),
            ("starts", "phases", "incs", "ds"), "pitch " + what)
        _assert_same_segments(
            T.compile_amp_segments(curve, SR),
            J.compile_amp_segments(curve, SR),
            ("starts", "g0s", "dgs"), "amp " + what)
        depth = tuple((t, 0.02 * d) for t, d in curve)
        lfo, ph = float(rng.uniform(0.5, 12.0)), float(rng.uniform(-1, 2))
        start = int(rng.integers(2 ** 24, 2 ** 30)) if k % 2 else \
            int(rng.integers(0, SR))
        _assert_same_segments(
            T.compile_depth_segments(depth, lfo, ph, start, SR),
            J.compile_depth_segments(depth, lfo, ph, start, SR),
            ("starts", "cs", "a0s", "bs"), "depth " + what)
    _assert_same_segments(T.compile_pitch_segments((), 440.0, SR),
                          J.compile_pitch_segments((), 440.0, SR),
                          ("starts", "phases", "incs", "ds"), "no bend")


def test_pack_tags_and_validation():
    voices = BANK_VOICES[:5]
    _, wly, wt = J.pack_voices(voices, SR, sort_by_wave=True,
                               tags=[3, 1, 4, 1, 5])
    _, gly, gt = T.pack_voices(to_port(voices), SR, sort_by_wave=True,
                               tags=[3, 1, 4, 1, 5], device="cpu")
    np.testing.assert_array_equal(gt, wt)
    assert gly.groups == wly.groups
    fields = jax_fields(J.pack_voices(voices, SR))
    with pytest.raises(TypeError):
        T.voice_params_from_numpy(
            {**fields, "amp": fields["amp"].astype(np.float64)}, device="cpu")
    with pytest.raises(ValueError):
        T.voice_params_from_numpy(
            {**fields, "seed": fields["seed"].astype(np.int64) - 1},
            device="cpu")


@functools.lru_cache(maxsize=None)
def _jax_block_fn(blocksize, H, layout, used, use_fm, use_glide):
    return jax.jit(functools.partial(
        J.render_block, blocksize=blocksize, samplerate=SR, num_harmonics=H,
        layout=layout, used_waves=used, use_fm=use_fm, use_glide=use_glide))


def render_pair(voices, n, grouped=True, n0=0, H=8):
    """(reference, port) render_block of the same packed bank -> f32 [n, 2]
    each.  Bank flags (waves, FM, glide, harmonics) from for_voices."""
    if grouped:
        vpj, ly = J.pack_voices(voices, SR, num_harmonics=H, sort_by_wave=True)
    else:
        vpj, ly = J.pack_voices(voices, SR, num_harmonics=H), None
    bank = J.VoiceBank.for_voices(voices, SR, num_harmonics=H, layout=ly)
    fn = _jax_block_fn(n, bank.num_harmonics, ly, bank.used_waves,
                       bank.use_fm, bank.use_glide)
    want = np.asarray(fn(vpj, np.int32(n0)))
    tly = None if ly is None else T.BankLayout(ly.groups, ly.nvoices,
                                               ly.num_harmonics)
    vpt = T.voice_params_from_numpy(jax_fields(vpj), device="cpu")
    got = T.render_block(vpt, n0, n, SR, bank.num_harmonics, tly,
                         bank.used_waves,
                         bank.use_fm, use_glide=bank.use_glide).numpy()
    return want, got


def q16(x):
    return np.clip(np.rint(x * 32767.0), -32768, 32767)


def assert_lsb(want, got, lsb=1):
    assert got.shape == want.shape and got.dtype == np.float32
    assert np.isfinite(got).all()
    d = np.abs(q16(got) - q16(want))
    assert d.max() <= lsb, (f"max {d.max()} LSB, f32 max diff "
                            f"{np.abs(got - want).max():.3g}")
    return d


def _wave_voices(wave):
    """Four voices of one waveform covering pitch, phase, pan, start and
    every ADSR stage inside an 8192-frame block."""
    rng = np.random.default_rng(WAVE_NAMES.index(wave))
    out = []
    for i in range(4):
        kw = {}
        if wave == "harmonics":
            kw["harmonics"] = [1.0, 0.5, 0.33, 0.25, 0.2, 0.16, 0.14, 0.125]
        if wave == "pulse":
            kw["pulse_width"] = float(rng.uniform(0.1, 0.9))
        if wave in ("white_noise", "pluck"):
            kw["seed"] = int(rng.integers(0, 1000))
        if wave == "pluck":
            kw["damping"] = float(rng.uniform(0.3, 3.0))
        if wave == "wavetable":
            kw["table"] = tuple(float(x) for x in
                                rng.uniform(-1, 1, int(rng.integers(3, 300))))
        out.append(J.Voice(
            wave=wave, frequency=float(rng.uniform(40, 4000)),
            amplitude=float(rng.uniform(0.1, 0.3)),
            phase=float(rng.uniform(0, 1)), pan=float(rng.uniform(-1, 1)),
            start=0.02 * i, duration=float(rng.uniform(0.03, 0.1)),
            attack=0.005, decay=0.01, sustain_level=0.6, release=0.02,
            **kw))
    return out


WAVE_NAMES = sorted(J.WAVE_IDS, key=J.WAVE_IDS.get)


@pytest.mark.parametrize("wave", WAVE_NAMES)
def test_render_block_each_wave(wave):
    want, got = render_pair(_wave_voices(wave), 8192)
    assert np.abs(want).max() > 0.01
    assert_lsb(want, got)


def test_render_block_fm():
    voices = [J.Voice(w, 110.0 * (i + 1), amplitude=0.2, pan=0.3 * i - 0.6,
                      fm_frequency=3.0 + i, fm_depth=0.005 * (i + 1),
                      fm_phase=0.1 * i, duration=0.12)
              for i, w in enumerate(["sine", "triangle", "square",
                                     "sawtooth", "harmonics"])]
    voices[4] = dataclasses.replace(voices[4], harmonics=[1.0, 0.5, 0.25])
    want, got = render_pair(voices, 8192)
    assert_lsb(want, got)


def test_render_block_glide():
    voices = [J.Voice(wave=w, frequency=660.0, glide_from=330.0,
                      glide_time=0.04, start=0.005, duration=0.2,
                      amplitude=0.4)
              for w in ("sine", "sawtooth", "square", "triangle")]
    voices.append(J.Voice(wave="sine", frequency=440.0, amplitude=0.3))
    want, got = render_pair(voices, 11025)
    assert_lsb(want, got)


def test_render_block_glide_blep():
    # bandlimited saw/square under glide: the BLEP dt tracks the
    # instantaneous chirp increment
    voices = [J.Voice(wave=w, frequency=1760.0, glide_from=110.0,
                      glide_time=0.15, start=0.005, duration=0.2,
                      amplitude=0.4)
              for w in ("sawtooth_bl", "square_bl")]
    want, got = render_pair(voices, 11025)
    assert_lsb(want, got)


def test_render_block_glide_pluck_excluded():
    # a glided pluck renders EXACTLY as the same voice without glide
    base = dict(wave="pluck", frequency=440.0, start=0.005, duration=0.3,
                amplitude=0.5, seed=7)
    wg, gg = render_pair([J.Voice(glide_from=110.0, glide_time=0.05, **base)],
                         8192)
    wn, gn = render_pair([J.Voice(**base)], 8192)
    np.testing.assert_array_equal(gg, gn)
    assert_lsb(wg, gg)


@pytest.mark.parametrize("grouped", [True, False], ids=["grouped", "mixed"])
@pytest.mark.parametrize("seed", range(2))
def test_render_block_layouts(seed, grouped):
    want, got = render_pair(_rand_bank(seed), 8192, grouped=grouped)
    assert_lsb(want, got)


def test_render_block_past_2_pow_24_frames():
    # notes 400 s in: the ADSR time is the i32 note-relative frame, so
    # the envelope keeps frame resolution where f32(n) would not
    voices = [dataclasses.replace(v, start=400.0 + 0.01 * i)
              for i, v in enumerate(KERNEL_VOICES)]
    n0 = int(400.0 * SR) - 1000
    assert n0 > 2 ** 24
    want, got = render_pair(voices, 8192, n0=n0)
    assert np.abs(want).max() > 0.01
    assert_lsb(want, got)


def test_curves_and_buses_raise():
    """Curves render (through VoiceBank, against the JAX bank within 1 LSB);
    segment buses render too (ported with the sequencer): one bus and two
    against the JAX render_block(seg=) within 1 LSB.  The name is kept from
    when both raised."""
    vp = T.pack_voices(to_port(BANK_VOICES[:2]), SR, device="cpu")
    jvp = J.pack_voices(BANK_VOICES[:2], SR)
    for seg, nseg in (([0] * 8, 1), ([0, 1, 1, 0, 1, 0, 0, 1], 2)):
        want = np.asarray(J.render_block(jvp, 0, 64, SR, 8,
                                         seg=np.asarray(seg, np.int32),
                                         nseg=nseg))
        got = T.render_block(vp, 0, 64, SR, 8, seg=seg, nseg=nseg)
        assert got.shape == (64, nseg, 2)
        assert_lsb(want, got.numpy())
    voices = _special_voices()[3:]
    jbank = J.VoiceBank.for_voices(voices, SR, chunk_frames=4096)
    assert jbank.use_bend and jbank.use_amp and jbank.use_dmod
    want = np.asarray(jbank.render_song(J.pack_voices(voices, SR), 9000))
    curve = to_port(voices)
    bank = T.VoiceBank.for_voices(curve, SR, chunk_frames=4096, device="cpu")
    got = bank.render_song(T.pack_voices(curve, SR, device="cpu"), 9000)
    assert np.abs(want).max() > 0.1
    assert_lsb(want, got.numpy())
