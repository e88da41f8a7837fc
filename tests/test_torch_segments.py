"""The curve kernel's per-segment constants and per-tile segment windows,
held on the CPU through their plain versions
(synthesizer_tpu_torch.ops.kernels): ``curve_constants`` equals the
per-frame expressions of the plain render evaluated at each segment's
first frame, bit for bit, and ``tile_segment_windows`` brackets the active
segment of every frame of every tile.  What the kernel computes from them
(the depth integral regrouped around the hoisted values, the harmonics sum
without its zero weights) is held against the JAX reference's
``_dmod_delta`` and harmonics waveform on the same seeded banks.  The CUDA
kernels themselves run only on the card (chip_smoke.py holds them against
these plain versions there)."""

import dataclasses

import numpy as np
import pytest
import torch

from synthesizer_tpu.models import voicebank as J
from synthesizer_tpu_torch.models import voicebank as T
from synthesizer_tpu_torch.ops import kernels as K
from synthesizer_tpu_torch.ops.trig import cos_turns, sin_turns
from test_torch_curves import curve_voices
from test_torch_voicebank import assert_lsb, jax_fields

torch.set_num_threads(1)

SR = 44100
TILE = K.TILE
W = K.WINDOW
U32 = 0xFFFFFFFF
I32_MAX = 2 ** 31 - 1
WAVES = tuple(T.WAVE_IDS)
KINDS = ("bend", "amp", "depth", "all")


def _curves(kind, rng, points=5):
    ts = np.concatenate([[0.0], np.sort(rng.uniform(0.002, 0.2, points - 1))])
    kw = {}
    if kind in ("bend", "all"):
        kw["pitch_curve"] = tuple((float(t), float(rng.uniform(0.6, 1.7)))
                                  for t in ts)
    if kind in ("amp", "all"):
        kw["amp_curve"] = tuple((float(t), float(rng.uniform(0.0, 1.6)))
                                for t in ts)
    if kind in ("depth", "all"):
        kw["fm_frequency"] = float(rng.uniform(3.0, 9.0))
        kw["fm_phase"] = float(rng.uniform(0.0, 1.0))
        kw["fm_depth_curve"] = tuple((float(t), float(rng.uniform(0.0, 0.03)))
                                     for t in ts)
    return kw


def _bank(kind, seed, start=0.0):
    """One voice of every waveform with curves of ``kind`` and a curve-free
    voice beside every third -> packed params on the CPU."""
    rng = np.random.default_rng(seed)
    voices = []
    for i, wave in enumerate(WAVES):
        kw = {}
        if wave == "harmonics":
            kw["harmonics"] = (1.0, 0.5, 0.25)
        if wave == "wavetable":
            kw["table"] = tuple(float(x) for x in rng.uniform(-1, 1, 19))
        v = T.Voice(wave, float(rng.uniform(60, 3000)), amplitude=0.2,
                    start=start + 0.01 * i, duration=0.25, seed=i, **kw)
        voices.append(dataclasses.replace(v, **_curves(kind, rng)))
        if i % 3 == 0:
            voices.append(v)
    return T.pack_voices(voices, SR, num_harmonics=8, device="cpu")


def _f32(words):
    return words.contiguous().view(torch.float32)


def _u32(words):
    return words.to(torch.int64) & U32


@pytest.mark.parametrize("start", [0.0, 400.0], ids=["at 0", "past 2^24"])
@pytest.mark.parametrize("kind", KINDS)
def test_curve_constants_equal_the_per_frame_expressions(kind, start):
    vp = _bank(kind, KINDS.index(kind), start)
    V = vp.wave.shape[0]
    seg = K.curve_constants(vp)
    has_bend = vp.bend_start[:, 0] == 0
    has_amp = vp.acurve_start[:, 0] == 0
    has_dc = (vp.dcurve_start[:, 0] == 0) & (vp.fm_inc != 0)
    assert seg.bend.shape == (V, vp.bend_start.shape[1], 4)
    assert seg.amp.shape == (V, vp.acurve_start.shape[1], 4)
    assert seg.depth.shape == (V, vp.dcurve_start.shape[1], 8)
    assert all(x.dtype == torch.int32 for x in seg)
    want = {"bend": kind in ("bend", "all"), "amp": kind in ("amp", "all"),
            "depth": kind in ("depth", "all")}
    assert bool(has_bend.any()) == want["bend"]
    assert bool(has_amp.any()) == want["amp"]
    assert bool(has_dc.any()) == want["depth"]
    # rows without the curve's flag hold nothing
    for rows, has in zip(seg, (has_bend, has_amp, has_dc)):
        assert not rows[~has].any()

    # the packed columns, word for word
    assert torch.equal(seg.bend[has_bend][..., 0], vp.bend_start[has_bend])
    for k, f in enumerate((vp.bend_phase, vp.bend_inc, vp.bend_d), 1):
        assert torch.equal(_u32(seg.bend[has_bend][..., k]), f[has_bend])
    assert torch.equal(seg.amp[has_amp][..., 0], vp.acurve_start[has_amp])
    for k, f in enumerate((vp.acurve_g0, vp.acurve_dg), 1):
        assert torch.equal(_f32(seg.amp[has_amp][..., k]), f[has_amp])
    assert torch.equal(seg.depth[has_dc][..., 0], vp.dcurve_start[has_dc])
    for k, f in enumerate((vp.dcurve_c, vp.dcurve_a, vp.dcurve_b), 1):
        assert torch.equal(_f32(seg.depth[has_dc][..., k]), f[has_dc])

    # the hoisted LFO values: _dmod_delta's per-frame expressions at the
    # absolute frame on which each segment starts
    for v in torch.nonzero(has_dc)[:, 0].tolist():
        live = vp.dcurve_start[v] < I32_MAX
        n = int(vp.start[v]) + vp.dcurve_start[v][live].to(torch.int64)
        inc = int(vp.fm_inc[v])
        ph_n = (int(vp.fm_phase0[v]) + (n & U32) * inc) & U32
        got = seg.depth[v][live]
        assert torch.equal(_u32(got[:, 4]), ph_n)
        assert torch.equal(
            _f32(got[:, 5]),
            cos_turns(T._phase_x((ph_n - (inc >> 1)) & U32)))
        assert torch.equal(_f32(got[:, 6]), sin_turns(T._phase_x(ph_n)))
        assert torch.equal(_f32(got[:, 7]), cos_turns(T._phase_x(ph_n)))


def _depth_delta_from_hoisted(vp, n):
    """The depth integral as the curve kernel computes it: the per-segment
    words of ``curve_constants`` gathered at each frame's segment, five
    trig evaluations a frame -> f32 [V, N]."""
    seg = K.curve_constants(vp).depth
    m = n[None, :] - vp.start[:, None]
    j = T._seg_idx(vp.dcurve_start, m)

    def word(k):
        return torch.gather(seg[..., k], 1, j)

    st = word(0).to(torch.int64)
    inc = vp.fm_inc[:, None]
    half = inc >> 1
    ph_n = (vp.fm_phase0[:, None] + (n[None, :] & U32) * inc) & U32
    r1 = vp.fm_r[:, None]
    r2 = r1 * r1
    s1 = (_f32(word(5)) - cos_turns(T._phase_x((ph_n - half) & U32))) * r1
    Kc = torch.clamp_min(T._wrap_i32(m - st - 1), 0)
    xK = T._phase_x((Kc * inc) & U32)
    xKh = T._phase_x((Kc * inc + half) & U32)
    Kf = Kc.to(torch.float32)
    A = sin_turns(xK) * r2 - Kf * cos_turns(xKh) * r1
    B = Kf * sin_turns(xKh) * r1 - (1.0 - cos_turns(xK)) * r2
    s2 = _f32(word(6)) * B + _f32(word(7)) * A
    return vp.base_inc.to(torch.float32)[:, None] * (
        _f32(word(1)) + _f32(word(2)) * s1 + _f32(word(3)) * s2)


@pytest.mark.parametrize("kind", ["depth", "all"])
def test_depth_delta_from_the_hoisted_values(kind):
    # the depth integral rebuilt from the per-segment words (five trig
    # evaluations a frame) equals _dmod_delta's eight, bit for bit
    vp = _bank(kind, 7)
    n = torch.arange(0, 9000, dtype=torch.int64)
    want = T._dmod_delta(vp, n)
    got = _depth_delta_from_hoisted(vp, n)
    has_dc = (vp.dcurve_start[:, 0] == 0) & (vp.fm_inc != 0)
    assert has_dc.sum() >= 10
    assert torch.equal(got[has_dc], want[has_dc])
    assert want[has_dc].abs().max() > 0


@pytest.mark.parametrize("start", [0.0, 400.0], ids=["at 0", "past 2^24"])
@pytest.mark.parametrize("kind", ["depth", "all"])
def test_depth_delta_from_the_hoisted_values_matches_jax(kind, start):
    # the same regrouped integral against the reference's _dmod_delta, on
    # the bank the reference packed: equal as u32 phase offsets (the FM
    # offset is cast to an integer phase, so that is what reaches the
    # waveform), hence within the 1 LSB at 16 bits of test_torch_curves
    voices = curve_voices(kind, seed=5, start=start)
    vpj = J.pack_voices(voices, SR, num_harmonics=8)
    vp = T.voice_params_from_numpy(jax_fields(vpj), device="cpu")
    n0 = int(start * SR)
    n = torch.arange(n0, n0 + 6144, dtype=torch.int64)
    want = np.asarray(J._dmod_delta(vpj, np.arange(n0, n0 + 6144,
                                                   dtype=np.int32)))
    got = _depth_delta_from_hoisted(vp, n).numpy()
    has_dc = ((vp.dcurve_start[:, 0] == 0) & (vp.fm_inc != 0)).numpy()
    assert has_dc.sum() >= 10
    assert np.abs(want[has_dc]).max() > 0
    np.testing.assert_array_equal(got[has_dc].astype(np.int64),
                                  want[has_dc].astype(np.int64))


def test_segment_views_split_the_flat_buffer():
    vp = _bank("all", 3)
    seg = K.curve_constants(vp)
    flat = torch.cat([x.reshape(-1) for x in seg])
    views = K.segment_views(flat, vp.wave.shape[0], vp.bend_start.shape[1],
                            vp.acurve_start.shape[1],
                            vp.dcurve_start.shape[1])
    assert all(torch.equal(a, b) for a, b in zip(views, seg))
    assert K.SEGMENT_WORDS == tuple(x.shape[2] for x in seg)


# -- per-tile windows ------------------------------------------------------

def _patched(vp, starts, note_start=0):
    """Every curve row's starts replaced by ``starts`` (then INT32_MAX) and
    every note moved to the absolute frame(s) ``note_start``."""
    V = vp.wave.shape[0]

    def row(old):
        new = torch.full_like(old, I32_MAX)
        new[:, :len(starts)] = torch.tensor(starts, dtype=torch.int32)
        return new

    assert min(vp.bend_start.shape[1], vp.acurve_start.shape[1],
               vp.dcurve_start.shape[1]) >= len(starts)
    return vp._replace(
        start=torch.as_tensor(note_start, dtype=torch.int32).expand(V)
        .contiguous(),
        bend_start=row(vp.bend_start), acurve_start=row(vp.acurve_start),
        dcurve_start=row(vp.dcurve_start))


def _many_points():
    rng = np.random.default_rng(23)
    voices = [dataclasses.replace(
        T.Voice(w, 200.0 + 50 * i, amplitude=0.2, duration=0.3),
        **_curves("all", rng, points=9))
        for i, w in enumerate(("sine", "sawtooth_bl", "pluck", "square_bl"))]
    return T.pack_voices(voices, SR, num_harmonics=8, device="cpu")


WINDOW_CASES = {
    # name: (starts, note start, n0, nframes, expected fallback)
    "one segment a tile": ([0, 3 * TILE + 100, 6 * TILE + 100], 0, 0,
                           8 * TILE, "none"),
    "exactly the window": ([0] + [TILE + 10 + 100 * k for k in range(W - 1)]
                           + [5 * TILE + 1 + k for k in range(W - 1)], 0, 0,
                           8 * TILE, "none"),
    "one more than the window": ([0] + [2 * TILE + 7 + k for k in range(W)],
                                 0, 0, 8 * TILE, "some"),
    "starts at tile edges": ([0, TILE - 1, TILE, TILE + 1, 3 * TILE - 1,
                              3 * TILE, 4 * TILE, 4 * TILE + 1], 0, 0,
                             6 * TILE + 37, "none"),
    "tiles before the note": ([0, 100, 700, 701], 3 * TILE + 7, 0,
                              7 * TILE, "none"),
    "straddling the note start, offset window": (
        [0, 5, TILE, 2 * TILE + 3], 2 ** 24 + 1000, 2 ** 24 + 300,
        6 * TILE - 5, "none"),
    "past the last segment": ([0, 10, 20], 0, 40 * TILE, 4 * TILE, "none"),
    "unsorted row": ([0, 4 * TILE, 2 * TILE, 6 * TILE], 0, 0, 8 * TILE,
                     "all"),
    "equal starts": ([0, TILE, TILE, TILE, 2 * TILE], 0, 0, 4 * TILE,
                     "none"),
    "i32 wrap inside a tile": ([0, 100, 200], -2 ** 31 + 700, 0, 3 * TILE,
                               "some"),
}


@pytest.mark.parametrize("case", WINDOW_CASES)
def test_tile_segment_windows_bracket_every_frame(case):
    starts, note_start, n0, nframes, expect = WINDOW_CASES[case]
    vp = _patched(_many_points(), starts, note_start)
    V = vp.wave.shape[0]
    wins = K.tile_segment_windows(vp, n0, nframes)
    ntiles = -(-nframes // TILE)
    n = n0 + torch.arange(nframes, dtype=torch.int64)
    # the kernel's note-relative frame is i32: wrapped
    m = T._wrap_i32(n[None, :] - vp.start[:, None])
    pad = ntiles * TILE - nframes
    for curve, st in zip(K.CURVES, (vp.bend_start, vp.acurve_start,
                                    vp.dcurve_start)):
        first, last, fallback = wins[curve]
        assert first.shape == last.shape == fallback.shape == (V, ntiles)
        assert fallback.dtype == torch.bool
        true = T._seg_idx(st, m)
        if pad:
            true = torch.cat([true, true[:, -1:].expand(-1, pad)], dim=1)
        true = true.reshape(V, ntiles, TILE)
        assert (true >= first[:, :, None]).all()
        assert (true <= last[:, :, None]).all()
        # the window is tight where it is one: both ends are reached
        tight = ~fallback
        assert torch.equal(true.amin(dim=2)[tight], first[tight])
        assert torch.equal(true.amax(dim=2)[tight], last[tight])
        assert ((last - first)[tight] < W).all()
        assert {"none": not fallback.any(), "all": bool(fallback.all()),
                "some": bool(fallback.any()) and not fallback.all()}[expect]


def test_window_count_in_shared_memory_is_the_reference_count():
    # what the kernel does per frame: first + the count of the window's
    # other starts <= m equals the reference's count over the whole row
    starts, note_start, n0, nframes, _ = WINDOW_CASES["starts at tile edges"]
    vp = _patched(_many_points(), starts, note_start)
    first, last, fallback = K.tile_segment_windows(vp, n0, nframes)["depth"]
    assert not fallback.any()
    st = vp.dcurve_start.to(torch.int64)
    n = n0 + torch.arange(nframes, dtype=torch.int64)
    m = n[None, :] - vp.start[:, None]
    tile = torch.arange(nframes) // TILE
    f, l = first[:, tile], last[:, tile]                 # [V, N]
    got = f.clone()
    for w in range(1, W):
        j = torch.clamp_max(f + w, st.shape[1] - 1)
        got += ((f + w <= l) & (torch.gather(st, 1, j) <= m)).to(torch.int64)
    assert torch.equal(got, T._seg_idx(vp.dcurve_start, m))


def test_midi_like_bank_rarely_needs_the_fallback():
    # dense controller curves: 30 points over 0.3 s, one every 441 frames,
    # still fit a 512-frame tile's window
    rng = np.random.default_rng(4)
    voices = [dataclasses.replace(
        T.Voice("sine", 300.0 + i, amplitude=0.1, start=0.013 * i,
                duration=0.3), **_curves("all", rng, points=30))
        for i in range(6)]
    vp = T.pack_voices(voices, SR, num_harmonics=8, device="cpu")
    layout = T.BankLayout.ungrouped(vp.wave.shape[0], 8)
    nframes = int(0.5 * SR)
    act = K.active_voice_tiles(vp, 0, nframes, samplerate=SR, layout=layout)
    need = K.curve_voices(vp, layout, use_bend=True, use_amp=True,
                          use_dmod=True)
    assert need[:, :6].all()
    wins = K.tile_segment_windows(vp, 0, nframes)
    for curve in K.CURVES:
        first, last, fallback = wins[curve]
        assert (last - first)[act].max() >= 1
        assert fallback[act].float().mean() < 0.05


def test_curve_voices_follow_flags_modes_and_pluck():
    rng = np.random.default_rng(2)
    voices = [dataclasses.replace(T.Voice(w, 440.0, amplitude=0.1),
                                  **_curves("all", rng))
              for w in ("sine", "pluck", "sawtooth_bl")]
    voices.append(T.Voice("sine", 220.0, amplitude=0.1))
    vp = T.pack_voices(voices, SR, num_harmonics=8, device="cpu")
    V = vp.wave.shape[0]                  # packing pads the bank
    layout = T.BankLayout.ungrouped(V, 8)
    need = K.curve_voices(vp, layout, use_bend=True, use_amp=True,
                          use_dmod=True)
    assert need.shape == (3, V) and need.dtype == torch.bool
    assert not need[:, 3:].any()
    assert need[0, :3].tolist() == [True, False, True]      # pluck: no bend
    assert need[1, :3].tolist() == [True, True, True]
    assert need[2, :3].tolist() == [True, True, True]
    off = K.curve_voices(vp, layout)
    assert not off.any()
    only = K.curve_voices(vp, layout, use_amp=True)
    assert only[1].any() and not only[0].any() and not only[2].any()


@pytest.mark.parametrize("weights", [
    (1.0, 0.0, 0.33, 0.0, 0.2, 0.0, 0.0, 0.0),
    (0.0, 0.0, 0.0, 0.0, 0.0, 0.0, 0.0, 0.0),
    (-0.0, 0.5, -0.0, 0.25, 0.0, 0.0, 0.0, 0.125),
], ids=["some zero", "all zero", "negative zero"])
def test_a_harmonic_of_weight_zero_changes_no_bit(weights):
    # what the curve kernel skips: w + h * sin(...) with h == +-0 leaves w
    # as it was, because w starts at +0 and a sum is -0 only from two -0
    rng = np.random.default_rng(11)
    p = torch.from_numpy(rng.integers(0, 2 ** 32, 4096, dtype=np.int64))
    full = torch.zeros(4096, dtype=torch.float32)
    skipped = torch.zeros(4096, dtype=torch.float32)
    for k, h in enumerate(weights, start=1):
        term = np.float32(h) * sin_turns(T._phase_x((p * k) & U32))
        full = full + term
        if h != 0.0:
            skipped = skipped + term
    assert torch.equal(full.view(torch.int32), skipped.view(torch.int32))
    assert not ((full == 0) & (full.view(torch.int32) != 0)).any()   # no -0
    # and the sum without its zero weights is the reference's harmonics
    # waveform on the same phases, within 1 LSB at 16 bits
    vpj = J.pack_voices([J.Voice("harmonics", 440.0, harmonics=weights)], SR,
                        num_harmonics=8)
    want = np.asarray(J._one_wave(8, p.numpy().astype(np.uint32)[None, :],
                                  vpj, None, 8))[0]
    assert_lsb(want, skipped.numpy())


def test_wrapper_layout_constants_agree():
    assert K.WINDOW == 4 and K.COUNTS == 3
    assert K.CURVES == ("bend", "amp", "depth")
    assert K.render_stereo.windows is None       # no launch on the CPU
