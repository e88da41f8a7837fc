"""The render kernel's culling of silent voice-tiles and its setup
kernel's per-voice constants, held on the CPU through their plain
versions (synthesizer_tpu_torch.ops.kernels): ``active_voice_tiles`` is
exact (a voice it drops has an envelope of exactly 0 on the whole tile)
and tight, dropping those voices from the serial sum changes no bit,
voices that could make non-finite samples are never dropped, and
``voice_constants`` equals the JAX package's formulas.  The CUDA kernels
themselves run only on the card (chip_smoke.py holds them against these
plain versions there)."""

import inspect

import numpy as np
import pytest
import torch

from synthesizer_tpu.models import voicebank as J
from synthesizer_tpu_torch import bench_song
from synthesizer_tpu_torch.models import voicebank as T
from synthesizer_tpu_torch.ops import kernels as K
from synthesizer_tpu_torch.ops import trig as TRIG
from test_pallas_kernel import VOICES

SR = 44100
TILE = K.TILE
SR_R = float(np.float32(1.0 / SR))


def _packed(voices, grouped=True, H=8):
    if grouped:
        return T.pack_voices(voices, SR, num_harmonics=H, sort_by_wave=True,
                             device="cpu")
    vp = T.pack_voices(voices, SR, num_harmonics=H, device="cpu")
    return vp, T.BankLayout.ungrouped(vp.wave.shape[0], H)


def _edge_voices():
    """Every waveform with attack, decay, release or gate 0 in turn."""
    rng = np.random.default_rng(17)
    voices = []
    for w in T.WAVE_IDS:
        for j, zero in enumerate(("attack", "decay", "release", "duration")):
            kw = dict(attack=0.004, decay=0.006, sustain_level=0.7,
                      release=0.003)
            kw[zero] = 0.0
            if w == "harmonics":
                kw["harmonics"] = [1.0, 0.5, 0.25]
            if w == "wavetable":
                kw["table"] = tuple(rng.uniform(-1, 1, 40))
            voices.append(T.Voice(w, float(rng.uniform(60, 3000)),
                                  amplitude=0.2, pan=0.2 * j - 0.3,
                                  seed=j, **kw))
    return voices


def _edge_bank(shift, grouped=True):
    """Notes starting on, one frame before and one after a tile boundary
    (relative to frame ``shift``) and ending near one; exact frames
    patched in after packing."""
    vp, ly = _packed(_edge_voices(), grouped)
    i = np.arange(vp.wave.shape[0])
    start = shift + TILE * (1 + i % 5) + (i % 3) - 1
    gate = np.where(vp.gate.numpy() == 0, 0,
                    TILE * (1 + (i // 3) % 3) + (i // 9) % 3 - 1)
    return vp._replace(start=torch.tensor(start, dtype=torch.int32),
                       gate=torch.tensor(gate, dtype=torch.int32)), ly


def _case(name):
    """-> (vp, layout, n0, nframes)"""
    if name == "kernel_voices":
        vp, ly = _packed(VOICES)
        return vp, ly, 0, 3 * SR // 10
    if name == "song":
        vp, ly = _packed(bench_song.build_song(64, 2.0, SR))
        return vp, ly, 0, 2 * SR
    if name in ("edges", "edges_mixed"):
        vp, ly = _edge_bank(0, grouped=name == "edges")
        return vp, ly, 0, 9 * TILE + 37
    if name == "edges_offset":
        vp, ly = _edge_bank(0)
        return vp, ly, 300, 8 * TILE + 1
    if name == "edges_cut":
        # the window ends 2 frames before a tile boundary, where notes
        # start one frame before, on and after it
        vp, ly = _edge_bank(0)
        return vp, ly, 0, 3 * TILE - 2
    if name == "edges_past_2^24":
        n0 = 2 ** 24 + 3 * TILE + 3
        vp, ly = _edge_bank(n0 - TILE)
        return vp, ly, n0, 8 * TILE
    raise KeyError(name)


CASES = ("kernel_voices", "song", "edges", "edges_mixed", "edges_offset",
         "edges_cut", "edges_past_2^24")


def _tiles(x, nframes):
    """[V, N] -> [V, ntiles, TILE] (the last tile padded by repeating its
    last frame)."""
    ntiles = -(-nframes // TILE)
    pad = ntiles * TILE - nframes
    if pad:
        x = torch.cat([x, x[:, -1:].expand(-1, pad)], dim=1)
    return x.reshape(x.shape[0], ntiles, TILE)


@pytest.mark.parametrize("case", CASES)
def test_active_voice_tiles_is_exact(case):
    vp, ly, n0, nframes = _case(case)
    act = K.active_voice_tiles(vp, n0, nframes, samplerate=SR, layout=ly)
    assert act.dtype == torch.bool
    assert act.shape == (vp.wave.shape[0], -(-nframes // TILE))
    n = n0 + torch.arange(nframes, dtype=torch.int64)
    env = _tiles(T._adsr(n, vp, SR), nframes)
    silent = ~act
    assert silent.any() and act.any()
    # exactly +0 on every frame of every dropped voice-tile
    dropped = env[silent]
    assert torch.equal(dropped, torch.zeros_like(dropped))
    assert not torch.signbit(dropped).any()


@pytest.mark.parametrize("case", ["song", "edges", "edges_cut",
                                  "edges_past_2^24"])
def test_active_voice_tiles_is_tight(case):
    # a voice is kept on at most the tiles its audible range [start,
    # start + t4) touches: its audible frames plus one tile at each edge
    vp, ly, n0, nframes = _case(case)
    act = K.active_voice_tiles(vp, n0, nframes, samplerate=SR, layout=ly)
    c = K.voice_constants(vp, SR, ly.num_harmonics)
    t4 = c[:, K.CONST_COLUMNS.index("t4")].view(torch.float32)[:, None]
    n = n0 + torch.arange(nframes, dtype=torch.int64)
    t = (n[None, :] - vp.start[:, None]).to(torch.float32) * SR_R
    audible = ((t >= 0) & (t < t4)).sum(dim=1)
    kept = act.sum(dim=1)
    assert (kept * TILE <= audible + 2 * TILE).all()
    assert (kept[audible > 0] > 0).all()
    assert (kept[audible == 0] == 0).all()


def _culled_sum(vp, ly, n0, nframes, act):
    """The kernel's sum, emulated: each voice's contribution (render_block
    of that voice alone) added serially in packed order, on the tiles
    where ``act`` keeps it."""
    acc = torch.zeros((nframes, 2), dtype=torch.float32)
    keep = act.repeat_interleave(TILE, dim=1)[:, :nframes]
    for (wid, has_fm, start, count) in ly.groups:
        for v in range(start, start + count):
            one = T.BankLayout(((wid, has_fm, v, 1),), ly.nvoices,
                               ly.num_harmonics)
            part = T.render_block(vp, n0, nframes, SR, ly.num_harmonics, one)
            acc[keep[v]] += part[keep[v]]
    return acc


@pytest.mark.parametrize("case", ["kernel_voices", "edges", "edges_mixed",
                                  "edges_offset"])
def test_culling_changes_no_bit(case):
    vp, ly, n0, nframes = _case(case)
    act = K.active_voice_tiles(vp, n0, nframes, samplerate=SR, layout=ly)
    want = T.render_block(vp, n0, nframes, SR, ly.num_harmonics, ly)
    got = _culled_sum(vp, ly, n0, nframes, act)
    assert torch.isfinite(want).all() and want.abs().max() > 0.01
    assert torch.equal(got, want)


def _poisoned():
    """A bank in which five voices could make non-finite samples on their
    silent frames, with their packed indices."""
    voices = [T.Voice(w, 220.0 * (1 + i), amplitude=0.2, duration=0.002,
                      start=0.001 * i, release=0.001, damping=1.0, seed=i,
                      harmonics=[1.0, 0.5], table=(0.0, 1.0, 0.0, -1.0))
              for i, w in enumerate(("sine", "square", "harmonics",
                                     "wavetable", "pluck", "triangle"))]
    vp, ly = _packed(voices)
    wave = vp.wave.numpy()
    first = {w: int(np.flatnonzero(wave == w)[0]) for w in (0, 2, 8, 11, 12)}
    amp, bias = vp.amp.clone(), vp.bias.clone()
    harm, table, damping = (vp.harm_amps.clone(), vp.table.clone(),
                            vp.damping.clone())
    amp[first[0]] = float("inf")
    bias[first[2]] = float("nan")
    harm[first[8], 1] = float("-inf")
    table[first[11], :] = float("nan")
    damping[first[12]] = -1.0
    vp = vp._replace(amp=amp, bias=bias, harm_amps=harm, table=table,
                     damping=damping)
    return vp, ly, first


def test_cull_safety_flags():
    vp, ly, first = _poisoned()
    flags = K.voice_constants(vp, SR, 8)[:, K.CONST_COLUMNS.index("flags")]
    for w in (0, 2, 8, 11):
        assert flags[first[w]] & K.FLAG_SAFE == 0, w
    assert flags[first[12]] & K.FLAG_PLUCK_SAFE == 0
    assert flags[first[12]] & K.FLAG_SAFE            # only pluck is unsafe
    poisoned = set(first.values())
    for v in range(vp.wave.shape[0]):
        if v not in poisoned:
            assert flags[v] & K.FLAG_SAFE and flags[v] & K.FLAG_PLUCK_SAFE
    # far past every note: the poisoned voices are still evaluated,
    # every other voice is dropped
    n0, nframes = SR, 2 * TILE
    act = K.active_voice_tiles(vp, n0, nframes, samplerate=SR, layout=ly)
    assert act[sorted(poisoned)].all()
    others = [v for v in range(vp.wave.shape[0]) if v not in poisoned]
    assert not act[others].any()
    # ... and the plain version really gives non-finite samples there,
    # which the kernel must reproduce
    for w, v in first.items():
        one = T.BankLayout(((w, False, v, 1),), ly.nvoices, 8)
        out = T.render_block(vp, n0, nframes, SR, 8, one)
        assert not torch.isfinite(out).all(), w
    got = _culled_sum(vp, ly, n0, nframes, act)
    want = T.render_block(vp, n0, nframes, SR, 8, ly)
    assert torch.equal(torch.isnan(got), torch.isnan(want))
    assert torch.isnan(want).all()


def test_flags_bound_values_not_only_finiteness():
    vp, ly = _packed(VOICES[:4])
    big = vp.amp.clone()
    big[0] = 3e38                       # finite, but amp * w can overflow
    c = K.voice_constants(vp._replace(amp=big), SR, 8)
    flags = c[:, K.CONST_COLUMNS.index("flags")]
    assert flags[0] & K.FLAG_SAFE == 0 and flags[1] & K.FLAG_SAFE


def _jax_fields(voices, H=8):
    vpj, ly = J.pack_voices(voices, SR, num_harmonics=H, sort_by_wave=True)
    fields = {k: np.asarray(v) for k, v in vpj._asdict().items()}
    return fields, T.voice_params_from_numpy(fields, device="cpu")


def _noise_u32(idx, seed):
    x = (idx.astype(np.uint64) * 0x9E3779B9 + seed) & 0xFFFFFFFF
    x ^= x >> 16
    x = (x * 0x7FEB352D) & 0xFFFFFFFF
    x ^= x >> 15
    x = (x * 0x846CA68B) & 0xFFFFFFFF
    x ^= x >> 16
    return x.astype(np.uint32)


def test_voice_constants_match_jax_formulas():
    """ADSR and pluck terms against a numpy f32 recomputation of
    synthesizer_tpu/models/voicebank.py::_adsr and the pluck branch of
    _one_wave, on fields the JAX package packed.  The sum over partials
    is taken serially in k order (the port's and the kernel's order)."""
    rng = np.random.default_rng(3)
    voices = list(VOICES) + [
        J.Voice("pluck", float(f), amplitude=0.3, seed=int(s),
                damping=float(d), duration=float(g), attack=float(a),
                decay=float(dc), release=float(r))
        for f, s, d, g, a, dc, r in zip(
            rng.uniform(50, 9000, 12), rng.integers(0, 999, 12),
            rng.uniform(0.1, 4, 12), rng.uniform(0, 0.5, 12),
            rng.uniform(0, 0.05, 12), rng.uniform(0, 0.1, 12),
            rng.uniform(0, 0.2, 12))]
    f, vp = _jax_fields(voices)
    H, K_ = 8, 8
    c = K.voice_constants(vp, SR, H)
    assert c.shape == (len(f["wave"]), K.const_width(H)) and c.dtype == torch.int32
    col = {name: c[:, j].numpy() for j, name in enumerate(K.CONST_COLUMNS)}

    def bits(x):
        return np.asarray(x, np.float32).view(np.int32)

    f32 = np.float32
    sr_r = f32(1.0 / SR)
    a = np.maximum(f["attack"], f32(0))
    d = np.maximum(f["decay"], f32(0))
    r = np.maximum(f["release"], f32(0))
    gate = f["gate"].astype(np.float32) * sr_r
    s = np.maximum(gate - a - d, f32(0))
    t2 = a + d
    t4 = t2 + s + r
    t3 = t2 + s
    eps = f32(1e-30)
    want = dict(a=a, t2=t2, t3=t3, t4=t4, sl=f["sustain_level"],
                a_r=f32(1) / np.maximum(a, eps), d_r=f32(1) / np.maximum(d, eps),
                r_r=f32(1) / np.maximum(r, eps),
                lg=np.minimum(f32(1) - f["pan"], f32(1)),
                rg=np.minimum(f32(1) + f["pan"], f32(1)),
                fm_scale=f["base_inc"].astype(np.float32) * f["fm_depth"])
    for name, w in want.items():
        np.testing.assert_array_equal(col[name], bits(w), err_msg=name)

    inc = f["base_inc"]
    ratio = inc.astype(np.float32) * f32(2.0 ** -32)
    ks = np.arange(1, K_ + 1, dtype=np.uint32)
    u = ((_noise_u32(np.broadcast_to(ks, (len(inc), K_)), f["seed"][:, None])
          >> 8).astype(np.float32) * f32(2.0 ** -23) - f32(1))
    lim = np.asarray([(2 ** 31 - 1) // k for k in range(1, K_ + 1)], np.uint32)
    active = (inc[:, None] <= lim) & (inc[:, None] > 0)
    denom = np.zeros(len(inc), np.float32)
    for j in range(K_):
        denom = denom + np.abs(u[:, j]) * active[:, j]
    denom = np.maximum(denom, eps)
    phi = _noise_u32(np.broadcast_to(np.arange(K_ + 1, 2 * K_ + 1,
                                               dtype=np.uint32),
                                     (len(inc), K_)), f["seed"][:, None])
    # g = cos(pi*k*ratio), the JAX formula, in f64.  The port and the
    # kernel evaluate it as the turn-unit polynomial cos_turns(k*ratio/2)
    # (ops/trig.py), within G_ERR of cos: 8.70e-7 at most, measured on a
    # sweep of the pluck's [0, 0.25] turns (the polynomial's minimax error
    # is 7.8e-7; the f32 rounding of the argument adds the rest)
    G_ERR = 9e-7
    sweep = np.linspace(0.0, 0.25, 200_001, dtype=np.float32)
    assert np.abs(TRIG.cos_turns(torch.from_numpy(sweep)).numpy()
                  - np.cos(2.0 * np.pi * sweep.astype(np.float64))
                  ).max() <= G_ERR
    g = np.cos(np.pi * ks.astype(np.float64)
               * ratio[:, None].astype(np.float64))
    alpha = (f["damping"][:, None] * ratio[:, None]
             * np.log(np.maximum(g, eps)))
    parts = c[:, K.CONST_BASE:].numpy().reshape(-1, K_, 3)
    np.testing.assert_array_equal(col["pluck_ka"], active.sum(axis=1))
    np.testing.assert_array_equal(
        parts[..., 0], np.where(active, bits(u / denom[:, None]), 0))
    np.testing.assert_array_equal(
        parts[..., 1], np.where(active, phi.view(np.int32), 0))
    # alpha = damping * ratio * log(g): an error dg in g moves log(g) by
    # dg/g, and the port's log_f32 is within a few f32 ulps of log
    # (relative) and, near g = 1, 2^-23 absolute; all scaled by
    # |damping * ratio|
    got_alpha = parts[..., 2].view(np.float32)[active]
    scale = np.abs(f["damping"][:, None] * ratio[:, None]
                   * np.ones_like(alpha))[active]
    err = np.abs(got_alpha.astype(np.float64) - alpha[active])
    assert (err <= scale * (G_ERR / g[active] + 2.0 ** -23)
            + np.abs(alpha[active]) * 2.0 ** -21).all()
    assert np.all(parts[..., 2][~active] == 0)
    assert (f["wave"] == 12).sum() >= 12 and active[f["wave"] == 12].any()


def test_voice_constants_u32_words():
    rng = np.random.default_rng(8)
    voices = [J.Voice(w, float(rng.uniform(50, 4000)), amplitude=0.2,
                      glide_from=float(rng.uniform(50, 4000)),
                      glide_time=float(rng.uniform(0.001, 0.2)),
                      pulse_width=float(rng.uniform(0.05, 0.95)),
                      fm_frequency=3.0, fm_depth=0.01 * (i % 2), seed=i)
              for i, w in enumerate(["sine", "pulse", "sawtooth_bl",
                                     "square", "pulse", "triangle"])]
    f, vp = _jax_fields(voices)
    c = K.voice_constants(vp, SR, 8)
    col = {name: c[:, j].numpy() for j, name in enumerate(K.CONST_COLUMNS)}
    u32 = lambda x: np.asarray(x, np.uint64).astype(np.uint32).view(np.int32)
    G = f["glide_frames"].astype(np.uint64)
    inc0, gd = f["glide_inc0"].astype(np.uint64), f["glide_d"].astype(np.uint64)
    tri = np.where(G % 2 == 0, (G // 2) * ((G - 1) % 2 ** 32),
                   G * (((G - 1) % 2 ** 32) // 2))
    np.testing.assert_array_equal(col["phase_g"],
                                  u32((inc0 * G + gd * tri) % 2 ** 32))
    np.testing.assert_array_equal(col["inc_g"], u32((inc0 + gd * G) % 2 ** 32))
    np.testing.assert_array_equal(
        col["pulse_wu"],
        u32((f["pulse_width"] * np.float32(2.0 ** 32)).astype(np.uint64)))
    for name in ("wave", "start", "noise_hold", "glide_frames"):
        np.testing.assert_array_equal(col[name], f[name], err_msg=name)
    for name, field in (("inc", "base_inc"), ("phase0", "phase0"),
                        ("fm_inc", "fm_inc"), ("seed", "seed")):
        np.testing.assert_array_equal(col[name], u32(f[field]), err_msg=name)
    fm_on = (f["fm_depth"] != 0) & (f["fm_inc"] != 0)
    assert fm_on.any() and not fm_on.all()
    np.testing.assert_array_equal((col["flags"] & K.FLAG_FM_ON) != 0, fm_on)


def test_entry_points_default_to_the_card(monkeypatch):
    for fn in (T.pack_voices, T.voice_params_from_numpy, T.VoiceBank,
               T.VoiceBank.for_voices):
        assert inspect.signature(fn).parameters["device"].default == "cuda"
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    voices = bench_song.build_song(8, 1.0, SR)
    fields = {k: np.asarray(v) for k, v in
              J.pack_voices(VOICES, SR)._asdict().items()}
    for call in (lambda: T.pack_voices(voices, SR),
                 lambda: T.pack_voices(voices, SR, sort_by_wave=True),
                 lambda: T.voice_params_from_numpy(fields),
                 lambda: T.VoiceBank(8, SR),
                 lambda: T.VoiceBank.for_voices(voices, SR),
                 lambda: bench_song.song_bank(8, 1.0)):
        with pytest.raises(RuntimeError, match="device='cpu'"):
            call()
    # asked for explicitly, the CPU works
    vp = T.pack_voices(voices, SR, device="cpu")
    assert vp.device.type == "cpu"
    assert T.VoiceBank.for_voices(voices, SR, device="cpu").device.type == "cpu"


def test_edge_bank_covers_the_edges():
    vp, _ = _edge_bank(0)
    assert {int(x) % TILE for x in vp.start} == {TILE - 1, 0, 1}
    ends = vp.start + vp.gate
    assert {int(x) % TILE for x in ends[vp.gate > 0]} >= {TILE - 2, 0, 2}
    for field in (vp.attack, vp.decay, vp.release, vp.gate):
        assert (field == 0).any()
    assert set(vp.wave.tolist()) == set(T.ALL_WAVES)
