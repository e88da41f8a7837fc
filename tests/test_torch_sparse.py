"""The port's sparse bucketed render (VoiceBank.sparse_plan,
render_song_sparse) against the JAX reference (mirrors
tests/test_sparse_render.py): the plan's rows equal the reference's
exactly; the sparse render equals the port's flat render bit for bit (a
dropped row adds an exact zero to the serial sum) and the reference's
sparse render within 1 LSB at int16; and the render kernel's test of
candidate voices from the rows (active_voice_tiles with idx) is exact."""

import numpy as np
import pytest
import torch

from synthesizer_tpu.models import voicebank as J
from synthesizer_tpu_torch.models import voicebank as T
from synthesizer_tpu_torch.ops import kernels as K
from test_sparse_render import _sparse_voices, _total
from test_torch_voicebank import to_port

torch.set_num_threads(1)

SR = 44100


def _curve_song():
    voices = _sparse_voices(40, seed=3)
    voices[5] = J.Voice(wave="sine", frequency=440.0, amplitude=0.2,
                        start=voices[5].start, duration=1.5, attack=0.01,
                        decay=0.05, sustain_level=0.8, release=0.3,
                        pitch_curve=((0.0, 1.0), (0.5, 1.0), (1.0, 1.06)),
                        amp_curve=((0.0, 1.0), (0.8, 1.0), (1.4, 0.2)))
    voices[11] = J.Voice(wave="triangle", frequency=330.0, amplitude=0.2,
                         start=voices[11].start, duration=1.2, attack=0.01,
                         decay=0.05, sustain_level=0.8, release=0.2,
                         fm_frequency=5.5,
                         fm_depth_curve=((0.0, 0.0), (0.4, 0.0),
                                         (1.0, 0.012)))
    return voices


def _long_attack_song():
    voices = [J.Voice(wave="sine", frequency=440.0, amplitude=0.3, start=0.5,
                      duration=0.05, attack=0.8, decay=0.2,
                      sustain_level=0.7, release=0.3)]
    voices += [J.Voice(wave="sine", frequency=200.0 + i, amplitude=0.05,
                       start=3.0 + 0.2 * i, duration=0.1, release=0.05)
               for i in range(40)]
    return voices


def _gap_song():
    voices = [J.Voice(wave="sine", frequency=440.0, amplitude=0.3,
                      start=0.0, duration=0.1, release=0.05),
              J.Voice(wave="sine", frequency=550.0, amplitude=0.3,
                      start=5.0, duration=0.1, release=0.05)]
    return voices + [J.Voice(amplitude=0.0, frequency=0.0, duration=0.0)] * 30


#: name -> (voices, chunk, total frames)
SONGS = {
    "sparse": lambda: (_sparse_voices(), 8192, _total(_sparse_voices())),
    "curves": lambda: (_curve_song(), 8192, _total(_curve_song())),
    "chunk2048": lambda: (_sparse_voices(50, seed=7), 2048,
                          _total(_sparse_voices(50, seed=7))),
    "long_attack": lambda: (_long_attack_song(), 2048, int(12.0 * SR)),
    "gap": lambda: (_gap_song(), 4096, int(5.5 * SR)),
}


def _banks(voices, chunk):
    vpj, ly = J.pack_voices(voices, SR, num_harmonics=8, sort_by_wave=True)
    jbank = J.VoiceBank.for_voices(voices, SR, num_harmonics=8,
                                   chunk_frames=chunk, layout=ly,
                                   nvoices=ly.nvoices)
    tv = to_port(voices)
    vpt, tly = T.pack_voices(tv, SR, num_harmonics=8, sort_by_wave=True,
                             device="cpu")
    tbank = T.VoiceBank.for_voices(tv, SR, num_harmonics=8,
                                   chunk_frames=chunk, layout=tly,
                                   nvoices=tly.nvoices, device="cpu")
    return jbank, vpj, tbank, vpt


@pytest.fixture(scope="module", params=sorted(SONGS))
def song(request):
    voices, chunk, total = SONGS[request.param]()
    return (request.param,) + _banks(voices, chunk) + (total,)


def test_sparse_plan_matches_reference(song):
    _, jbank, vpj, tbank, vpt, total = song
    want = jbank.sparse_plan(vpj, total)
    got = tbank.sparse_plan(vpt, total)
    assert want is not None and got is not None
    _, widx, wpad, wn = want
    _, gidx, gpad, gn = got
    assert gidx.dtype == torch.int32 and gidx.device.type == "cpu"
    np.testing.assert_array_equal(gidx.numpy(), np.asarray(widx))
    assert (gpad, gn) == (wpad, wn)


def test_sparse_equals_flat_bit_for_bit(song):
    name, jbank, vpj, tbank, vpt, total = song
    flat = tbank.render_song(vpt, total)
    sparse = tbank.render_song_sparse(vpt, total)
    assert sparse.shape == (total, 2) and torch.isfinite(sparse).all()
    assert torch.equal(sparse, flat)
    want = np.asarray(jbank.to_int16(jbank.render_song_sparse(vpj, total)))
    got = T.VoiceBank.to_int16(sparse).numpy()
    d = np.abs(got.astype(np.int32) - want.astype(np.int32))
    assert d.max() <= 1, d.max()
    assert np.abs(got).max() > 1000
    if name == "gap":
        # 1 s .. 4 s: nothing sounds, every sample an exact zero
        assert torch.equal(sparse[SR:4 * SR], torch.zeros(3 * SR, 2))
        assert sparse[int(5.0 * SR):int(5.2 * SR)].abs().max() > 0
    if name == "long_attack":
        # the long-attack voice rings well past gate + release
        assert np.abs(got[int(1.3 * SR):int(1.5 * SR)]).max() > 500


def test_plan_ranges_from_notes_match_reference():
    # render_notes' ranges come from the note list (one frame of margin)
    from synthesizer_tpu_torch import midi as TM
    voices = _sparse_voices(60, seed=4)
    vpj = J.pack_voices(voices, SR, num_harmonics=8)
    V = int(vpj.start.shape[0])
    starts, ends, live = TM.note_ranges(to_port(voices), V, SR)
    for i, v in enumerate(voices):          # the reference's midi.py:656-662
        s = int(v.start * SR)
        ad = int(np.ceil((v.attack + v.decay) * SR)) + 1
        dur = max(int(v.duration * SR), ad) + int(np.ceil(v.release * SR)) + 1
        assert (starts[i], ends[i]) == (s, s + dur + 2 + (dur >> 20))
    assert live[:len(voices)].all() and not live[len(voices):].any()
    jb = J.VoiceBank.for_voices(voices, SR, num_harmonics=8, nvoices=V)
    tb = T.VoiceBank.for_voices(to_port(voices), SR, num_harmonics=8,
                                nvoices=V, device="cpu")
    vpt = T.pack_voices(to_port(voices), SR, num_harmonics=8, device="cpu")
    total = _total(voices)
    _, widx, _, _ = jb.sparse_plan(vpj, total, ranges=(starts, ends, live))
    _, gidx, _, _ = tb.sparse_plan(vpt, total, ranges=(starts, ends, live))
    np.testing.assert_array_equal(gidx.numpy(), np.asarray(widx))


def test_sparse_dense_bank_falls_back():
    voices = [J.Voice(wave="sine", frequency=220.0 * (1 + 0.1 * i),
                      amplitude=0.05, start=0.0, duration=1.0)
              for i in range(16)]
    jbank, vpj, tbank, vpt = _banks(voices, 8192)
    total = int(1.2 * SR)
    assert jbank.sparse_plan(vpj, total) is None
    assert tbank.sparse_plan(vpt, total) is None
    assert torch.equal(tbank.render_song_sparse(vpt, total),
                       tbank.render_song(vpt, total))


def test_pad_voice_is_silent_and_keeps_dtypes():
    vp = T.pack_voices(to_port(_curve_song()[:8]), SR, device="cpu")
    padded = T._append_pad_voice(vp, 12345)
    for name, a, b in zip(T.VoiceParams._fields, vp, padded):
        assert b.dtype == a.dtype and b.shape[1:] == a.shape[1:], name
        assert b.shape[0] == a.shape[0] + 1 and torch.equal(b[:-1], a), name
    assert int(padded.start[-1]) == 12345
    assert float(padded.amp[-1]) == 0.0 and int(padded.gate[-1]) == 0
    one = T.VoiceParams(*(f[-1:] for f in padded))
    out = T.render_block(one, 0, 20000, SR, 8, use_bend=True, use_amp=True,
                         use_dmod=True)
    assert torch.equal(out, torch.zeros_like(out))


def _rows_case():
    """A window of the curve song with sparse rows: (bank, vp, layout, idx,
    n0, nframes)."""
    voices, chunk, total = SONGS["curves"]()
    tv = to_port(voices)
    vp = T.pack_voices(tv, SR, num_harmonics=8, device="cpu")
    bank = T.VoiceBank.for_voices(tv, SR, num_harmonics=8, chunk_frames=2048,
                                  nvoices=vp.wave.shape[0], device="cpu")
    _, idx, _, _ = bank.sparse_plan(vp, total)
    layout = T.BankLayout.ungrouped(vp.wave.shape[0], bank.num_harmonics,
                                    bank.use_fm)
    # the window around the bent, amp-curved voice 5
    n0 = int(vp.start[5]) // 2048 * 2048
    return bank, vp, layout, idx, n0, 6 * 2048


def test_render_stereo_rows_equal_sparse_path():
    bank, vp, layout, idx, n0, nframes = _rows_case()
    flags = bank._flags()
    got = K.render_stereo(vp, n0, nframes=nframes, samplerate=SR,
                          layout=layout, idx=idx, chunk_frames=2048, **flags)
    nchunks = idx.shape[0]
    full = bank._render_rows(vp, idx, 0, nchunks)
    assert torch.equal(got, full[n0:n0 + nframes])
    flat = K.render_stereo(vp, n0, nframes=nframes, samplerate=SR,
                           layout=layout, **flags)
    assert torch.equal(got, flat) and got.abs().max() > 0.05


def test_active_voice_tiles_with_rows_and_amp_curves():
    bank, vp, layout, idx, n0, nframes = _rows_case()
    act = K.active_voice_tiles(vp, n0, nframes, samplerate=SR, layout=layout,
                               idx=idx, chunk_frames=2048)
    dense = K.active_voice_tiles(vp, n0, nframes, samplerate=SR,
                                 layout=layout)
    assert act.shape == dense.shape and not (act & ~dense).any()
    assert act.sum() < dense.sum() or not (dense & ~act).any()
    flags = K.voice_constants(vp, SR, 8)[:, K.CONST_COLUMNS.index("flags")]
    amp_voices = torch.nonzero(flags & K.FLAG_AMP).flatten()
    assert len(amp_voices) == 1 and act[amp_voices].any()
    assert (flags[amp_voices] & K.FLAG_SAFE).all()
    # the kernel's sum, emulated: each voice's contribution added serially
    # in packed order on the tiles the test keeps, equals the render
    T_ = K.TILE
    keep = act.repeat_interleave(T_, dim=1)[:, :nframes]
    acc = torch.zeros((nframes, 2), dtype=torch.float32)
    for v in range(vp.wave.shape[0]):
        if keep[v].any():
            one = T.BankLayout(((-1, bank.use_fm, v, 1),), layout.nvoices, 8)
            part = T.render_block(vp, n0, nframes, SR, 8, one,
                                  **bank._flags())
            acc[keep[v]] += part[keep[v]]
    want = K.render_stereo(vp, n0, nframes=nframes, samplerate=SR,
                           layout=layout, idx=idx, chunk_frames=2048,
                           **bank._flags())
    assert torch.equal(acc, want)


def test_amp_curve_cull_safety():
    voices = [T.Voice("sine", 440.0, amplitude=0.2, duration=0.05,
                      amp_curve=((0.0, 1.0), (0.01, g)))
              for g in (0.5, 5e9, 1e10)]
    voices.append(T.Voice("sine", 440.0, amplitude=0.2, duration=0.05,
                          amp_curve=((0.0, 1.0), (0.01, 2.0))))
    vp = T.pack_voices(voices, SR, device="cpu")
    flags = K.voice_constants(vp, SR, 8)[:, K.CONST_COLUMNS.index("flags")]
    safe = (flags & K.FLAG_SAFE) != 0
    assert safe[0] and safe[3]
    assert not safe[1] and not safe[2]          # a gain past 2^32
    assert ((flags[:4] & K.FLAG_AMP) != 0).all()
    assert ((flags & K.FLAG_AMP_SORTED) != 0).all()
    # a row whose starts are not sorted is not cull-safe, and the search
    # takes the count
    st = vp.acurve_start.clone()
    st[0, 1] = -5
    f2 = K.voice_constants(vp._replace(acurve_start=st), SR, 8)
    f2 = f2[:, K.CONST_COLUMNS.index("flags")]
    assert not f2[0] & K.FLAG_SAFE and not f2[0] & K.FLAG_AMP_SORTED
    # far past the notes, an unsafe voice is still evaluated
    act = K.active_voice_tiles(vp, SR, 1024, samplerate=SR,
                               layout=T.BankLayout.ungrouped(8, 8))
    assert act[1].all() and act[2].all() and not act[0].any()


def test_sparse_rows_checks():
    bank, vp, layout, idx, n0, nframes = _rows_case()
    with pytest.raises(ValueError, match="one-group"):
        K.render_stereo_reference(
            vp, 0, nframes=2048, samplerate=SR, idx=idx, chunk_frames=2048,
            layout=T.BankLayout(((-1, True, 0, 8), (-1, True, 8, 8)), 16, 8))
