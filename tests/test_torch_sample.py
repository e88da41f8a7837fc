"""The port's ``Sample`` (``synthesizer_tpu_torch.sample``) against the JAX
``Sample`` on the same frames, on the CPU.

Each case runs one op (or a short chain) through both packages on seeded
frames.  Tolerances: the integer ops (arrangement, bias, saturating mixes,
width conversion) are bit-exact; the float-factor ops (gains computed in
f32, where XLA may fuse or contract what eager PyTorch rounds step by step)
are within 1 LSB.  No op may write into frames that a copy shares.
"""

import io
import wave

import numpy as np
import pytest
import torch

import goldref.sample as gs
import synthesizer_tpu as J
import synthesizer_tpu_torch as T
from synthesizer_tpu import oscillators as JO
from synthesizer_tpu_torch import oscillators as TO
from synthesizer_tpu_torch import params as tparams
from synthesizer_tpu_torch.ops import effects as TF
from synthesizer_tpu_torch.utils import codecs as TC
from synthesizer_tpu_torch.utils import libav as TL
from synthesizer_tpu.sample import LevelMeter as JLevelMeter
from synthesizer_tpu_torch.sample import LevelMeter

SR = 44100
NPDT = {1: np.int8, 2: np.int16, 4: np.int32}


def _frames(n=3000, nch=2, width=2, seed=0, scale=0.8):
    rng = np.random.default_rng(seed)
    hi = (1 << (8 * width - 1)) - 1
    a = rng.integers(int(-hi * scale), int(hi * scale), size=(n, nch))
    a[0, :] = hi
    a[1, :] = -hi - 1
    return a.astype(NPDT[width])


class Kit:
    """One package's classes behind one face, so a case is written once."""

    def __init__(self, sample, osc, cpu):
        self.Sample, self.osc, self.cpu = sample, osc, cpu

    def make(self, n=3000, nch=2, width=2, seed=0, sr=SR, scale=0.8):
        a = _frames(n, nch, width, seed, scale)
        return self.Sample.from_raw_frames(a.tobytes(), width, sr, nch,
                                           **self.cpu)


JK = Kit(J.Sample, JO, {})
TK = Kit(T.Sample, TO, {"device": "cpu"})


def _user_lfo(K):
    def f(n0, k):
        n = np.arange(n0, n0 + k)
        return (0.5 + 0.5 * np.cos(2 * np.pi * 3.0 * n / SR)).astype(
            np.float32)
    return K.osc.UserOscillator(f, samplerate=SR)


#: name -> (op on a fresh stereo 16-bit sample s with kit K, tolerance in LSB)
CASES = {
    "amplify_half": (lambda s, K: s.amplify(0.5), 0),
    "amplify_saturates": (lambda s, K: s.amplify(1.7), 0),
    "amplify_third": (lambda s, K: s.amplify(1.0 / 3.0), 0),
    "amplify_max": (lambda s, K: s.amplify(0.3).amplify_max(), 0),
    "amplify_max_silence": (lambda s, K: s.amplify(0.0).amplify_max(), 0),
    "invert": (lambda s, K: s.invert(), 0),
    "bias": (lambda s, K: s.bias(1000), 0),
    "bias_wraps": (lambda s, K: s.bias(40000), 0),
    "bias_negative": (lambda s, K: s.bias(-30000), 0),
    "clip": (lambda s, K: s.clip(0.01, 0.04), 0),
    "clip_past_end": (lambda s, K: s.clip(0.05, 9.0), 0),
    "cut": (lambda s, K: s.cut(0.01, 0.04), 0),
    "add_silence_end": (lambda s, K: s.add_silence(0.01), 0),
    "add_silence_start": (lambda s, K: s.add_silence(0.01, at_start=True), 0),
    "pad_frames": (lambda s, K: s.pad_frames(17).pad_frames(5, True), 0),
    "truncate_frames": (lambda s, K: s.truncate_frames(1234), 0),
    "join": (lambda s, K: s.join(K.make(500, seed=3)), 0),
    "reverse": (lambda s, K: s.reverse(), 0),
    "delay": (lambda s, K: s.delay(0.01), 0),
    "delay_keep_length": (lambda s, K: s.delay(0.01, keep_length=True), 0),
    "delay_negative": (lambda s, K: s.delay(-0.01), 0),
    "delay_negative_keep": (lambda s, K: s.delay(-0.01, keep_length=True), 0),
    "fadein": (lambda s, K: s.fadein(0.03), 1),
    "fadein_from": (lambda s, K: s.fadein(0.03, 0.25), 1),
    "fadein_longer_than_sample": (lambda s, K: s.fadein(5.0), 1),
    "fadeout": (lambda s, K: s.fadeout(0.03), 1),
    "fadeout_to": (lambda s, K: s.fadeout(0.03, 0.4), 1),
    "envelope": (lambda s, K: s.envelope(0.01, 0.02, 0.6, 0.015), 1),
    "envelope_zero_times": (lambda s, K: s.envelope(0.0, 0.0, 0.5, 0.0), 1),
    "modulate_array": (lambda s, K: s.modulate_amp(
        np.linspace(0.0, 1.5, 2000, dtype=np.float32)), 0),
    "modulate_sample": (lambda s, K: s.modulate_amp(
        K.make(2500, 1, seed=5)), 1),
    "modulate_oscillator": (lambda s, K: s.modulate_amp(
        K.osc.Sine(5.0, 0.5, bias=0.5, samplerate=SR)), 1),
    "modulate_user_oscillator": (lambda s, K: s.modulate_amp(_user_lfo(K)),
                                 1),
    "mix": (lambda s, K: s.mix(K.make(2000, seed=7)), 0),
    "mix_longer": (lambda s, K: s.mix(K.make(4000, seed=7)), 0),
    "mix_seconds": (lambda s, K: s.mix(K.make(4000, seed=7),
                                       other_seconds=0.02), 0),
    "mix_at": (lambda s, K: s.mix_at(0.05, K.make(2000, seed=8)), 0),
    "mix_at_no_pad": (lambda s, K: s.mix_at(0.05, K.make(2000, seed=8),
                                            pad_shortest=False), 0),
    "mix_at_past_end": (lambda s, K: s.mix_at(0.1, K.make(100, seed=8)), 0),
    "echo": (lambda s, K: s.echo(0.12, 3, 0.02, 0.6), 0),
    "echo_shorter": (lambda s, K: s.echo(0.03, 4, 0.01, 0.5), 0),
    "make_32bit": (lambda s, K: s.make_32bit(), 0),
    "make_32bit_unscaled": (lambda s, K: s.make_32bit(False), 0),
    "make_16bit_max": (lambda s, K: s.amplify(0.2).make_16bit(), 0),
    "make_16bit_from_32": (lambda s, K: s.make_32bit().amplify(0.5)
                           .make_16bit(maximize_amplitude=False), 0),
    "make_16bit_from_32_max": (lambda s, K: s.make_32bit().amplify(0.25)
                               .make_16bit(), 0),
    "mono": (lambda s, K: s.mono(), 1),
    "mono_factors": (lambda s, K: s.mono(0.3, 0.6), 1),
    "mono_then_stereo": (lambda s, K: s.mono(0.5, 0.5).stereo(0.9, 0.4), 1),
    "stereo_mix_L": (lambda s, K: s.stereo_mix(K.make(2000, 1, seed=9), "L",
                                               0.7), 0),
    "stereo_mix_R": (lambda s, K: s.stereo_mix(K.make(5000, 1, seed=9), "R"),
                     0),
    "stereo_mix_onto_mono": (lambda s, K: s.mono(0.5, 0.5).stereo_mix(
        K.make(2000, 1, seed=9), "L"), 1),
    "pan_left": (lambda s, K: s.pan(-0.6), 0),
    "pan_right": (lambda s, K: s.pan(0.35), 0),
    "pan_mono_source": (lambda s, K: s.mono(0.5, 0.5).pan(0.5), 1),
    "pan_oscillator": (lambda s, K: s.pan(
        lfo=K.osc.Sine(4.0, 0.9, samplerate=SR)), 1),
    "pan_sample": (lambda s, K: s.pan(lfo=K.make(1500, 1, seed=10)), 1),
    "pan_array": (lambda s, K: s.pan(
        lfo=np.linspace(-1.0, 1.0, 3000, dtype=np.float32)), 0),
    "chain": (lambda s, K: s.amplify(0.8).fadein(0.01).fadeout(0.01)
              .mix_at(0.02, K.make(1000, seed=11)).pan(-0.25).reverse(), 1),
}


def _both(name):
    op, tol = CASES[name]
    js, ts = JK.make(), TK.make()
    rj, rt = op(js, JK), op(ts, TK)
    assert rj is js and rt is ts        # chainable: ops return self
    return js, ts, tol


@pytest.mark.parametrize("name", sorted(CASES))
def test_op_matches_reference(name):
    js, ts, tol = _both(name)
    assert (ts.samplerate, ts.samplewidth, ts.nchannels, ts.nframes) == \
           (js.samplerate, js.samplewidth, js.nchannels, js.nframes)
    assert len(ts) == len(js) and ts.duration == js.duration
    a, b = ts.get_frame_array(), js.get_frame_array()
    assert a.dtype == b.dtype and a.shape == b.shape
    if tol == 0:
        np.testing.assert_array_equal(a, b)
    else:
        assert np.abs(a.astype(np.int64) - b.astype(np.int64)).max() <= tol


@pytest.mark.parametrize("name", sorted(CASES))
def test_op_leaves_a_copy_alone(name):
    """``b = a.copy(); op(b)`` leaves ``a`` unchanged: tensors are mutable,
    and ``copy`` shares the buffer."""
    op, _ = CASES[name]
    a = TK.make()
    before = a.get_frame_array().copy()
    shared = a.torch_frames
    b = a.copy()
    assert b == a and b is not a
    op(b, TK)
    assert a.torch_frames is shared
    np.testing.assert_array_equal(shared.numpy(), before)
    np.testing.assert_array_equal(a.get_frame_array(), before)


@pytest.mark.parametrize("width", [1, 2, 4])
def test_widths(width):
    js, ts = JK.make(width=width, seed=2), TK.make(width=width, seed=2)
    for s, K in ((js, JK), (ts, TK)):
        s.amplify(0.7).bias(3).mix(K.make(1000, width=width, seed=4))
        s.fadeout(0.01).mono(0.5, 0.5).stereo()
    tol = 1 if width <= 2 else 256          # one f32 ulp below 2^31
    a, b = ts.get_frame_array(), js.get_frame_array()
    assert a.dtype == b.dtype == NPDT[width]
    assert np.abs(a.astype(np.int64) - b.astype(np.int64)).max() <= tol
    assert ts.maxvalue == js.maxvalue


def test_split():
    js, ts = JK.make(), TK.make()
    tj, tt = js.split(0.03), ts.split(0.03)
    np.testing.assert_array_equal(ts.get_frame_array(), js.get_frame_array())
    np.testing.assert_array_equal(tt.get_frame_array(), tj.get_frame_array())
    assert ts.nframes + tt.nframes == 3000


@pytest.mark.parametrize("nch,width", [(1, 1), (1, 4), (2, 4), (1, 2)])
def test_normalize(nch, width):
    js, ts = JK.make(nch=nch, width=width), TK.make(nch=nch, width=width)
    js.normalize(), ts.normalize()
    assert (ts.samplewidth, ts.nchannels) == (2, 2)
    np.testing.assert_array_equal(ts.get_frame_array(), js.get_frame_array())


def test_constructors_and_introspection(tmp_path):
    a = _frames(800)
    path = str(tmp_path / "in.wav")
    JK.make(800).write_wav(path)
    js, ts = J.Sample(path), T.Sample(path, device="cpu")
    assert ts.name == js.name == path
    np.testing.assert_array_equal(ts.get_frame_array(), a)
    with open(path, "rb") as f:
        np.testing.assert_array_equal(
            T.Sample(f, name="x", device="cpu").get_frame_array(), a)
    empty = T.Sample(device="cpu")
    je = J.Sample()
    assert (empty.nframes, empty.nchannels, empty.samplewidth,
            empty.samplerate) == (je.nframes, je.nchannels, je.samplewidth,
                                  je.samplerate) == (0, 2, 2, SR)
    for arr in (np.linspace(-1.2, 1.2, 400), np.arange(-200, 200),
                a.ravel()[:400]):
        np.testing.assert_array_equal(
            T.Sample.from_array(arr, SR, 2, device="cpu").get_frame_array(),
            J.Sample.from_array(arr, SR, 2).get_frame_array())
    t = torch.from_numpy(a.copy())
    s = T.Sample.from_torch(t, 22050, 2, name="wrapped")
    assert s.torch_frames is t and s.device.type == "cpu"
    assert repr(s) == repr(J.Sample.from_raw_frames(a.tobytes(), 2, 22050, 2,
                                                    name="wrapped"))
    s.samplerate = 11025
    assert s.duration == 800 / 11025
    with pytest.raises(ValueError):
        s.samplerate = 0
    with pytest.raises(ValueError):
        T.Sample.from_torch(t, SR, 4)
    with pytest.raises(ValueError):
        T.Sample.from_torch(t[:, 0], SR, 2)
    s._replace_frames(t[:10])
    assert s.nframes == 10
    with pytest.raises(ValueError):
        s._replace_frames(t.to(torch.int32))
    assert s.dup().nframes == 10


def test_eq_and_format_check():
    a, b = TK.make(), TK.make()
    assert a == b and not (a != b)
    assert a != b.copy().amplify(0.5)
    assert a != TK.make(sr=22050)
    assert a != TK.make(nch=1)
    assert a.__eq__(3) is NotImplemented
    for other in (TK.make(sr=22050), TK.make(nch=1), TK.make(width=4)):
        for op in (a.mix, a.join, lambda o: a.mix_at(0.0, o)):
            with pytest.raises(ValueError, match="format mismatch"):
                op(other)
    with pytest.raises(ValueError):
        a.mix_at(-1.0, b)
    with pytest.raises(ValueError):
        a.stereo_mix(b, "L")            # other must be mono


def test_host_array_is_cached_and_read_only():
    s = TK.make()
    a = s.get_frame_array()
    assert s.get_frame_array() is a and not a.flags.writeable
    with pytest.raises(ValueError):
        a[0, 0] = 1
    s.amplify(0.5)
    b = s.get_frame_array()
    assert b is not a and not np.array_equal(a, b)
    out = torch.empty((3000, 2), dtype=torch.int16)
    c = s.get_frame_array(out=out)
    np.testing.assert_array_equal(c, b)
    np.testing.assert_array_equal(out.numpy(), b)
    assert s.get_frame_array() is b     # a caller's buffer is not cached
    assert s.view_frame_data() == b.tobytes()


def test_wav_round_trip(tmp_path):
    for width, nch in ((1, 1), (2, 2), (4, 2)):
        js, ts = JK.make(width=width, nch=nch), TK.make(width=width, nch=nch)
        bj, bt = io.BytesIO(), io.BytesIO()
        js.write_wav(bj), ts.write_wav(bt)
        assert bt.getvalue() == bj.getvalue()
        bt.seek(0)
        back = T.Sample(bt, device="cpu")
        assert back == ts
    path = str(tmp_path / "out.wav")
    assert ts.write_audio(path) is ts
    with wave.open(path) as w:
        assert (w.getnchannels(), w.getsampwidth(), w.getframerate(),
                w.getnframes()) == (2, 4, SR, 3000)


@pytest.mark.parametrize("repeat", [False, True])
def test_chunked_frame_data(repeat):
    js, ts = JK.make(1000), TK.make(1000)
    gj = js.chunked_frame_data(300, repeat=repeat)
    gt = ts.chunked_frame_data(300, repeat=repeat)
    if repeat:
        for _ in range(9):
            assert next(gt) == next(gj)
        with pytest.raises(ValueError):
            next(T.Sample(device="cpu").chunked_frame_data(10, repeat=True))
    else:
        assert list(gt) == list(gj)


def test_from_patch_renders_at_construction():
    from synthesizer_tpu.models import spec as JS
    from synthesizer_tpu_torch.models import spec as TS
    def node(S):
        return S.Envelope(S.Osc("sawtooth", 220.0, 0.8), 0.01, 0.02, 0.05,
                          0.6, 0.03)
    for width in (1, 2, 4):
        ts = T.Sample.from_patch(node(TS), 5000, SR, width, "p",
                                 blocksize=2048, device="cpu")
        js = J.Sample.from_patch(node(JS), 5000, SR, width, "p",
                                 blocksize=2048)
        assert (ts.nframes, ts.nchannels, ts.samplewidth, ts.name) == \
               (5000, 1, width, "p")
        a, b = ts.get_frame_array(), js.get_frame_array()
        tol = 1 if width <= 2 else 256 * 3   # 1 LSB at 16 bit, in f32 ulps
        assert a.dtype == b.dtype
        assert np.abs(a.astype(np.int64) - b.astype(np.int64)).max() <= tol
    with pytest.raises(ValueError, match="host-source"):
        T.Sample.from_patch(_user_lfo(TK).spec, 100, SR, 2, device="cpu")


#: compressed format -> (writer, the port's codec library check, SNR floor
#: in dB of the decoded file against the written frames; None = bit-exact)
WRITERS = {
    "flac": ("write_flac", lambda: True, None),
    "mp3": ("write_mp3", lambda: TC.have_lame() and TC.have_mpg123(), 15.0),
    "ogg": ("write_ogg", lambda: TC.have_vorbisenc() and TC.have_vorbisfile(),
            15.0),
    "opus": ("write_opus", TC.have_opus, 15.0),
    "m4a": ("write_m4a", TL.have_libav, 15.0),
}


@pytest.mark.parametrize("fmt", sorted(WRITERS))
def test_writer_round_trip(fmt, tmp_path):
    """Each compressed writer's file loads back through the port's own
    ``Sample(wave_file=)`` (the decoders behind ``read_wav``): FLAC bit for
    bit, the lossy formats at the written rate and length (opus at 48 kHz,
    its other rates resampled on a copy) above an SNR floor; the written
    sample is untouched.  Skips where the system codec library is
    missing."""
    name, have, snr_floor = WRITERS[fmt]
    if not have():
        pytest.skip(f"no system codec library for {fmt}")
    n = 22050
    t = np.arange(n) / SR
    a = np.rint(np.stack([np.sin(2 * np.pi * 440.0 * t) * 12000,
                          np.sin(2 * np.pi * 660.0 * t) * 9000], 1))
    s = T.Sample.from_raw_frames(a.astype(np.int16).tobytes(), 2, SR, 2,
                                 device="cpu")
    p = str(tmp_path / f"x.{fmt}")
    assert getattr(s, name)(p) is s
    np.testing.assert_array_equal(s.get_frame_array(), a.astype(np.int16))
    back = T.Sample(wave_file=p, device="cpu")
    assert back.nchannels == 2
    got = back.get_frame_array().astype(np.float64)
    if snr_floor is None:
        assert (back.samplerate, back.samplewidth) == (SR, 2)
        np.testing.assert_array_equal(got, a)
        return
    want = a
    if fmt == "opus":
        assert back.samplerate == 48000
        want = s.copy().resample(48000).get_frame_array().astype(np.float64)
    else:
        assert back.samplerate == SR
    assert abs(len(got) - len(want)) <= 2048
    m = min(len(got), len(want))
    # the best alignment within a codec frame of encoder delay
    best = max(
        10 * np.log10(np.mean(want[:m - lag] ** 2) / max(
            np.mean((got[lag:m] - want[:m - lag]) ** 2), 1e-9))
        for lag in range(0, 1200, 1))
    assert best > snr_floor, (fmt, best)


def test_write_audio_dispatch(tmp_path):
    """write_audio picks the writer by the extension, in any case, and
    writes WAV for any other name and for a file object."""
    s = TK.make(2000)
    calls = []
    for name in ("write_flac", "write_mp3", "write_ogg", "write_opus",
                 "write_m4a", "write_wav"):
        setattr(s, name, lambda f, name=name: calls.append((name, f)) or s)
    for ext in (".flac", ".MP3", ".ogg", ".oga", ".opus", ".m4a", ".aac",
                ".wav", ".xyz"):
        assert s.write_audio(str(tmp_path / f"x{ext}")) is s
    assert [c[0] for c in calls] == [
        "write_flac", "write_mp3", "write_ogg", "write_ogg", "write_opus",
        "write_m4a", "write_m4a", "write_wav", "write_wav"]
    assert all(isinstance(f, str) for _, f in calls)
    bio = io.BytesIO()
    s.write_audio(bio)
    assert calls[-1] == ("write_wav", bio)
    s.write_audio(tmp_path / "y.flac")           # a PathLike
    assert calls[-1] == ("write_flac", str(tmp_path / "y.flac"))


def test_nothing_else_waits():
    """Every public method of the reference's Sample and LevelMeter exists
    in the port (the compressed-audio writers too, since they stopped
    waiting)."""
    for cls_j, cls_t in ((J.Sample, T.Sample),
                         (JLevelMeter, LevelMeter)):
        for name in dir(cls_j):
            if name.startswith("_"):
                continue
            if name in ("jax_frames", "from_jax"):
                continue                # the JAX array surface
            assert hasattr(cls_t, name), name


@pytest.mark.parametrize("nch,width,sr", [(1, 2, 22050), (2, 1, 48000),
                                          (2, 4, 32000)])
def test_normalize_resamples(nch, width, sr):
    """normalize() on a sample at another rate resamples it (the exact
    ratecv) on the way to the normalization targets."""
    js = JK.make(nch=nch, width=width, sr=sr)
    ts = TK.make(nch=nch, width=width, sr=sr)
    js.normalize(), ts.normalize()
    assert (ts.samplerate, ts.samplewidth, ts.nchannels, ts.nframes) == \
           (SR, 2, 2, js.nframes)
    assert tparams.norm_samplerate == SR
    np.testing.assert_array_equal(ts.get_frame_array(), js.get_frame_array())


def test_entry_points_default_to_the_card():
    if torch.cuda.is_available():
        pytest.skip("this check is for a machine without a CUDA device")
    a = _frames(10)
    for call in (lambda: T.Sample(),
                 lambda: T.Sample.from_raw_frames(a.tobytes(), 2, SR, 2),
                 lambda: T.Sample.from_array(a.ravel(), SR, 2),
                 lambda: T.Sample.from_patch(
                     TK.osc.Sine(440.0).spec, 10, SR, 2)):
        with pytest.raises(RuntimeError, match="device='cpu'"):
            call()


# ---------------------------------------------------------------------------
# The effects rack, loudness and resampling through Sample, against the f64
# oracle (goldref.sample.Sample) within each op's goldref.effects budget
# ---------------------------------------------------------------------------

def _tones(n, nch, seed):
    """A chord of three partials with a little noise (the phase vocoder's
    budget is stated for tonal input)."""
    rng = np.random.default_rng(seed)
    t = np.arange(n)[:, None] / SR
    sig = sum(0.2 * np.sin(2 * np.pi * f * t + ph) for f, ph in
              ((220.0, 0.0), (330.0, 0.5), (495.0 * (1 + 0.01 * seed), 1.0)))
    sig = sig + 0.02 * rng.standard_normal((n, nch))
    return np.rint(sig * 32767).astype(np.int16)


def _gold(n=3000, nch=2, seed=0, sr=SR):
    return gs.Sample(_tones(n, nch, seed), sr, 2, nch)


def _port(n=3000, nch=2, seed=0, sr=SR):
    return T.Sample.from_raw_frames(_tones(n, nch, seed).tobytes(), 2, sr,
                                    nch, device="cpu")


B = TF.BUDGETS
#: name -> (op on a fresh stereo 16-bit sample s, maker of a second sample
#: of the same kind, budget in LSB from ops.effects.BUDGETS; convolve's is
#: max(B["convolve"], 1e-4 * peak))
FX = {
    "compress": (lambda s, mk: s.compress(-18.0, 4.0, 0.003, 0.08, 3.0),
                 B["compress"]),
    "compress_soft_knee": (lambda s, mk: s.compress(-24.0, 6.0,
                                                    knee_db=6.0),
                           B["compress"]),
    "compress_sidechain": (lambda s, mk: s.compress(
        -30.0, 8.0, sidechain=mk(2000, 1, 5)), B["compress"]),
    "reverb": (lambda s, mk: s.reverb(0.7, 0.5, 0.33, 0.7, 1.0, 0.05),
               B["reverb"]),
    "chorus": (lambda s, mk: s.chorus(0.5, 0.002, 0.02, 3, 0.4, 1.0),
               B["chorus"]),
    "filter": (lambda s, mk: s.filter("lowpass", 1000.0), B["filter"]),
    "filter_highpass_30": (lambda s, mk: s.filter("highpass", 30.0),
                           B["filter"]),
    "eq": (lambda s, mk: s.eq(4.0, -6.0, 3.0, 150.0, 900.0, 1.4, 5000.0),
           B["eq"]),
    "gate": (lambda s, mk: s.gate(-30.0, 60.0, 0.001, 0.01), B["gate"]),
    "feedback_echo": (lambda s, mk: s.feedback_echo(0.01, 0.5, 0.5, 1.0,
                                                    0.02),
                      B["feedback_echo"]),
    "tremolo": (lambda s, mk: s.tremolo(5.0, 0.5, 100), B["tremolo"]),
    "autopan": (lambda s, mk: s.autopan(2.0, 0.8), B["autopan"]),
    "stereo_width": (lambda s, mk: s.stereo_width(1.7), B["stereo_width"]),
    "limit": (lambda s, mk: s.limit(-6.0, 0.05, 0.002), B["limit"]),
    "phaser": (lambda s, mk: s.phaser(0.8, 1.0, 300.0, 3000.0, 4),
               B["phaser"]),
    # against the oracle's f64 grids: the float-float scan, 2 LSB
    "phaser_low_floor": (lambda s, mk: s.phaser(0.8, 1.0, 60.0, 2000.0, 4,
                                                1.0), 2),
    "convolve": (lambda s, mk: s.convolve(mk(300, 1, 9), 1.0, 0.3), None),
    "granulate": (lambda s, mk: s.granulate(0.1, 0.02, 80.0, 0.01, 0.7,
                                            3), B["granulate"]),
    "stretch": (lambda s, mk: s.stretch(1.3), B["stretch"]),
    "pitch_shift": (lambda s, mk: s.pitch_shift(3.0), B["pitch_shift"]),
    "speed_hq": (lambda s, mk: s.speed(1.1, "hq"), B["hq_resample"]),
    "resample_hq": (lambda s, mk: s.resample(48000, "hq"),
                    B["hq_resample"]),
}


@pytest.mark.parametrize("name", sorted(FX))
def test_fx_op_matches_oracle(name):
    op, budget = FX[name]
    ts, gold = _port(), _gold()
    if name == "phaser_low_floor":          # the oracle's f64 grids
        gold.phaser(0.8, 1.0, 60.0, 2000.0, 4, 1.0, grids_dtype=np.float64)
    else:
        op(gold, lambda n, nch, seed: _gold(n, nch, seed))
    assert op(ts, lambda n, nch, seed: _port(n, nch, seed)) is ts
    got = ts.get_frame_array()
    assert (ts.samplerate, ts.nchannels, ts.nframes) == \
           (gold.samplerate, gold.nchannels, gold.frames.shape[0])
    if budget is None:
        budget = max(B["convolve"], 1e-4 * np.abs(gold.frames).max())
    assert np.abs(got.astype(np.int64)
                  - gold.frames.astype(np.int64)).max() <= budget


@pytest.mark.parametrize("name", sorted(FX))
def test_fx_op_leaves_a_copy_alone(name):
    op, _ = FX[name]
    a = _port()
    before = a.get_frame_array().copy()
    b = a.copy()
    op(b, lambda n, nch, seed: _port(n, nch, seed))
    np.testing.assert_array_equal(a.get_frame_array(), before)


def test_loudness_through_sample():
    t = np.arange(2 * SR) / SR
    sig = (0.3 * np.sin(2 * np.pi * 220 * t)
           + 0.05 * np.random.default_rng(1).standard_normal(2 * SR))
    a = np.rint(np.stack([sig, np.roll(sig, 7)], 1) * 20000).astype(np.int16)
    ts = T.Sample.from_raw_frames(a.tobytes(), 2, SR, 2, device="cpu")
    gold = gs.Sample(a.copy(), SR, 2, 2)
    assert abs(ts.loudness_lufs() - gold.loudness_lufs()) < 0.01
    assert abs(ts.true_peak_dbtp() - gold.true_peak_dbtp()) < 0.01
    st, gst = ts.loudness_stats(), gold.loudness_stats()
    for k in ("integrated", "lra", "momentary_max", "short_term_max"):
        assert st[k] == gst[k] or abs(st[k] - gst[k]) < 0.02, k
    assert ts.normalize_lufs(-18.0) is ts
    assert abs(ts.loudness_lufs() + 18.0) < 0.1
    loud = T.Sample.from_raw_frames((a * 1.5).astype(np.int16).tobytes(), 2,
                                    SR, 2, device="cpu")
    loud.normalize_lufs(-6.0, true_peak_db=-1.0)
    assert loud.true_peak_dbtp() <= -1.0 + 0.1
    silent = T.Sample.from_raw_frames(bytes(4 * SR), 2, SR, 2, device="cpu")
    assert silent.loudness_lufs() == float("-inf")
    assert silent.true_peak_dbtp() == float("-inf")
    assert silent.normalize_lufs() is silent


def test_fx_validation():
    s = _port(100)
    for call in (lambda: s.compress(knee_db=30.0),
                 lambda: s.compress(sidechain=_port(100, sr=22050)),
                 lambda: s.feedback_echo(0.01, feedback=0.99),
                 lambda: s.tremolo(depth=1.5), lambda: s.tremolo(rate=0.0),
                 lambda: s.autopan(depth=2.0), lambda: s.stereo_width(5.0),
                 lambda: s.limit(ceiling_db=3.0), lambda: s.phaser(stages=0),
                 lambda: s.phaser(min_freq=20.0),
                 lambda: s.convolve(_port(10, sr=22050)),
                 lambda: s.convolve(_port(0)),
                 lambda: _port(100, nch=1).autopan(),
                 lambda: _port(100, nch=1).stereo_width(1.0)):
        with pytest.raises(ValueError):
            call()


def test_config3_within_one_lsb():
    """Config 3 of bench.py at a small size (4 tracks of 0.2 s, 0.1 s
    apart): 22050 Hz sines resampled to 44100, amplified, faded, made
    stereo and mixed."""
    from synthesizer_tpu_torch.bench_song import config3

    def ref(tracks=4, track_sec=0.2, gap=0.1):
        synth = J.WaveSynth(samplerate=22050, samplewidth=2)
        total = J.Sample.from_raw_frames(b"", 2, SR, 2)
        for t in range(tracks):
            s = synth.sine(100.0 + 50 * t, track_sec, amplitude=0.4)
            s.resample(SR).amplify(0.5 + 0.02 * t) \
             .fadein(0.02).fadeout(0.05).stereo()
            total.mix_at(gap * t, s)
        return total

    got = config3(SR, "cpu", tracks=4, track_sec=0.2, gap=0.1)
    want = ref()
    assert (got.samplerate, got.nchannels, got.nframes) == \
           (SR, 2, want.nframes)
    a, b = got.get_frame_array(), want.get_frame_array()
    assert np.abs(a.astype(np.int64) - b.astype(np.int64)).max() <= 1


@pytest.mark.parametrize("loudness", [False, True])
def test_level_meter(loudness):
    """LevelMeter readings against the JAX package's on the same chunks:
    from Samples (reductions on the sample's device) and from host
    frames; the live loudness readout within 0.02 LU."""
    t = np.arange(SR) / SR
    a = np.rint(np.stack([0.5 * np.sin(2 * np.pi * 997 * t),
                          0.1 * np.sin(2 * np.pi * 440 * t)], 1)
                * 32767).astype(np.int16)
    for rms in (False, True):
        lt = LevelMeter(rms_mode=rms, loudness=loudness)
        lj = JLevelMeter(rms_mode=rms, loudness=loudness)
        for i in range(0, len(a), SR // 5):
            chunk = a[i:i + SR // 5]
            rt = lt.update(T.Sample.from_raw_frames(chunk.tobytes(), 2, SR, 2,
                                                    device="cpu"))
            rj = lj.update(J.Sample.from_raw_frames(chunk.tobytes(), 2, SR,
                                                    2))
            np.testing.assert_allclose(rt, rj, atol=1e-4)
        if loudness:
            assert abs(lt.momentary_lufs - lj.momentary_lufs) < 0.02
        mono = a[:1470, :1]
        ht, hj = LevelMeter(rms, loudness=loudness), \
            JLevelMeter(rms, loudness=loudness)
        for _ in range(3):
            np.testing.assert_allclose(ht.update_frames(mono, SR),
                                       hj.update_frames(mono, SR), atol=1e-9)
        assert ht.momentary_lufs == hj.momentary_lufs
        assert ht.short_term_lufs == float("-inf")
    lt.print()
    lt.reset()
    assert (lt.level_left, lt.peak_right, lt.momentary_lufs) == \
           (-60.0, -60.0, float("-inf"))
    assert LevelMeter().loudness_meter is None
    with pytest.raises(ValueError):
        LevelMeter(lowest=0.0)
