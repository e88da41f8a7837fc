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

import synthesizer_tpu as J
import synthesizer_tpu_torch as T
from synthesizer_tpu import oscillators as JO
from synthesizer_tpu_torch import oscillators as TO
from synthesizer_tpu_torch import params as tparams
from synthesizer_tpu_torch.sample import LevelMeter

torch.set_num_threads(2)

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


WAITING = {
    8: ["resample", "speed"],
    10: ["tremolo", "autopan", "compress", "reverb", "chorus", "filter", "eq",
         "loudness_lufs", "loudness_stats", "true_peak_dbtp",
         "normalize_lufs", "gate", "feedback_echo", "stereo_width", "limit",
         "phaser", "convolve", "granulate", "stretch", "pitch_shift"],
    11: ["write_flac", "write_mp3", "write_ogg", "write_opus", "write_m4a"],
}


@pytest.mark.parametrize("item,name", [(i, n) for i, names in WAITING.items()
                                       for n in names])
def test_waiting_op_raises_and_names_its_queue_item(item, name):
    assert hasattr(J.Sample, name)      # the reference has it
    s = TK.make(100)
    with pytest.raises(NotImplementedError,
                       match=rf"{name} is not ported yet.*item {item}\)"):
        getattr(s, name)(1.0)
    np.testing.assert_array_equal(s.get_frame_array(), _frames(100))


def test_other_waiting_paths():
    s = TK.make(100, sr=22050)
    with pytest.raises(NotImplementedError, match=r"resample.*item 8\)"):
        s.normalize()                   # not at params.norm_samplerate
    assert tparams.norm_samplerate == SR
    for ext, item in ((".flac", 11), (".mp3", 11), (".ogg", 11),
                      (".opus", 11), (".m4a", 11)):
        with pytest.raises(NotImplementedError, match=rf"item {item}\)"):
            s.write_audio("x" + ext)
    with pytest.raises(NotImplementedError, match=r"LevelMeter.*item 10\)"):
        LevelMeter()


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
