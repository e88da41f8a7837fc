"""The port's ``WaveSynth`` and oscillator classes
(``synthesizer_tpu_torch.synth`` / ``oscillators``) against the JAX
package's, on the CPU.

Every waveform method and oscillator/filter class renders within 1 LSB at
16 bit of its JAX counterpart (the Biquad filter classes within the 3 LSB
their budget grants at this pole position); the ``*_gen`` chunks,
concatenated, equal the offline render bit for bit; ``note_freq`` and
``key_freq`` are equal.
"""

import gc
import itertools

import numpy as np
import pytest
import torch

import synthesizer_tpu as J
import synthesizer_tpu_torch as T
from synthesizer_tpu import oscillators as JO
from synthesizer_tpu.models import graph as JG
from synthesizer_tpu_torch import oscillators as TO
from synthesizer_tpu_torch.models import graph as TG
from synthesizer_tpu_torch.models import spec as TS

torch.set_num_threads(2)

SR = 22050
TABLE = tuple(float(v) for v in
              np.sin(np.linspace(0, 2 * np.pi, 32, endpoint=False)) ** 3)
HARM = [(1, 0.6), (2, 0.25), (3.5, 0.15)]


def lsb(a, b):
    return np.abs(np.asarray(a, np.int64) - np.asarray(b, np.int64)).max()


def q16(v):
    return np.clip(np.rint(np.asarray(v, np.float64) * 32767), -32768, 32767)


def _lfo(O):
    return O.Sine(6.0, 0.03, samplerate=SR)


#: name -> call on a WaveSynth ``w`` with its package's oscillators ``O``
METHODS = {
    "sine": lambda w, O: w.sine(440.0, 0.2),
    "sine_fm": lambda w, O: w.sine(440.0, 0.2, fm_lfo=_lfo(O)),
    "sine_phase_bias": lambda w, O: w.sine(300.0, 0.2, 0.5, 0.25, 0.1),
    "square": lambda w, O: w.square(220.0, 0.2),
    "square_h": lambda w, O: w.square_h(220.0, 0.2, num_harmonics=6),
    "triangle": lambda w, O: w.triangle(330.0, 0.2),
    "sawtooth": lambda w, O: w.sawtooth(330.0, 0.2, fm_lfo=_lfo(O)),
    "sawtooth_h": lambda w, O: w.sawtooth_h(220.0, 0.2, num_harmonics=5),
    "sawtooth_bl": lambda w, O: w.sawtooth_bl(440.0, 0.2),
    "square_bl": lambda w, O: w.square_bl(440.0, 0.2),
    "pulse": lambda w, O: w.pulse(220.0, 0.2, pulse_width=0.3),
    "pulse_pwm": lambda w, O: w.pulse(
        220.0, 0.2, pwm_lfo=O.Sine(3.0, 0.3, bias=0.5, samplerate=SR)),
    "harmonics": lambda w, O: w.harmonics(220.0, 0.2, HARM),
    "wavetable": lambda w, O: w.wavetable(330.0, 0.2, TABLE),
    "pluck": lambda w, O: w.pluck(196.0, 0.2, num_harmonics=8, seed=4),
    "white_noise": lambda w, O: w.white_noise(duration=0.2, seed=9),
    "white_noise_held": lambda w, O: w.white_noise(2000.0, 0.2, seed=9),
    "semicircle": lambda w, O: w.semicircle(330.0, 0.2),
    "pointy": lambda w, O: w.pointy(330.0, 0.2),
    "render_oscillator": lambda w, O: w.render_oscillator(
        O.EchoFilter(O.EnvelopeFilter(O.Sawtooth(220.0, samplerate=SR),
                                      0.01, 0.02, 0.03, 0.5, 0.02),
                     0.05, 2, 0.03, 0.5), 0.2, name="echoed"),
}


@pytest.mark.parametrize("width", [2, 4])
@pytest.mark.parametrize("name", sorted(METHODS))
def test_wavesynth_method(name, width):
    js = METHODS[name](J.WaveSynth(SR, width), JO)
    ts = METHODS[name](T.WaveSynth(SR, width, device="cpu"), TO)
    assert isinstance(ts, T.Sample) and ts.name == js.name
    assert (ts.nframes, ts.nchannels, ts.samplewidth, ts.samplerate) == \
           (js.nframes, 1, width, SR)
    a, b = ts.get_frame_array(), js.get_frame_array()
    assert a.dtype == b.dtype
    if width == 4:       # 1 LSB at 16 bit, counted in 32-bit units
        a, b = a >> 16, b >> 16
    assert lsb(a, b) <= 1


GENS = {
    "sine_gen": lambda w, O: w.sine_gen(440.0, fm_lfo=_lfo(O)),
    "square_gen": lambda w, O: w.square_gen(220.0),
    "square_h_gen": lambda w, O: w.square_h_gen(220.0, num_harmonics=4),
    "triangle_gen": lambda w, O: w.triangle_gen(330.0),
    "sawtooth_gen": lambda w, O: w.sawtooth_gen(330.0),
    "sawtooth_h_gen": lambda w, O: w.sawtooth_h_gen(220.0, num_harmonics=4),
    "pulse_gen": lambda w, O: w.pulse_gen(220.0, pulse_width=0.25),
    "harmonics_gen": lambda w, O: w.harmonics_gen(220.0, HARM),
    "wavetable_gen": lambda w, O: w.wavetable_gen(330.0, TABLE),
    "pluck_gen": lambda w, O: w.pluck_gen(196.0, num_harmonics=6, seed=2),
    "white_noise_gen": lambda w, O: w.white_noise_gen(seed=5),
    "semicircle_gen": lambda w, O: w.semicircle_gen(330.0),
    "pointy_gen": lambda w, O: w.pointy_gen(330.0),
    "oscillator_gen": lambda w, O: w.oscillator_gen(
        O.DelayFilter(O.Triangle(330.0, samplerate=SR), 0.01), 300),
}

#: the offline render of the same patch, for streaming == offline
OFFLINE = {
    "sine_gen": lambda w, O, d: w.sine(440.0, d, fm_lfo=_lfo(O)),
    "square_gen": lambda w, O, d: w.square(220.0, d),
    "square_h_gen": lambda w, O, d: w.square_h(220.0, d, num_harmonics=4),
    "triangle_gen": lambda w, O, d: w.triangle(330.0, d),
    "sawtooth_gen": lambda w, O, d: w.sawtooth(330.0, d),
    "sawtooth_h_gen": lambda w, O, d: w.sawtooth_h(220.0, d, num_harmonics=4),
    "pulse_gen": lambda w, O, d: w.pulse(220.0, d, pulse_width=0.25),
    "harmonics_gen": lambda w, O, d: w.harmonics(220.0, d, HARM),
    "wavetable_gen": lambda w, O, d: w.wavetable(330.0, d, TABLE),
    "pluck_gen": lambda w, O, d: w.pluck(196.0, d, num_harmonics=6, seed=2),
    "white_noise_gen": lambda w, O, d: w.white_noise(duration=d, seed=5),
    "semicircle_gen": lambda w, O, d: w.semicircle(330.0, d),
    "pointy_gen": lambda w, O, d: w.pointy(330.0, d),
    "oscillator_gen": lambda w, O, d: w.render_oscillator(
        O.DelayFilter(O.Triangle(330.0, samplerate=SR), 0.01), d),
}


@pytest.mark.parametrize("name", sorted(GENS))
def test_gen_chunks_equal_offline_and_reference(name):
    nchunks = 5
    wt, wj = T.WaveSynth(SR, device="cpu"), J.WaveSynth(SR)
    chunks = list(itertools.islice(GENS[name](wt, TO), nchunks))
    ref = list(itertools.islice(GENS[name](wj, JO), nchunks))
    assert all(isinstance(c, T.Sample) and c.nchannels == 1 and
               c.samplewidth == 2 and c.name == "gen" for c in chunks)
    assert [c.nframes for c in chunks] == [c.nframes for c in ref]
    got = np.concatenate([c.get_frame_array() for c in chunks])
    want = np.concatenate([c.get_frame_array() for c in ref])
    assert lsb(got, want) <= 1
    off = OFFLINE[name](wt, TO, len(got) / SR).get_frame_array()
    np.testing.assert_array_equal(got, off)


def _classes(O):
    """One instance of every oscillator and filter class."""
    src = O.Sawtooth(220.0, 0.8, samplerate=SR)
    lfo = _lfo(O)
    return {
        "Sine": O.Sine(440.0, 0.9, 0.1, 0.02, fm_lfo=lfo, samplerate=SR),
        "Triangle": O.Triangle(330.0, samplerate=SR),
        "Square": O.Square(220.0, samplerate=SR),
        "SquareH": O.SquareH(220.0, 5, samplerate=SR),
        "Sawtooth": O.Sawtooth(330.0, fm_lfo=lfo, samplerate=SR),
        "SawtoothH": O.SawtoothH(220.0, 5, samplerate=SR),
        "Pulse": O.Pulse(220.0, pulse_width=0.2, samplerate=SR),
        "Pulse_pwm": O.Pulse(220.0, pwm_lfo=O.Sine(3.0, 0.3, bias=0.5,
                                                  samplerate=SR),
                             samplerate=SR),
        "Harmonics": O.Harmonics(220.0, HARM, samplerate=SR),
        "WhiteNoise": O.WhiteNoise(seed=6, samplerate=SR),
        "WhiteNoise_held": O.WhiteNoise(1000.0, 0.5, 0.1, 6, samplerate=SR),
        "Semicircle": O.Semicircle(330.0, samplerate=SR),
        "Pointy": O.Pointy(330.0, samplerate=SR),
        "BandlimitedSawtooth": O.BandlimitedSawtooth(440.0, samplerate=SR),
        "BandlimitedSquare": O.BandlimitedSquare(440.0, samplerate=SR),
        "Wavetable": O.Wavetable(330.0, TABLE, samplerate=SR),
        "Pluck": O.Pluck(196.0, num_harmonics=8, seed=1, samplerate=SR),
        "Linear": O.Linear(-0.3, 2e-4, -0.2, 0.6, samplerate=SR),
        "FastSine": O.FastSine(440.0, samplerate=SR),
        "FastPulse": O.FastPulse(220.0, samplerate=SR),
        "EnvelopeFilter": O.EnvelopeFilter(src, 0.01, 0.02, 0.05, 0.6, 0.03),
        "MixingFilter": O.MixingFilter(src, O.Sine(550.0, 0.2,
                                                   samplerate=SR)),
        "AmpModulationFilter": O.AmpModulationFilter(
            src, O.Sine(7.0, 0.5, bias=0.5, samplerate=SR)),
        "DelayFilter": O.DelayFilter(src, 0.013),
        "EchoFilter": O.EchoFilter(src, 0.02, 3, 0.015, 0.5),
        "ClipFilter": O.ClipFilter(src, -0.3, 0.4),
        "AbsFilter": O.AbsFilter(src),
        "NullFilter": O.NullFilter(src),
        "LowpassFilter": O.LowpassFilter(src, 2000.0, 1.0),
        "HighpassFilter": O.HighpassFilter(src, 2000.0, 1.0),
        "BandpassFilter": O.BandpassFilter(src, 1500.0, 2.0),
        "LowpassFilter_swept": O.LowpassFilter(
            src, 800.0, 0.7071, cutoff_lfo=O.Sine(0.5, 2.0, samplerate=SR)),
    }


CJ, CT = _classes(JO), _classes(TO)


@pytest.mark.parametrize("name", sorted(CT))
def test_oscillator_class(name):
    n = 6000
    oj, ot = CJ[name], CT[name]
    assert type(ot).__name__ == type(oj).__name__
    assert ot.samplerate == oj.samplerate == SR
    assert ot.duration == oj.duration
    got = ot.render(n, 2048, device="cpu")
    assert isinstance(got, torch.Tensor) and got.dtype == torch.float32
    ref = np.asarray(oj.render(n, 2048))
    tol = 3 if "pass" in name else 1
    assert np.abs(q16(got.numpy()) - q16(ref)).max() <= tol
    # blocks() streams the same samples, as numpy blocks of the asked size
    blocks = list(itertools.islice(ot.blocks(500, device="cpu"), 4))
    assert all(b.shape == (500,) and b.dtype == np.float32 for b in blocks)
    off = ot.render(2000, 500, device="cpu").numpy()
    if "pass" in name:
        assert np.abs(np.concatenate(blocks) - off).max() < 3.0 / 32767
    else:
        np.testing.assert_array_equal(np.concatenate(blocks), off)
    np.testing.assert_array_equal(ot.gains(100, device="cpu").numpy(),
                                  ot.render(100, device="cpu").numpy())


def test_module_surface():
    assert TO.__all__ == JO.__all__
    assert T.synth.__all__ == J.synth.__all__
    for name in TO.__all__:
        assert hasattr(TO, name)
    assert TO.FastSine is TO.Sine and TO.FastPointy is TO.Pointy
    assert sorted(n for n in dir(T.WaveSynth) if not n.startswith("_")) == \
           sorted(n for n in dir(J.WaveSynth) if not n.startswith("_"))
    assert {"Sample", "WaveSynth", "oscillators", "key_freq",
            "note_freq"} <= set(T.__all__)
    with pytest.raises(ValueError):
        TO.MixingFilter()


@pytest.mark.parametrize("key", [1, 28, 40, 49, 61, 88])
def test_key_freq(key):
    assert T.key_freq(key) == J.key_freq(key)
    assert T.key_freq(key, 432.0) == J.key_freq(key, 432.0)


@pytest.mark.parametrize("note,octave", [("A", 4), ("C", 4), ("c#", 5),
                                         ("Eb", 2), ("A4", None),
                                         ("F#3", None), ("bb-1", None),
                                         (" g7 ", None)])
def test_note_freq(note, octave):
    assert T.note_freq(note, octave) == J.note_freq(note, octave)


@pytest.mark.parametrize("bad", ["H4", "", "C", "C#x", "4A"])
def test_note_freq_rejects(bad):
    with pytest.raises(ValueError, match="invalid note name"):
        T.note_freq(bad)
    with pytest.raises(ValueError):
        J.note_freq(bad)


def test_envelope_filter_stop_at_end():
    def make(O):
        return O.EnvelopeFilter(O.Sine(440.0, samplerate=SR), 0.01, 0.01,
                                0.02, 0.5, 0.01, stop_at_end=True)
    got = list(make(TO).blocks(256, device="cpu"))
    ref = list(make(JO).blocks(256))
    assert len(got) == len(ref) and make(TO).duration == make(JO).duration
    assert np.abs(q16(np.concatenate(got))
                  - q16(np.concatenate(ref))).max() <= 1
    assert iter(make(TO)) is not None


def _tone(n0, k, total=10 ** 9):
    n = np.arange(n0, min(n0 + k, total))
    return (0.4 * np.sin(2 * np.pi * 330.0 * n / SR)).astype(np.float32)


class _Blocks:
    """A user oscillator of the original's style: an object with blocks()."""

    def __init__(self, total):
        self.total = total

    def blocks(self):
        for n0 in range(0, self.total, 100):
            yield list(_tone(n0, 100, self.total))


USER_SOURCES = {
    "callable": lambda: (lambda n0, k: _tone(n0, k)),
    "blocks_object": lambda: _Blocks(100 * 40),
    "iterator": lambda: iter(_Blocks(100 * 40).blocks()),
    "iterable": lambda: [_tone(n0, 250) for n0 in range(0, 4000, 250)],
}


@pytest.mark.parametrize("kind", sorted(USER_SOURCES))
def test_user_oscillator(kind):
    def patch(O):
        u = O.UserOscillator(USER_SOURCES[kind](), samplerate=SR)
        assert isinstance(O.from_blocks(USER_SOURCES[kind](), SR),
                          O.UserOscillator)
        return O.EchoFilter(O.EnvelopeFilter(u, 0.005, 0.01, 0.05, 0.6,
                                             0.02), 0.01, 2, 0.01, 0.5)
    ot, oj = patch(TO), patch(JO)
    got = ot.render(3000, 512, device="cpu").numpy()
    ref = np.asarray(oj.render(3000, 512))
    assert got.shape == (3000,)
    assert np.abs(q16(got) - q16(ref)).max() <= 1
    if kind in ("iterator", "iterable"):
        with pytest.raises(RuntimeError, match="already consumed"):
            ot.render(100, 512, device="cpu")
    else:                       # replayable: a second render starts afresh
        np.testing.assert_array_equal(
            ot.render(3000, 512, device="cpu").numpy(), got)


def test_user_oscillator_finite_source_ends_the_stream():
    ot = TO.UserOscillator(_Blocks(1000), samplerate=SR)
    oj = JO.UserOscillator(_Blocks(1000), samplerate=SR)
    got = list(ot.blocks(300, device="cpu"))
    ref = list(oj.blocks(300))
    assert [len(b) for b in got] == [len(b) for b in ref] == [300] * 4
    np.testing.assert_array_equal(np.concatenate(got), np.concatenate(ref))
    assert not np.concatenate(got)[1000:].any()
    with pytest.raises(TypeError):
        TO.UserOscillator(3)


def test_seq_pull_seeks_only_when_replayable():
    pull = TO._seq_pull(_Blocks(1000).blocks, replayable=True)
    np.testing.assert_array_equal(pull(0, 150), _tone(0, 150))
    np.testing.assert_array_equal(pull(600, 150), _tone(600, 150))
    assert len(pull(900, 300)) == 100 and pull(1000, 10) is None
    once = TO._seq_pull(lambda: iter(_Blocks(1000).blocks()),
                        replayable=False)
    once(0, 100)
    with pytest.raises(RuntimeError, match="cannot seek"):
        once(500, 100)


def test_user_oscillator_registry_entry_dies_with_the_node():
    u = TO.UserOscillator(lambda n0, k: _tone(n0, k), samplerate=SR)
    key = u.spec.key
    assert isinstance(u.spec, TS.HostSource) and key in TG._HOST_PULLS
    mixed = TO.MixingFilter(u, TO.Sine(440.0, samplerate=SR))
    del u
    gc.collect()
    assert key in TG._HOST_PULLS        # the patch keeps the node alive
    assert mixed.render(64, 64, device="cpu").shape == (64,)
    del mixed
    gc.collect()
    assert key not in TG._HOST_PULLS
    assert JG.new_host_key() > 0        # the reference's registry is its own


def test_entry_points_default_to_the_card():
    if torch.cuda.is_available():
        pytest.skip("this check is for a machine without a CUDA device")
    osc = TO.Sine(440.0, samplerate=SR)
    for call in (lambda: T.WaveSynth(SR), lambda: osc.render(16),
                 lambda: next(osc.blocks(16)), lambda: osc.gains(16),
                 lambda: next(iter(osc))):
        with pytest.raises(RuntimeError, match="device='cpu'"):
            call()
