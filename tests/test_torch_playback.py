"""The port's playback engine (``synthesizer_tpu_torch.playback``) against
``synthesizer_tpu.playback`` on the CPU.

Tolerances: the mixer's chunks are integer sums of the samples' frames,
bit-exact; with pop prevention the samples first take ``Sample.fadein`` /
``fadeout``, whose f32 gains are within 1 LSB of the JAX package's.
``Output`` (pop prevention off, the default) in sequential mode writes the
reference's WAV file byte for byte; in mixed mode the audio between the
leading and trailing silent chunks is the reference's, bit for bit.
"""

import threading
import time
import wave

import numpy as np
import pytest

import synthesizer_tpu as J
import synthesizer_tpu_torch as T
from synthesizer_tpu import playback as JP
from synthesizer_tpu_torch import playback as TP

SR = 22050
CF = 1000


def _sample(K, freq, dur, seed=0, nch=2, **kw):
    rng = np.random.default_rng(seed)
    n = int(dur * SR)
    t = np.arange(n) / SR
    base = np.sin(2 * np.pi * freq * t) * 12000 + rng.normal(0, 500, n)
    a = np.rint(np.stack([base, base * -0.6][:nch], 1)).astype(np.int16)
    return K.Sample.from_raw_frames(a.tobytes(), 2, SR, nch, name=f"s{seed}",
                                    **kw)


def _mix(P, K, pop, **kw):
    m = P.RealTimeMixer(CF, SR, 2, pop_prevention=pop)
    ended = []
    m.register_ended_callback(ended.append)
    a = m.add_sample(_sample(K, 440, 0.11, 1, **kw))
    b = m.add_sample(_sample(K, 660, 0.07, 2, **kw), delay=0.05)
    c = m.add_sample(_sample(K, 220, 0.03, 3, **kw), repeat=True)
    gen = m.chunks()
    out = [next(gen) for _ in range(5)]
    m.remove_sample(c)
    out += [next(gen) for _ in range(3)]
    return out, ended, (a, b, c), m.active_count


@pytest.mark.parametrize("pop", [False, True])
def test_mixer_chunks_equal_the_reference(pop):
    """Three samples (one delayed, one looping and then stopped), with and
    without pop prevention: the same chunks, the same ended-callbacks in
    the same order."""
    got, ended, sids, active = _mix(TP, T, pop, device="cpu")
    want, jended, _, jactive = _mix(JP, J, pop)
    assert len(got) == len(want) == 8
    for g, w in zip(got, want):
        assert g.shape == (CF, 2) and g.dtype == np.int16
        assert _lsb(g, w) <= (1 if pop else 0)
    assert ended == jended == [sids[0], sids[1]] and active == jactive == 0
    assert not np.any(got[-1])


def _lsb(a, b):
    assert a.shape == b.shape, (a.shape, b.shape)
    return int(np.abs(a.astype(np.int64) - b.astype(np.int64)).max())


def _trimmed(path):
    """A WAV file's frames without its leading and trailing all-zero
    chunks of CF frames."""
    with wave.open(path) as w:
        a = np.frombuffer(w.readframes(w.getnframes()), np.int16).reshape(
            -1, w.getnchannels())
    live = [i for i in range(0, len(a), CF) if np.any(a[i:i + CF])]
    return a[live[0]:live[-1] + CF] if live else a[:0]


def _output(P, K, path, mixing, **kw):
    """Play a stereo and a mono sample through Output into a WAV sink whose
    first chunk waits until both are queued, so that in mixed mode both
    voices start in the same chunk."""
    class GatedSink(P.WavSinkAudio):
        def __init__(self):
            super().__init__(SR, 2, 2, path)
            self.entered, self.gate = threading.Event(), threading.Event()

        def play_chunk(self, frames):
            self.entered.set()
            self.gate.wait(10.0)
            super().play_chunk(frames)

    played = []
    sink = GatedSink()
    with P.Output(samplerate=SR, nchannels=2, frames_per_chunk=CF,
                  mixing=mixing, api=sink) as out:
        out.register_notify_played(lambda s: played.append(s.name))
        if mixing == "mixed":
            assert sink.entered.wait(10.0)
        for s in (_sample(K, 440, 0.06, 4, **kw),
                  _sample(K, 550, 0.04, 5, nch=1, **kw)):
            out.play_sample(s)
        sink.gate.set()
        deadline = time.time() + 10.0
        while (out.still_playing() or len(played) < 2) \
                and time.time() < deadline:
            time.sleep(0.005)
    return played


@pytest.mark.parametrize("mixing", ["sequential", "mixed"])
def test_output_writes_the_reference_file(mixing, tmp_path):
    """Output with the WAV sink: a stereo and a mono sample (the mono one
    made stereo on its way in); the notify-played callbacks fire for both;
    sequential mode writes the reference's file byte for byte, mixed mode
    its audio between the silent chunks."""
    pt, pj = str(tmp_path / "t.wav"), str(tmp_path / "j.wav")
    played = _output(TP, T, pt, mixing, device="cpu")
    jplayed = _output(JP, J, pj, mixing)
    assert sorted(played) == sorted(jplayed) == ["s4", "s5"]
    if mixing == "sequential":
        assert open(pt, "rb").read() == open(pj, "rb").read()
        assert played == ["s4", "s5"]
    else:
        got, want = _trimmed(pt), _trimmed(pj)
        assert len(got) >= int(0.06 * SR)
        assert _lsb(got, want) == 0


def test_output_master_fx_runs_on_its_device(tmp_path):
    """A master-bus FxChain on the CPU processes the mixed chunks (with a
    lookahead of 2 chunks) before the WAV sink."""
    from synthesizer_tpu_torch.effects import FxChain
    p = str(tmp_path / "fx.wav")
    fx = FxChain([("width", {"amount": 0.0})], SR, 2, device="cpu")
    with TP.Output(samplerate=SR, nchannels=2, frames_per_chunk=CF,
                   mixing="mixed", wav_file=p, fx=fx, fx_lookahead=2) as out:
        out.play_sample(_sample(T, 330, 0.05, 6, device="cpu"))
        deadline = time.time() + 10.0
        while out.still_playing() and time.time() < deadline:
            time.sleep(0.005)
    a = _trimmed(p)
    assert len(a) > 0 and np.array_equal(a[:, 0], a[:, 1])  # width 0: mono


def test_best_api_falls_back_to_the_file_and_null_sinks(tmp_path):
    assert isinstance(TP.best_api(SR, 2, 2), TP.NullAudio)
    api = TP.best_api(SR, 2, 2, wav_file=str(tmp_path / "x.wav"))
    assert isinstance(api, TP.WavSinkAudio)
    api.play_chunk(np.zeros((10, 2), np.int16))
    api.close()
    api.play_chunk(np.zeros((10, 2), np.int16))      # after close: dropped
    with wave.open(str(tmp_path / "x.wav")) as w:
        assert w.getnframes() == 10
    with pytest.raises(ValueError, match="16-bit"):
        TP.Output(samplewidth=4, mixing="mixed")
