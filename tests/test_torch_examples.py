"""The port's examples (``synthesizer_tpu_torch/examples``) run in-process
on ``--device cpu``, mirroring ``tests/test_examples.py``: every WAV they
write is stereo with a peak above 1000, the MIDI demo's channels differ
(its pad is panned), and without ``--device`` they ask for the card."""

import wave

import numpy as np
import pytest
import torch

from synthesizer_tpu_torch.examples import (fm_bell, midi_demo,
                                            render_server_demo,
                                            sharded_mixdown)


def _wav(path):
    with wave.open(str(path)) as w:
        a = np.frombuffer(w.readframes(w.getnframes()), np.int16)
        return a.reshape(-1, w.getnchannels()), w.getnchannels()


def _peak(path):
    a, nch = _wav(path)
    return int(np.abs(a.astype(np.int64)).max()), nch


def test_fm_bell_example(tmp_path):
    fm_bell.main([str(tmp_path), "--device", "cpu"])
    for f in ("bell_graph.wav", "bell_eager.wav", "bell_chord.wav"):
        peak, nch = _peak(tmp_path / f)
        assert peak > 1000 and nch == 2, f


def test_midi_demo_example(tmp_path):
    midi_demo.main([str(tmp_path), "--device", "cpu"])
    assert (tmp_path / "demo.mid").stat().st_size > 200
    peak, nch = _peak(tmp_path / "midi_demo.wav")
    assert peak > 1000 and nch == 2
    a, _ = _wav(tmp_path / "midi_demo.wav")
    assert (a[:, 0] != a[:, 1]).any()


def test_render_server_demo_example(tmp_path):
    render_server_demo.main([str(tmp_path), "--device", "cpu"])
    for f in ("served_patch.wav", "served_voices.wav"):
        peak, nch = _peak(tmp_path / f)
        assert peak > 1000, f
    assert _peak(tmp_path / "served_voices.wav")[1] == 2


def test_sharded_mixdown_example(tmp_path, capsys):
    out = tmp_path / "sharded.wav"
    sharded_mixdown.main([str(out), "--device", "cpu"])
    peak, nch = _peak(out)
    assert peak > 1000 and nch == 2
    assert "over VoiceMesh(['cpu', 'cpu', 'cpu', 'cpu', 'cpu', 'cpu', " \
        "'cpu', 'cpu'])" in capsys.readouterr().out
    assert sharded_mixdown.shard_devices("cpu") == [torch.device("cpu")] * 8


@pytest.mark.parametrize("mod", [fm_bell, midi_demo, render_server_demo,
                                 sharded_mixdown])
def test_examples_default_to_the_card(mod, tmp_path, monkeypatch):
    """Without --device an example renders on the card, and without one it
    raises rather than fall back to the CPU."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device|CUDA"):
        mod.main([str(tmp_path / "x.wav" if mod is sharded_mixdown
                      else tmp_path)])
