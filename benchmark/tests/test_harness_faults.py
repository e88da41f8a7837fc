"""A whole run of each cell on the CPU, with the look for a card stubbed:
a sound run comes out correct, and the control and each fault a cell can
have, planted underneath the timed path, come out not correct."""

import numpy as np
import pytest

from benchmark.kinds import midi as KM
from benchmark.kinds import song as K
from synthesizer_tpu_torch import sample as S
from synthesizer_tpu_torch import sequencer as Q

from .cpu_run import run_cell

#: the render cell at its shortest: one length, one warm call
SMALL_RENDER = {"repeats": [1], "warm_calls": 1}


def _render(monkeypatch, **kw):
    return run_cell(monkeypatch, "demo_song.render", seconds=0.1,
                    cell_edit=lambda c: c["traffic"].update(SMALL_RENDER),
                    **kw)


def _short_stream(monkeypatch):
    """The stream cell over the song's outro alone, so that a pass fits
    a short window on the CPU."""
    monkeypatch.setattr(K.SongKind, "text", lambda self, rng=None, k=1:
                        self.module.variant(["outro"], 1))
    return run_cell(monkeypatch, "demo_song.stream", seconds=0.1,
                    cell_edit=lambda c: c["traffic"].update(warm_passes=0))


def _altered(monkeypatch):
    """One frame of every render altered where it is produced."""
    orig = S.Sample.get_frame_array

    def altered(self, *a, **k):
        out = np.array(orig(self, *a, **k))
        out[len(out) // 2] += 100
        return out
    monkeypatch.setattr(S.Sample, "get_frame_array", altered)


def _dropped_voice(monkeypatch):
    """The last synth note of the song left out."""
    orig = Q.Song.compile_synth_voices

    def dropped(self, return_tracks=False):
        v, t = orig(self, return_tracks=True)
        return (v[:-1], t[:-1]) if return_tracks else v[:-1]
    monkeypatch.setattr(Q.Song, "compile_synth_voices", dropped)


def test_sound_render_is_correct(monkeypatch):
    code, line, err = _render(monkeypatch)
    assert code == 0, err
    assert line["correct"], line
    assert line["attempted"] >= 1 and line["failed"] == 0
    assert set(line["metrics"]) == {"render_x_realtime", "setup_s"}
    assert list(line)[-1] == "checks"
    assert "render_lsb_gap" in err.splitlines()[-1]


def test_kernel_build_is_timed_apart(monkeypatch, tmp_path):
    """A run that builds the kernel library says so, with the build's
    seconds, which ``setup_s`` holds too."""
    import time
    from synthesizer_tpu_torch.ops import kernels
    monkeypatch.setattr(kernels, "BUILD_DIR", tmp_path)
    code, line, err = _render(monkeypatch)
    assert code == 0, err
    assert line["build"]["built"] is False

    def build():
        time.sleep(0.05)
        (tmp_path / "voicebank_render_x.so").write_bytes(b"")
        return tmp_path / "voicebank_render_x.so", ""
    code, line, err = _render(monkeypatch, build=build)
    assert code == 0, err
    assert line["build"]["built"] is True
    assert 0.05 <= line["build"]["build_s"] < \
        line["metrics"]["setup_s"]["value"]
    assert list(line)[-1] == "checks"


@pytest.mark.parametrize("fault", [_altered, _dropped_voice])
def test_render_fault_is_not_correct(monkeypatch, fault):
    fault(monkeypatch)
    code, line, err = _render(monkeypatch)
    assert code == 0, err
    assert not line["correct"], line


def test_render_control_is_not_correct(monkeypatch):
    """The reference one precision down (bfloat16) in the program's
    place."""
    monkeypatch.setattr(K.SongKind, "render", lambda self, text:
                        self.reference(text, control=True))
    code, line, err = _render(monkeypatch)
    assert code == 0, err
    assert not line["correct"], line
    assert line["checks"]["render_lsb_gap"]["value"] > \
        line["checks"]["render_lsb_gap"]["limit"]


def test_sound_stream_is_correct(monkeypatch):
    code, line, err = _short_stream(monkeypatch)
    assert code == 0, err
    assert line["correct"], line
    assert set(line["metrics"]) == {"render_x_realtime", "chunk_p95_ms",
                                    "setup_s"}


@pytest.mark.parametrize("fault", [_altered, _dropped_voice])
def test_stream_fault_is_not_correct(monkeypatch, fault):
    fault(monkeypatch)
    code, line, err = _short_stream(monkeypatch)
    assert code == 0, err
    assert not line["correct"], line


def _midi(monkeypatch):
    """The MIDI cell at a size the CPU renders in seconds."""
    monkeypatch.setattr(KM.MidiKind, "device", "cpu")
    return run_cell(monkeypatch, "gm_midi.render", seconds=0.1,
                    cell_edit=lambda c: c["traffic"].update(
                        notes=40, seconds=4.0, pool=1, warm_calls=1))


def _dropped_note(monkeypatch):
    """The last note of the file left out of the render."""
    from synthesizer_tpu_torch import midi as M
    orig = M.midi_to_voices
    monkeypatch.setattr(M, "midi_to_voices",
                        lambda notes, *a, **k: orig(notes, *a, **k)[:-1])


def test_sound_midi_is_correct(monkeypatch):
    code, line, err = _midi(monkeypatch)
    assert code == 0, err
    assert line["correct"], line


@pytest.mark.parametrize("fault", [_altered, _dropped_note])
def test_midi_fault_is_not_correct(monkeypatch, fault):
    fault(monkeypatch)
    code, line, err = _midi(monkeypatch)
    assert code == 0, err
    assert not line["correct"], line


def test_midi_control_is_not_correct(monkeypatch):
    monkeypatch.setattr(KM.MidiKind, "render", lambda self, data:
                        self.reference(data, control=True))
    code, line, err = _midi(monkeypatch)
    assert code == 0, err
    assert not line["correct"], line
