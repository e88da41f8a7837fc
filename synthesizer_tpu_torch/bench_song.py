"""The workloads the port is measured on, and an entry point that renders
config 5 on the GPU to a WAV file.

``build_song`` is the twin of ``bench.build_song`` and ``demo_voices`` the
twin of ``__graft_entry__._demo_voices`` (same voices, same fields), so the
port renders exactly what the reference renders.  ``sparse_voices`` is the
sparse-render workload of ``bench.py`` (600 notes over 300 s, seed 5), and
``gm_file`` a seeded General-MIDI file for the MIDI path; ``config3`` is
config 3 of ``bench.py``, the chainable ``Sample`` API with resampling.

    python -m synthesizer_tpu_torch out.wav
"""

from __future__ import annotations

import argparse
import sys
import time

import numpy as np
import torch

from .midi import MidiNote, write_midi
from .models.voicebank import Voice, VoiceBank, pack_voices
from .sample import Sample

#: config 5 (bench.py): 64 voices, 60 s at 44.1 kHz, chunk 131072, nharm 8
SAMPLERATE = 44100
NVOICES = 64
DURATION = 60.0
CHUNK_FRAMES = 131072
NUM_HARMONICS = 8

_WAVES = ("sine", "triangle", "square", "sawtooth", "pulse",
          "semicircle", "pointy", "harmonics")


def build_song(nvoices: int, duration: float, samplerate: int = SAMPLERATE):
    """A dense synth song: chords/arps across eight waveforms with FM on a
    third of the voices and 8-partial harmonic stacks on an eighth."""
    voices = []
    for i in range(nvoices):
        w = _WAVES[i % len(_WAVES)]
        note_len = 0.25 + (i % 7) * 0.05
        voices.append(Voice(
            wave=w,
            frequency=55.0 * (2 ** ((i % 36) / 12.0)),
            amplitude=0.5 / 8,
            pan=((i % 17) - 8) / 8.0,
            start=(i / nvoices) * (duration - 1.0),
            duration=min(note_len * 8, duration / 2),
            attack=0.01, decay=0.05, sustain_level=0.7, release=0.1,
            fm_frequency=5.0 + (i % 5) if i % 3 == 0 else 0.0,
            fm_depth=0.015 if i % 3 == 0 else 0.0,
            harmonics=[1.0, 0.5, 0.33, 0.25, 0.2, 0.16, 0.14, 0.125]
            if w == "harmonics" else (),
            seed=i,
        ))
    return voices


def demo_voices(n: int = 64):
    """The ungrouped 64-voice demo bank (one mixed group)."""
    voices = []
    for i in range(n):
        w = _WAVES[i % len(_WAVES)]
        voices.append(Voice(
            wave=w,
            frequency=110.0 * (1 + (i % 12)),
            amplitude=0.6 / n * 8,
            pan=((i % 9) - 4) / 4.0,
            start=0.001 * i,
            duration=0.5,
            fm_frequency=5.0 if i % 3 == 0 else 0.0,
            fm_depth=0.01 if i % 3 == 0 else 0.0,
            harmonics=[1.0, 0.5, 0.25, 0.125] if w == "harmonics" else (),
            seed=i,
        ))
    return voices


def sparse_voices(nnotes: int = 600, duration: float = 300.0, seed: int = 5):
    """The sparse-render workload of ``bench.py`` (its ``sparse_rtf``):
    ``nnotes`` 0.4 s notes of three waveforms at random starts over
    ``duration`` seconds, a few sounding at once."""
    rng = np.random.default_rng(seed)
    return [Voice(
        wave=("sine", "sawtooth_bl", "triangle")[i % 3],
        frequency=float(rng.uniform(80, 2000)), amplitude=0.08,
        pan=float(rng.uniform(-1, 1)),
        start=round(float(rng.uniform(0, duration - 1.0)), 3),
        duration=0.4, attack=0.005, decay=0.05, sustain_level=0.7,
        release=0.1) for i in range(nnotes)]


def gm_events(nnotes: int, duration: float, seed: int = 0):
    """A seeded General-MIDI song for ``write_midi``: ``nnotes`` notes on 16
    channels (channel 10, index 9, is percussion) over ``duration``
    seconds, with the controllers the MIDI path turns into curves.
    Returns (notes, bends, controls, pressures, poly_pressures).

    - programs from every GM family the mapping knows, pan on most
      channels;
    - pitch-bend sweeps on channels 0-3, channel 1 with a +-12 semitone
      range set through RPN 0,0;
    - CC7/CC11 fades on channels 4 and 5, CC1 vibrato swells on 6 and 7,
      channel pressure on 8, poly pressure on 10;
    - the sustain pedal (CC64) going down and up on channel 0."""
    rng = np.random.default_rng(seed)
    families = (0, 16, 24, 32, 40, 56, 80, 88)
    programs = [families[c % 8] + int(rng.integers(0, 8)) for c in range(16)]
    pans = [None if c % 5 == 4 else float(rng.uniform(-1, 1))
            for c in range(16)]
    notes = []
    for _ in range(nnotes):
        ch = int(rng.integers(0, 16))
        start = round(float(rng.uniform(0.0, duration - 2.0)), 4)
        if ch == 9:
            key, dur = int(rng.integers(35, 52)), float(rng.uniform(0.05, 0.2))
        else:
            key = int(rng.integers(36, 90))
            dur = float(rng.uniform(0.08, 1.2))
        notes.append(MidiNote(start, round(dur, 4), key,
                              int(rng.integers(20, 90)), ch, programs[ch],
                              pan=pans[ch]))
    notes.sort(key=lambda n: n.start)
    step = 0.02

    def ramp(t0, length):
        return [round(t0 + k * step, 4) for k in range(int(length / step))]

    def spots(count, length):
        return sorted(float(t) for t in rng.uniform(0.0, duration - length - 1,
                                                    count))

    nsweeps = max(2, int(duration / 6))
    bends, controls, pressures, poly = [], [], [], []
    controls += [(0.0, 1, 101, 0), (0.0, 1, 100, 0), (0.0, 1, 6, 12),
                 (0.0, 1, 38, 0)]
    for ch in range(4):
        for t0 in spots(nsweeps, 0.6):
            ts = ramp(t0, 0.6)
            bends += [(t, ch, int(8191 * np.sin(np.pi * k / len(ts))
                                  * (1 if ch % 2 else -1)))
                      for k, t in enumerate(ts)]
            bends.append((round(ts[-1] + step, 4), ch, 0))
    for ch, cc in ((4, 7), (5, 11)):
        for t0 in spots(nsweeps, 1.0):
            ts = ramp(t0, 1.0)
            controls += [(t, ch, cc, int(127 - 100 * k / len(ts)))
                         for k, t in enumerate(ts)]
            controls.append((round(ts[-1] + step, 4), ch, cc, 127))
    for ch in (6, 7):
        for t0 in spots(nsweeps, 1.0):
            ts = ramp(t0, 1.0)
            controls += [(t, ch, 1, int(127 * k / len(ts)))
                         for k, t in enumerate(ts)]
            controls.append((round(ts[-1] + step, 4), ch, 1, 0))
    for t0 in spots(nsweeps, 0.8):
        ts = ramp(t0, 0.8)
        pressures += [(t, 8, int(120 * k / len(ts))) for k, t in enumerate(ts)]
        pressures.append((round(ts[-1] + step, 4), 8, 0))
    for n in [n for n in notes if n.channel == 10][:nsweeps]:
        poly += [(round(n.start + 0.05 * k, 4), 10, n.note, 30 * k)
                 for k in range(1, 4)]
    for t0 in spots(nsweeps, 2.0):
        controls += [(round(t0, 4), 0, 64, 127), (round(t0 + 2.0, 4), 0, 64, 0)]
    return notes, bends, controls, pressures, poly


def gm_file(nnotes: int = 3000, duration: float = 180.0,
            seed: int = 0) -> bytes:
    """``gm_events`` written as a format-0 SMF by the port's
    ``write_midi``."""
    notes, bends, controls, pressures, poly = gm_events(nnotes, duration, seed)
    return write_midi(notes, bends=bends, controls=controls,
                      pressures=pressures, poly_pressures=poly)


def song_bank(nvoices: int = NVOICES, duration: float = DURATION,
              device="cuda", chunk_frames: int = CHUNK_FRAMES):
    """Pack ``build_song(nvoices, duration)`` grouped by waveform on
    ``device`` -> (VoiceBank, VoiceParams, total frames)."""
    voices = build_song(nvoices, duration, SAMPLERATE)
    vp, layout = pack_voices(voices, SAMPLERATE, num_harmonics=NUM_HARMONICS,
                             sort_by_wave=True, device=device)
    bank = VoiceBank.for_voices(voices, SAMPLERATE, chunk_frames=chunk_frames,
                                num_harmonics=NUM_HARMONICS, layout=layout,
                                nvoices=layout.nvoices, device=device)
    return bank, vp, int(duration * SAMPLERATE)


def song_sample(bank: VoiceBank, vp, total: int) -> Sample:
    """The main path up to the device: render, quantize, wrap as a
    ``Sample`` (whose ``get_frame_array`` is the copy to the host)."""
    return Sample.from_torch(bank.to_int16(bank.render_song(vp, total)),
                             SAMPLERATE, 2, name="config5")


def config3(samplerate: int = SAMPLERATE, device="cuda", tracks: int = 16,
            track_sec: float = 2.0, gap: float = 1.0) -> Sample:
    """Config 3 of ``bench.py`` (the chainable ``Sample`` API): ``tracks``
    sines of ``track_sec`` seconds rendered at 22050 Hz, each resampled to
    ``samplerate``, amplified, faded in and out, made stereo and mixed in at
    ``gap``-second offsets into one stereo ``Sample``."""
    from .synth import WaveSynth
    synth = WaveSynth(samplerate=22050, samplewidth=2, device=device)
    total = Sample.from_raw_frames(b"", 2, samplerate, 2, device=device)
    for t in range(tracks):
        s = synth.sine(100.0 + 50 * t, track_sec, amplitude=0.4)
        s.resample(samplerate).amplify(0.5 + 0.02 * t) \
         .fadein(0.02).fadeout(0.05).stereo()
        total.mix_at(gap * t, s)
    return total


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(
        prog="python -m synthesizer_tpu_torch",
        description="Render config 5 (64 voices, 60 s) on the GPU to a WAV.")
    ap.add_argument("out", help="output WAV path (16-bit stereo, 44.1 kHz)")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("error: no CUDA device", file=sys.stderr)
        return 1
    bank, vp, total = song_bank()
    t0 = time.perf_counter()
    song = song_sample(bank, vp, total)
    song.get_frame_array()          # the pinned host copy, timed with it
    secs = time.perf_counter() - t0
    song.write_wav(args.out)
    print(f"{total / SAMPLERATE:.1f} s of audio in {secs:.3f} s on "
          f"{torch.cuda.get_device_name(0)} (first call, kernel build "
          f"included) -> {args.out}")
    return 0
