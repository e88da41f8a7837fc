"""Config 5: the 64-voice song the bank is measured on, and an entry point
that renders it on the GPU to a WAV file.

``build_song`` is the twin of ``bench.build_song`` and ``demo_voices`` the
twin of ``__graft_entry__._demo_voices`` (same voices, same fields), so the
port renders exactly what the reference renders.

    python -m synthesizer_tpu_torch out.wav
"""

from __future__ import annotations

import argparse
import sys
import time

import torch

from .models.voicebank import Voice, VoiceBank, pack_voices
from .utils.wavio import write_wav

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
    pcm = bank.to_int16(bank.render_song(vp, total)).cpu().numpy()
    secs = time.perf_counter() - t0
    write_wav(args.out, pcm, SAMPLERATE, 2, 2)
    print(f"{total / SAMPLERATE:.1f} s of audio in {secs:.3f} s on "
          f"{torch.cuda.get_device_name(0)} (first call, kernel build "
          f"included) -> {args.out}")
    return 0
