"""The workloads the port is measured on, and an entry point that renders
config 5 on the GPU to a WAV file.

``build_song`` is the twin of ``bench.build_song`` and ``demo_voices`` the
twin of ``__graft_entry__._demo_voices`` (same voices, same fields), so the
port renders exactly what the reference renders.  ``sparse_voices`` is the
sparse-render workload of ``bench.py`` (600 notes over 300 s, seed 5), and
``gm_file`` a seeded General-MIDI file for the MIDI path; ``config3`` is
config 3 of ``bench.py``, the chainable ``Sample`` API with resampling.
``make_demo_kit`` and ``make_tracker_kit`` write the repo's two example
songs (``examples/make_demo_song.py``, ``examples/make_tracker_song.py``)
with the port's own instruments, for the sequencer path.

    python -m synthesizer_tpu_torch out.wav
"""

from __future__ import annotations

import argparse
import sys
import time

import numpy as np
import torch

from .midi import MidiNote, write_midi
from .models import spec as S
from .models.voicebank import Voice, VoiceBank, pack_voices
from .sample import Sample

#: config 5 (bench.py): 64 voices, 60 s at 44.1 kHz, chunk 131072, nharm 8
SAMPLERATE = 44100
NVOICES = 64
DURATION = 60.0
CHUNK_FRAMES = 131072
NUM_HARMONICS = 8
#: sha256 of config 5's int16 output from the plain path on the CPU (the
#: kernel on the card equals it bit for bit):
#: python -c "import hashlib; from synthesizer_tpu_torch import bench_song as b;
#:   k, vp, n = b.song_bank(device='cpu');
#:   print(hashlib.sha256(k.to_int16(k.render_song(vp, n)).numpy().tobytes()).hexdigest())"
CONFIG5_SHA256 = ("3294c70b55a4ba87991a4feefb9f38d6"
                  "04ee8ec402f1668b91d70d34581735d4")

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


def config2_voices():
    """Config 2 of ``bench.py``: an 8-voice FM + harmonics + ADSR bank,
    rendered to stereo for 2 s (nharm 4, chunk 16384)."""
    voices = []
    for i in range(8):
        fm = i % 2 == 0
        voices.append(Voice(
            wave="harmonics" if i % 4 == 3 else "sine",
            frequency=220.0 * 2 ** (i / 12), amplitude=0.1,
            pan=(i - 3.5) / 4, start=0.01 * i, duration=1.6,
            attack=0.01, decay=0.05, sustain_level=0.7, release=0.1,
            fm_frequency=5.0 if fm else 0.0, fm_depth=0.02 if fm else 0.0,
            harmonics=(1.0, 0.5, 0.33) if i % 4 == 3 else ()))
    return voices


def config1_patch() -> S.Node:
    """Config 1 of ``bench.py``: a 440 Hz sine (2 s at block 32768)."""
    return S.Osc("sine", 440.0, 0.9999)


def config4_patch() -> S.Node:
    """Config 4 of ``bench.py``: an LFO-modulated sawtooth under an
    amplitude LFO into an echo chain (30 blocks of 1470 frames)."""
    return S.Echo(
        S.AmpMod(S.Osc("sawtooth", 330.0, 0.7,
                       fm_lfo=S.Osc("sine", 5.0, 0.01)),
                 S.Osc("sine", 2.0, amplitude=0.4, bias=0.6)),
        0.05, 4, 0.07, 0.6)


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


# ---------------------------------------------------------------------------
# Song kits: the two example songs of the repo (examples/make_demo_song.py
# and examples/make_tracker_song.py), their instruments built with the
# port's WaveSynth and oscillators and their .ini texts kept verbatim
# ---------------------------------------------------------------------------

C4 = 261.6255653005986


def make_demo_kit(outdir: str, device="cuda") -> str:
    """The demo song's kit (6 drum/instrument WAVs and the pitched
    sampler's source) and ``demo.ini`` into ``outdir`` -> the ini path."""
    import os
    from . import oscillators as osc
    from .synth import WaveSynth
    sr = SAMPLERATE
    synth = WaveSynth(samplerate=sr, samplewidth=2, device=device)
    os.makedirs(outdir, exist_ok=True)

    def out(name):
        return os.path.join(outdir, name)

    # kick: descending sine thump
    sweep = osc.Sine(55.0, amplitude=0.9,
                     fm_lfo=osc.Linear(0.0, -4e-5, min_value=-0.7),
                     samplerate=sr)
    kick = synth.render_oscillator(
        osc.EnvelopeFilter(sweep, 0.002, 0.18, 0.0, 0.3, 0.05), 0.25, "kick")
    kick.amplify(1.2).fadeout(0.05).stereo().write_wav(out("kick.wav"))
    # snare: noise burst + 180 Hz body
    body = osc.Triangle(180.0, amplitude=0.4, samplerate=sr)
    noise = osc.WhiteNoise(amplitude=0.5, seed=11, samplerate=sr)
    snare = synth.render_oscillator(
        osc.EnvelopeFilter(osc.MixingFilter(body, noise),
                           0.001, 0.12, 0.0, 0.2, 0.03), 0.16, "snare")
    snare.fadeout(0.05).stereo().write_wav(out("snare.wav"))
    # closed and open hats
    hat = synth.white_noise(duration=0.05, amplitude=0.35, seed=7)
    hat.fadeout(0.04).stereo().write_wav(out("hat.wav"))
    ohat = synth.white_noise(duration=0.22, amplitude=0.3, seed=8)
    ohat.fadeout(0.2).stereo().write_wav(out("openhat.wav"))
    # bass pluck
    pluck = osc.EnvelopeFilter(
        osc.Harmonics(82.4, [(1, 0.7), (2, 0.35), (3, 0.18)], samplerate=sr),
        0.004, 0.25, 0.0, 0.3, 0.05)
    synth.render_oscillator(pluck, 0.3, "bass").stereo().write_wav(
        out("bass.wav"))
    # the pitched sampler's source: a plucked C4
    synth.pluck(C4, 0.35, amplitude=0.55, seed=14,
                damping=1.3).fadeout(0.05).stereo().write_wav(
        out("pluckgtr.wav"))
    # stab chord
    stab = osc.EnvelopeFilter(
        osc.MixingFilter(
            osc.Sawtooth(220.0, amplitude=0.2, samplerate=sr),
            osc.Sawtooth(277.2, amplitude=0.2, samplerate=sr),
            osc.Sawtooth(329.6, amplitude=0.2, samplerate=sr)),
        0.005, 0.2, 0.0, 0.4, 0.08)
    synth.render_oscillator(stab, 0.3, "stab").stereo().write_wav(
        out("stab.wav"))
    with open(out("demo.ini"), "w") as f:
        f.write(DEMO_INI)
    return out("demo.ini")


def make_tracker_kit(outdir: str, device="cuda") -> str:
    """The tracker song's kit and ``tracker.ini`` into ``outdir`` -> the
    ini path.  As in the reference's example, the snare is written as an
    AIFF, which the song loads through the in-process decoder
    (``utils.decoders``); the song text is verbatim."""
    import os
    import struct
    from . import oscillators as osc
    from .synth import WaveSynth
    sr = SAMPLERATE
    synth = WaveSynth(samplerate=sr, samplewidth=2, device=device)
    os.makedirs(outdir, exist_ok=True)

    def out(name):
        return os.path.join(outdir, name)

    kick = synth.render_oscillator(
        osc.EnvelopeFilter(
            osc.Sine(52.0, amplitude=0.9,
                     fm_lfo=osc.Linear(0.0, -5e-5, min_value=-0.6),
                     samplerate=sr), 0.002, 0.16, 0.0, 0.3, 0.05),
        0.22, "kick")
    kick.fadeout(0.05).stereo().write_wav(out("kick.wav"))
    snare = synth.render_oscillator(
        osc.EnvelopeFilter(
            osc.MixingFilter(osc.Triangle(190.0, amplitude=0.35,
                                          samplerate=sr),
                             osc.WhiteNoise(amplitude=0.5, seed=3,
                                            samplerate=sr)),
            0.001, 0.1, 0.0, 0.2, 0.03), 0.14, "snare")
    snare.fadeout(0.04).stereo()
    # AIFF: big-endian 16-bit PCM, the rate as an 80-bit extended float
    frames = snare.get_frame_array().astype(">i2")
    m, e = sr, 0
    while m < (1 << 63):
        m <<= 1
        e += 1
    rate80 = struct.pack(">HII", 16383 + 63 - e, m >> 32, m & 0xFFFFFFFF)
    comm = struct.pack(">HIH", 2, len(frames), 16) + rate80
    ssnd = struct.pack(">II", 0, 0) + frames.tobytes()
    body = (b"AIFF" + b"COMM" + struct.pack(">I", len(comm)) + comm
            + b"SSND" + struct.pack(">I", len(ssnd)) + ssnd)
    with open(out("snare.aiff"), "wb") as f:
        f.write(b"FORM" + struct.pack(">I", len(body)) + body)
    hat = synth.white_noise(duration=0.04, amplitude=0.3, seed=5)
    hat.fadeout(0.03).stereo().write_wav(out("hat.wav"))
    # one-shot melodic source: Karplus-Strong pluck, repitched per note
    synth.pluck(C4, 0.3, amplitude=0.55, seed=21, damping=1.2) \
        .fadeout(0.04).stereo().write_wav(out("pluck.wav"))
    # looped pad source: one second of slow-attack saw; the song loops
    # its steady middle
    pad = synth.render_oscillator(
        osc.EnvelopeFilter(osc.BandlimitedSawtooth(C4, amplitude=0.4,
                                                   samplerate=sr),
                           0.15, 0.1, 0.7, 0.8, 0.05), 1.0, "pad")
    pad.stereo().write_wav(out("pad.wav"))
    with open(out("tracker.ini"), "w") as f:
        f.write(TRACKER_INI)
    return out("tracker.ini")


DEMO_INI = """\
; demo song for synthesizer_tpu trackmixer
[song]
bpm = 128
ticks = 4
patterns = intro main main fill main main outro

[paths]
samples = .

[instruments]
kick = kick.wav
snare = snare.wav
hat = hat.wav
openhat = openhat.wav
bass = bass.wav
stab = stab.wav

[synth.lead]
wave = square_bl
amplitude = 0.22
attack = 0.008
decay = 0.04
sustain_level = 0.6
release = 0.09
pan = 0.25

[sampler.pluckgtr]
; tracker-style pitched sample playback (beyond-reference)
file = pluckgtr.wav
base_note = C4

[synth.gtr]
; Karplus-Strong plucked string (beyond-reference physical modeling)
wave = pluck
amplitude = 0.3
damping = 1.4
seed = 4
attack = 0.0
decay = 0.0
sustain_level = 1.0
release = 0.12
pan = -0.35

[synth.sub]
wave = sine
amplitude = 0.35
attack = 0.004
decay = 0.03
sustain_level = 0.8
release = 0.06
pan = -0.1

[fx]
; master bus: gentle glue compression + a small room, a tempo-synced
; slapback, and a safety brickwall (all beyond-reference)
compress = threshold_db=-10 ratio=3 attack=0.004 release=0.12 makeup_db=1.5
reverb = roomsize=0.45 damping=0.6 wet=0.14 dry=0.95 tail=0.6
echo = beats=0.75 feedback=0.25 wet=0.12
limiter = ceiling_db=-0.5 lookahead=0.004

[fx.lead]
; per-synth-track chain: the lead gets its own chorus bus
chorus = rate=1.2 depth=0.002 delay=0.014 wet=0.35

[automation]
; hats ride up across the song; the whole mix fades over the outro
track.hat.volume = 0:0.6 48:1.0
fx.reverb.wet = 0:0.10 64:0.22
fx.echo.wet = 0:0.06 64:0.16
master.volume = 0:1 96:1 112:0

[pattern.intro]
hat   = x.x. x.x. x.x. x.x.
kick  = x... .... x... ....

[pattern.main]
kick  = x... x... x... x...
snare = .... x... .... x...
hat   = x.x. x.x. x.x. x.xx
bass  = x... ..x. x... ..x.
stab  = .... .... x... ....
lead  = E4 .. G4 A4 -  .. E5 D5 -  .. A4 -  G4 .. E4 -
gtr   = E3 .. .. B3 .. .. G3 .. E3 .. .. B2 .. .. A2 ..
pluckgtr = .. E4 .. .. G4 .. .. B4 .. E5 .. .. B4 .. G4 ..
sub   = E2 -  -  -  A1 -  -  -  C2 -  -  -  B1 -  -  -

[pattern.fill]
kick  = x... x... x... xxxx
snare = .... x... .x.x xxxx
hat   = x.x. x.x. x.x. ....
openhat = .... .... .... x...

[pattern.outro]
kick  = x... .... x... ....
openhat = x... .... .... ....
bass  = x... .... ..x. ....
sub   = E1 -  -  -  -  -  -  -  -  -  -  -  -  -  -  -
"""

# verbatim
TRACKER_INI = """\
; tracker-style demo: samplers + loops + accents + automation + swing
[song]
bpm = 112
ticks = 4
swing = 0.25
patterns = a a b b a a

[paths]
samples = .

[instruments]
kick = kick.wav
snare = snare.aiff
hat = hat.wav

[sampler.pluck]
file = pluck.wav
base_note = C4

[sampler.pad]
file = pad.wav
base_note = C4
loop_start = 0.45
loop_end = 0.85
release = 0.12

[fx.hat]
filter = kind=highpass cutoff=6000 q=0.7071

[fx.pluck]
; per-sampler-track chain: the pluck gets its own slap-room
reverb = roomsize=0.35 damping=0.7 wet=0.2 dry=0.9 tail=0.25

[fx.pad]
; sidechain ducking (round 3): the pad pumps under the kick
compress = threshold_db=-14 ratio=8 attack=0.002 release=0.11 sidechain=kick

[fx]
compress = threshold_db=-11 ratio=3 attack=0.004 release=0.1 makeup_db=1
filter = kind=lowpass cutoff=9000 q=0.7071
reverb = roomsize=0.5 damping=0.55 wet=0.12 dry=0.95 tail=0.5

[automation]
track.hat.volume = 0:0.5 32:1.0
track.pluck.pan = 0:-0.6 48:0.6
fx.filter.cutoff = 0:900 24:9000 96:9000
fx.reverb.wet = 0:0.08 64:0.2
; recurrence-internal curves (round 3): the compressor releases slower and
; the room grows as the song builds
fx.compress.release = 0:0.05 48:0.25
fx.reverb.roomsize = 0:0.35 64:0.7
master.volume = 0:1 80:1 96:0

[pattern.a]
kick  = X... x... X... x...
snare = .... x... .... o...
hat   = x.o. x.o. x.o. x.oo
pluck = C3 .. E3 G3 .. C4@0.6 .. .. A2 .. C3 E3 .. G3@0.5 .. ..
pad   = C3 - - - - - - - A2 - - - - - - -

[pattern.b]
kick  = X... x..x X... x...
snare = .... x... ..o. x..X
hat   = xxo. x.o. xxo. x.o.
pluck = F3 .. A3 C4 .. F4@0.5 .. .. G2 .. B2 D3 .. G3 .. ..
pad   = F2 - - - - - - - G2 - - - - - - -
"""


def repeated(ini_text: str, times: int) -> str:
    """A song text with its ``patterns =`` list repeated ``times`` times
    (the long form of a song at the same widths)."""
    out = []
    for line in ini_text.splitlines():
        if line.startswith("patterns ="):
            pats = line.split("=", 1)[1].split()
            line = "patterns = " + " ".join(pats * times)
        out.append(line)
    return "\n".join(out) + "\n"


def strip_fx(ini_text: str) -> str:
    """A song text without its [fx] and [fx.TRACK] sections and without
    the fx.* automation keys: the dry song."""
    out, skip = [], False
    for line in ini_text.splitlines():
        s = line.strip()
        if s.startswith("["):
            skip = s == "[fx]" or s.startswith("[fx.")
        if skip or s.startswith("fx."):
            continue
        out.append(line)
    return "\n".join(out) + "\n"
