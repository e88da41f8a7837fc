"""The tracker song of the repository, as text, and its kit made in NumPy
from the seed.

``TEXT`` is a frozen copy of ``examples/make_tracker_song.py``'s
``tracker.ini`` (trackmixer ``.ini`` pattern format).  The kit holds the
five sources the song names, at the lengths and in the roles of that
example's kit: a kick (0.22 s), a snare (0.14 s) written as a big-endian
16-bit AIFF as the example writes it, a hat (0.04 s), a plucked C4 (0.3 s)
for the one-shot sampler and one second of slow-attack sawtooth at C4 for
the looped pad.  All are 16-bit stereo at 44.1 kHz.

The program and the reference both read these files; neither makes them.
"""

from __future__ import annotations

import os
import struct

import numpy as np

from .kit import _env, write_wav

SR = 44100
C4 = 261.6255653005986

#: name -> (file, seconds), as the repository's tracker kit has them
FILES = {"kick": ("kick.wav", 0.22), "snare": ("snare.aiff", 0.14),
         "hat": ("hat.wav", 0.04), "pluck": ("pluck.wav", 0.3),
         "pad": ("pad.wav", 1.0)}

#: the song text, verbatim
TEXT = """\
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


def with_patterns(patterns: str) -> str:
    """The song with another pattern list (the tests' short forms)."""
    return TEXT.replace("patterns = a a b b a a", f"patterns = {patterns}")


def _sounds(rng: np.random.Generator) -> dict:
    t = {k: np.arange(int(v * SR)) / SR for k, (_, v) in FILES.items()}
    # kick: a 52 Hz sine whose pitch falls over the hit
    kf = 52.0 * (1.0 + rng.uniform(0.8, 1.2) * np.exp(-t["kick"] * 25))
    kick = 0.9 * np.sin(2 * np.pi * np.cumsum(kf) / SR)
    # snare: a 190 Hz triangle body and a noise burst
    ph = (190.0 * t["snare"] + rng.uniform()) % 1.0
    snare = (0.35 * (4.0 * np.abs(ph - 0.5) - 1.0)
             + 0.5 * rng.uniform(-1, 1, t["snare"].size))
    hat = 0.3 * rng.uniform(-1, 1, t["hat"].size)
    # pluck: decaying partials of C4 with random phases
    phs = rng.uniform(0, 2 * np.pi, 8)
    pluck = sum(np.exp(-t["pluck"] * (4.0 + 3.0 * k))
                * np.sin(2 * np.pi * C4 * (k + 1) * t["pluck"] + phs[k])
                / (k + 1) for k in range(8))
    # pad: a band-limited sawtooth at C4 (partials below 18 kHz), attack
    # 0.15 s, decay 0.1 s to 0.7, held, faded over the last 0.05 s
    tp = t["pad"]
    f0 = C4 * (1.0 + rng.uniform(-0.002, 0.002))
    p0 = rng.uniform()
    saw = sum((-1.0) ** (k + 1) * np.sin(2 * np.pi * k * (f0 * tp + p0)) / k
              for k in range(1, int(18000 / f0) + 1)) * (2 / np.pi)
    adsr = np.interp(tp, [0.0, 0.15, 0.25, 0.95, 1.0],
                     [0.0, 1.0, 0.7, 0.7, 0.0])
    return {
        "kick": kick * _env(kick.size, 0.002, 0.16, 0.05),
        "snare": snare * _env(snare.size, 0.001, 0.06, 0.04),
        "hat": hat * _env(hat.size, 0.0005, 0.015, 0.03),
        "pluck": 0.55 * pluck / np.abs(pluck).max()
        * _env(pluck.size, 0.001, 1.0, 0.04),
        "pad": 0.4 * saw * adsr,
    }


def make(seed: int) -> dict:
    """name -> int16 [n, 2] frames, from ``seed``."""
    rng = np.random.default_rng([seed & 0xFFFFFFFF, seed >> 32, 20])
    out = {}
    for name, x in _sounds(rng).items():
        pan = rng.uniform(-0.2, 0.2)
        st = np.stack([x * min(1.0, 1.0 - pan), x * min(1.0, 1.0 + pan)], 1)
        out[name] = np.clip(np.rint(st * 32767.0), -32768, 32767).astype(
            np.int16)
    return out


def write_aiff(path: str, frames: np.ndarray) -> None:
    """16-bit big-endian PCM AIFF: FORM, COMM (the rate as an 80-bit
    extended float), SSND."""
    data = np.ascontiguousarray(frames, ">i2")
    m, e = SR, 0
    while m < (1 << 63):
        m <<= 1
        e += 1
    rate80 = struct.pack(">HII", 16383 + 63 - e, m >> 32, m & 0xFFFFFFFF)
    comm = struct.pack(">HIH", data.shape[1], data.shape[0], 16) + rate80
    ssnd = struct.pack(">II", 0, 0) + data.tobytes()
    body = (b"AIFF" + b"COMM" + struct.pack(">I", len(comm)) + comm
            + b"SSND" + struct.pack(">I", len(ssnd)) + ssnd)
    with open(path, "wb") as f:
        f.write(b"FORM" + struct.pack(">I", len(body)) + body)


def write(kit: dict, outdir: str) -> str:
    """The kit under the song's file names in ``outdir`` -> ``outdir``."""
    os.makedirs(outdir, exist_ok=True)
    for name, frames in kit.items():
        fn = FILES[name][0]
        (write_aiff if fn.endswith(".aiff") else write_wav)(
            os.path.join(outdir, fn), frames)
    return outdir
