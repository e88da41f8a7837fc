"""The demo song's kit, made in NumPy from the seed: the six drum and
instrument samples of ``[instruments]`` and the pitched sampler's source,
at the lengths and in the roles of ``examples/make_demo_song.py``'s kit, as
16-bit stereo WAV files at 44.1 kHz.

The program and the reference both read these files; neither makes them.
"""

from __future__ import annotations

import os
import wave

import numpy as np

SR = 44100

#: name -> seconds, as the repository's demo kit has them
LENGTHS = {"kick": 0.25, "snare": 0.16, "hat": 0.05, "openhat": 0.22,
           "bass": 0.3, "stab": 0.3, "pluckgtr": 0.35}


def _env(n: int, attack: float, decay: float, fade: float) -> np.ndarray:
    """An attack ramp, an exponential decay and a linear fade-out."""
    t = np.arange(n) / SR
    g = np.minimum(1.0, t / max(attack, 1e-9)) * np.exp(-t / decay)
    nf = int(fade * SR)
    if nf:
        g[-nf:] *= np.linspace(1.0, 0.0, nf)
    return g


def _sounds(rng: np.random.Generator) -> dict:
    t = {k: np.arange(int(v * SR)) / SR for k, v in LENGTHS.items()}
    kick_f = 55.0 * (1.0 + rng.uniform(0.9, 1.1) * np.exp(-t["kick"] * 30))
    kick = 0.9 * np.sin(2 * np.pi * np.cumsum(kick_f) / SR)
    snare = (0.4 * np.sin(2 * np.pi * 180.0 * t["snare"])
             + 0.5 * rng.uniform(-1, 1, t["snare"].size))
    hat = 0.35 * rng.uniform(-1, 1, t["hat"].size)
    ohat = 0.3 * rng.uniform(-1, 1, t["openhat"].size)
    bass = sum(a * np.sin(2 * np.pi * 82.4 * h * t["bass"])
               for h, a in ((1, 0.7), (2, 0.35), (3, 0.18)))
    stab = sum(0.2 * (2.0 * ((f * t["stab"]) % 1.0) - 1.0)
               for f in (220.0, 277.2, 329.6))
    # a plucked C4: decaying partials with random phases
    c4 = 261.6255653005986
    ph = rng.uniform(0, 2 * np.pi, 8)
    pluck = sum(np.exp(-t["pluckgtr"] * (3.0 + 2.5 * k))
                * np.sin(2 * np.pi * c4 * (k + 1) * t["pluckgtr"] + ph[k])
                / (k + 1) for k in range(8))
    return {
        "kick": 1.2 * kick * _env(kick.size, 0.002, 0.12, 0.05),
        "snare": snare * _env(snare.size, 0.001, 0.05, 0.05),
        "hat": hat * _env(hat.size, 0.0005, 0.02, 0.04),
        "openhat": ohat * _env(ohat.size, 0.0005, 0.1, 0.2),
        "bass": bass * _env(bass.size, 0.004, 0.12, 0.05),
        "stab": stab * _env(stab.size, 0.005, 0.15, 0.08),
        "pluckgtr": 0.55 * pluck / np.abs(pluck).max()
        * _env(pluck.size, 0.001, 1.0, 0.05),
    }


def make(seed: int) -> dict:
    """name -> int16 [n, 2] frames, from ``seed``."""
    rng = np.random.default_rng([seed & 0xFFFFFFFF, seed >> 32, 7])
    out = {}
    for name, x in _sounds(rng).items():
        pan = rng.uniform(-0.2, 0.2)
        st = np.stack([x * min(1.0, 1.0 - pan), x * min(1.0, 1.0 + pan)], 1)
        out[name] = np.clip(np.rint(st * 32767.0), -32768, 32767).astype(
            np.int16)
    return out


def write_wav(path: str, frames: np.ndarray) -> None:
    with wave.open(path, "wb") as w:
        w.setnchannels(frames.shape[1])
        w.setsampwidth(2)
        w.setframerate(SR)
        w.writeframes(np.ascontiguousarray(frames, "<i2").tobytes())


def read_wav(path: str) -> np.ndarray:
    """A 16-bit WAV -> int16 [n, channels]."""
    with wave.open(path, "rb") as w:
        if w.getsampwidth() != 2 or w.getframerate() != SR:
            raise ValueError(f"{path}: not 16-bit at {SR} Hz")
        ch = w.getnchannels()
        data = w.readframes(w.getnframes())
    return np.frombuffer(data, "<i2").reshape(-1, ch).astype(np.int16)


def write(kit: dict, outdir: str) -> str:
    """The kit as ``<name>.wav`` files in ``outdir`` -> ``outdir``."""
    os.makedirs(outdir, exist_ok=True)
    for name, frames in kit.items():
        write_wav(os.path.join(outdir, f"{name}.wav"), frames)
    return outdir
