"""The plain reference of a pattern song's mixdown, in NumPy.

It implements the semantics of the trackmixer ``.ini`` song (the schema of
``docs/SONGS.md``) for the parts the benchmark's songs use, from the text
and the instrument WAV files alone:

- ``[song]`` tempo, ticks, swing and pattern list; drum tracks (``x``, ``X``
  1.5, ``o`` 0.5), melodic tracks (note tokens, ``-`` ties, ``.`` rests,
  ``@`` velocities);
- drum hits: the WAV scaled by its gain, rounded, summed as integers;
- ``[synth.NAME]`` tracks as voices: the integer phase accumulator from
  frame 0, the waveform (``sine``, ``square_bl`` with polyBLEP, ``pluck``
  as eight decaying partials), the ADSR envelope from the note's start
  frame, the equal-gain pan law; summed per bus, quantised ``rint(x*32767)``;
- ``[sampler.NAME]`` one-shot tracks: the WAV read at ``(n - start) *
  rate`` with linear interpolation;
- ``[fx.TRACK]`` chains on a synth track's own bus (chorus), the master
  volume curve, the ``[fx]`` master chain (compressor, Freeverb reverb,
  feedback echo, lookahead limiter) over the song padded by the chain's
  tail, with ``fx.*`` automation, and the final peak normalisation.

The formulas are those of the repository's sequential oracles
(``goldref``), with each recurrence evaluated in float64 by a closed form or
block by block rather than a frame at a time; the one-frame house rules
(``rint``, ``floor`` and the float32 products before them) are kept.
``control=True`` rounds every float signal between stages to bfloat16: the
same song computed one precision below the float32 the song states.
"""

from __future__ import annotations

import configparser
import math
import os

import numpy as np
from scipy.signal import lfilter

SR = 44100
F32 = np.float32
MASK = np.uint64(0xFFFFFFFF)
TWO_NEG32 = F32(2.0 ** -32)
NUM_HARMONICS = 8

DRUM_DYNAMICS = {"X": 1.5, "o": 0.5}
_NOTES = {"C": 0, "C#": 1, "DB": 1, "D": 2, "D#": 3, "EB": 3, "E": 4,
          "F": 5, "F#": 6, "GB": 6, "G": 7, "G#": 8, "AB": 8, "A": 9,
          "A#": 10, "BB": 10, "B": 11}

COMB_TUNING = (1116, 1188, 1277, 1356, 1422, 1491, 1557, 1617)
ALLPASS_TUNING = (556, 441, 341, 225)
STEREO_SPREAD = 23
FIXED_GAIN = 0.015
ALLPASS_FEEDBACK = 0.5


def bf16(x: np.ndarray) -> np.ndarray:
    """Round to the nearest bfloat16 (ties to even), returned as float32."""
    u = np.ascontiguousarray(x, np.float32).view(np.uint32).astype(np.uint64)
    u = (u + np.uint64(0x7FFF) + ((u >> np.uint64(16)) & np.uint64(1))) \
        & np.uint64(0xFFFF0000)
    return u.astype(np.uint32).view(np.float32)


class _Prec:
    """The signal precision: float64 (the reference) or bfloat16 (the
    control), applied to every float signal a stage hands on."""

    def __init__(self, control: bool):
        self.control = control

    def __call__(self, x):
        return bf16(x).astype(np.float64) if self.control else x


def note_freq(note: str) -> float:
    n = note.strip().upper()
    idx = 1
    while idx < len(n) and not n[idx].isdigit() and n[idx] != "-":
        idx += 1
    key = (int(n[idx:]) - 4) * 12 + (_NOTES[n[:idx]] - 9) + 49
    return float(2.0 ** ((key - 49) / 12.0) * 440.0)


def phase_increment(freq: float) -> int:
    return int(round(freq / SR * 4294967296.0)) & 0xFFFFFFFF


def noise_u32(idx: np.ndarray, seed: int) -> np.ndarray:
    x = (idx.astype(np.uint64) * np.uint64(0x9E3779B9)
         + np.uint64(seed & 0xFFFFFFFF)) & MASK
    x ^= x >> np.uint64(16)
    x = (x * np.uint64(0x7FEB352D)) & MASK
    x ^= x >> np.uint64(15)
    x = (x * np.uint64(0x846CA68B)) & MASK
    x ^= x >> np.uint64(16)
    return x.astype(np.uint32)


def noise_values(idx: np.ndarray, seed: int) -> np.ndarray:
    return ((noise_u32(idx, seed) >> np.uint32(8)).astype(np.float32)
            * F32(2.0 ** -23) - F32(1.0))


def poly_blep(t: np.ndarray, dt: float) -> np.ndarray:
    dt = F32(max(dt, 1e-9))
    u0 = t / dt
    lo = (u0 + u0) - u0 * u0 - F32(1.0)
    u1 = (t - F32(1.0)) / dt
    hi = u1 * u1 + (u1 + u1) + F32(1.0)
    return np.where(t < dt, lo, np.where(t > F32(1.0) - dt, hi, F32(0.0)))


# ---------------------------------------------------------------------------
# the song text
# ---------------------------------------------------------------------------

class SongText:
    """The parsed song: tempo, patterns, instruments, tracks, chains and
    curves."""

    def __init__(self, text: str, sample_dir: str, read_wav):
        """``read_wav(path) -> int16 [n, channels]`` loads the samples
        (None: the text alone, without the samples' frames)."""

        def load(fn):
            if read_wav is None:
                return None
            return read_wav(os.path.join(sample_dir, fn)).astype(np.int32)

        cp = configparser.ConfigParser(inline_comment_prefixes=(";",))
        cp.read_string(text)
        self.bpm = cp.getint("song", "bpm")
        self.ticks = cp.getint("song", "ticks")
        self.swing = cp.getfloat("song", "swing", fallback=0.0)
        self.sequence = cp.get("song", "patterns").split()
        self.instruments = {
            name: load(fn) for name, fn in (cp.items("instruments")
                             if cp.has_section("instruments") else [])}
        self.synths, self.samplers, self.patterns = {}, {}, {}
        for sec in cp.sections():
            g = cp[sec]
            if sec.startswith("synth."):
                self.synths[sec[6:]] = dict(
                    wave=g.get("wave", "sawtooth_bl"),
                    amplitude=g.getfloat("amplitude", 0.4),
                    attack=g.getfloat("attack", 0.01),
                    decay=g.getfloat("decay", 0.05),
                    sustain_level=g.getfloat("sustain_level", 0.7),
                    release=g.getfloat("release", 0.1),
                    pan=g.getfloat("pan", 0.0),
                    damping=g.getfloat("damping", 1.0),
                    seed=g.getint("seed", 0))
            elif sec.startswith("sampler."):
                self.samplers[sec[8:]] = dict(
                    frames=load(g["file"]),
                    base=note_freq(g.get("base_note", "C4")))
        for sec in cp.sections():
            if sec.startswith("pattern."):
                self.patterns[sec[8:]] = {
                    inst: (" ".join(p.split()) if self.melodic(inst)
                           else p.replace(" ", ""))
                    for inst, p in cp.items(sec)}
        self.fx = self._chain(cp.items("fx")) if cp.has_section("fx") else []
        self.track_fx = {sec[3:]: self._chain(cp.items(sec))
                         for sec in cp.sections() if sec.startswith("fx.")}
        self.automation = {}
        if cp.has_section("automation"):
            for key, val in cp.items("automation"):
                self.automation[key] = [
                    (float(t), float(v)) for t, v in
                    (tok.split(":", 1) for tok in val.split())]

    def _chain(self, items):
        out = []
        for name, val in items:
            p = {}
            for tok in val.split():
                k, v = tok.split("=", 1)
                p[k] = float(v)
            if name == "echo" and "beats" in p:
                p["delay"] = p.pop("beats") * 60.0 / self.bpm
            out.append((name, p))
        return out

    def melodic(self, inst: str) -> bool:
        return inst in self.synths or inst in self.samplers

    @property
    def tick_seconds(self) -> float:
        return 60.0 / self.bpm / self.ticks

    def tick_pos(self, tick: int) -> float:
        return tick + self.swing * 0.5 if self.swing and tick % 2 else \
            float(tick)

    def pattern_ticks(self, pat: dict) -> int:
        return max(len(p.split()) if self.melodic(i) else len(p)
                   for i, p in pat.items())

    def curve_at(self, key: str, tick: float):
        pts = self.automation.get(key)
        if not pts:
            return None
        return float(np.interp(tick, [t for t, _ in pts],
                               [v for _, v in pts]))

    def hit_gain(self, inst: str, tick: float) -> np.ndarray:
        vel = self.curve_at(f"track.{inst}.volume", tick)
        vel = 1.0 if vel is None else vel
        pan = self.curve_at(f"track.{inst}.pan", tick)
        if pan is None:
            return np.full(2, vel, np.float32)
        return np.asarray([vel * min(1.0, 1.0 - pan),
                           vel * min(1.0, 1.0 + pan)], np.float32)

    def events(self):
        """(pattern start tick, pattern) for each pattern played."""
        bar = 0
        for name in self.sequence:
            pat = self.patterns[name]
            yield bar, pat
            bar += self.pattern_ticks(pat)


def notes(patstr: str):
    """(tick, token, held ticks) of a melodic track."""
    toks = patstr.split()
    t = 0
    while t < len(toks):
        tok = toks[t]
        if tok == "-" or set(tok) <= {"."}:
            t += 1
            continue
        held = 1
        while t + held < len(toks) and toks[t + held] == "-":
            held += 1
        yield t, tok, held
        t += held


def split_token(tok: str):
    if "@" in tok:
        n, _, v = tok.partition("@")
        return n, float(v)
    return tok, 1.0


# ---------------------------------------------------------------------------
# the schedule
# ---------------------------------------------------------------------------

def drum_hits(song: SongText):
    """[(instrument, start frame, gains [2] f32)] of every drum hit."""
    tickf = song.tick_seconds * SR
    hits = []
    for bar, pat in song.events():
        for inst, p in pat.items():
            if song.melodic(inst):
                continue
            for t, ch in enumerate(p):
                if ch in ". ":
                    continue
                dyn = np.float32(DRUM_DYNAMICS.get(ch, 1.0))
                hits.append((inst, int(song.tick_pos(bar + t) * tickf),
                             dyn * song.hit_gain(inst, bar + t)))
    return hits


def synth_voices(song: SongText):
    """Every synth note as a voice dict (with its track)."""
    tick = song.tick_seconds
    out = []
    for bar, pat in song.events():
        for inst, p in pat.items():
            if inst not in song.synths:
                continue
            sd = song.synths[inst]
            for t, tok, held in notes(p):
                note, vel = split_token(tok)
                gain = song.curve_at(f"track.{inst}.volume", bar + t)
                pan = song.curve_at(f"track.{inst}.pan", bar + t)
                out.append(dict(
                    sd, track=inst, frequency=note_freq(note),
                    amplitude=sd["amplitude"] * vel
                    * (1.0 if gain is None else gain),
                    pan=sd["pan"] if pan is None else pan,
                    start=song.tick_pos(bar + t) * tick,
                    duration=held * tick))
    return out


def sampler_notes(song: SongText):
    """[(sampler, start frame, rate f32, gains [2] f32)]."""
    tickf = song.tick_seconds * SR
    out = []
    for bar, pat in song.events():
        for inst, p in pat.items():
            if inst not in song.samplers:
                continue
            sd = song.samplers[inst]
            for t, tok, _ in notes(p):
                note, vel = split_token(tok)
                out.append((inst, int(song.tick_pos(bar + t) * tickf),
                            np.float32(note_freq(note) / sd["base"]),
                            np.float32(vel) * song.hit_gain(inst, bar + t)))
    return out


def envelope_times(v):
    """(start frame, attack, decay, sustain, sustain level, release, end
    seconds after the start)."""
    gate = int(v["duration"] * SR) / SR
    a, d, r = v["attack"], v["decay"], v["release"]
    sus = max(gate - a - d, 0.0)
    return int(v["start"] * SR), a, d, sus, v["sustain_level"], r, \
        a + d + sus + r


def synth_end_frame(voices) -> int:
    return max((int((v["start"] + v["attack"] + v["decay"]
                     + max(v["duration"] - v["attack"] - v["decay"], 0.0)
                     + v["release"]) * SR) + 1 for v in voices), default=0)


# ---------------------------------------------------------------------------
# voices
# ---------------------------------------------------------------------------

def _wave(v, p: np.ndarray, nrel: np.ndarray) -> np.ndarray:
    """The waveform at u32 phases ``p`` (f32), ``nrel`` frames after the
    voice's start."""
    x = p.astype(np.float32) * TWO_NEG32
    w = v["wave"]
    if w == "sine":
        return np.sin(F32(2.0 * math.pi) * x).astype(np.float32)
    if w == "square_bl":
        dt = v["frequency"] / SR
        naive = np.where(p < np.uint32(1 << 31), F32(1.0), F32(-1.0))
        x2 = np.where(x < F32(0.5), x + F32(0.5), x - F32(0.5))
        return (naive + poly_blep(x, dt) - poly_blep(x2, dt)).astype(
            np.float32)
    if w == "pluck":
        inc = phase_increment(v["frequency"])
        ratio = np.float32(np.float32(inc) * TWO_NEG32)
        active = [k for k in range(1, NUM_HARMONICS + 1)
                  if inc and k * inc < 2 ** 31]
        u = noise_values(np.asarray(active or [1], np.uint32), v["seed"])
        denom = np.float32(max(np.abs(u.astype(np.float64)).sum(), 1e-30))
        nr = np.maximum(nrel, 0).astype(np.float32)
        acc = np.zeros(p.shape, np.float32)
        for j, k in enumerate(active):
            a = np.float32(u[j] / denom)
            phi = noise_u32(np.asarray([NUM_HARMONICS + k], np.uint32),
                            v["seed"])[0]
            g = np.float32(np.cos(np.float32(np.pi) * np.float32(k) * ratio))
            alpha = np.float32(np.float32(v["damping"]) * ratio
                               * np.log(max(g, np.float32(1e-30))))
            pk = ((p.astype(np.uint64) * np.uint64(k) + np.uint64(phi))
                  & MASK).astype(np.uint32)
            acc = acc + a * np.exp(nr * alpha) * np.sin(
                F32(2.0 * math.pi) * (pk.astype(np.float32) * TWO_NEG32))
        return acc.astype(np.float32)
    raise ValueError(f"waveform {w!r} is not in the reference")


def render_voices(voices, total: int, prec: _Prec) -> np.ndarray:
    """Voices -> float64 stereo [total, 2], each over its audible frames."""
    out = np.zeros((total, 2))
    for v in voices:
        s0, a, d, sus, sl, r, end = envelope_times(v)
        n1 = min(total, s0 + int(math.ceil(end * SR)) + 1)
        if n1 <= s0:
            continue
        n = np.arange(s0, n1, dtype=np.int64)
        inc = phase_increment(v["frequency"])
        p = ((n.astype(np.uint64) * np.uint64(inc)) & MASK).astype(np.uint32)
        t = (n - s0).astype(np.float32) / F32(SR)
        a32, d32, s32, r32 = F32(a), F32(d), F32(sus), F32(r)
        t2, t3, t4 = a32 + d32, a32 + d32 + s32, a32 + d32 + s32 + r32
        g = np.where(t < a32, t / max(a32, F32(1e-30)),
            np.where(t < t2, F32(1.0) + (F32(sl) - F32(1.0)) * (t - a32)
                     / max(d32, F32(1e-30)),
            np.where(t < t3, F32(sl),
            np.where(t < t4, F32(sl) * (t4 - t) / max(r32, F32(1e-30)),
                     F32(0.0)))))
        g = np.maximum(g, 0.0)
        tt = (n - s0) / SR
        mono = prec(np.float64(v["amplitude"]) * _wave(v, p, n - s0)
                    * g * ((tt >= 0) & (tt < end)))
        out[s0:n1, 0] += mono * min(1.0, 1.0 - v["pan"])
        out[s0:n1, 1] += mono * min(1.0, 1.0 + v["pan"])
    return prec(out)


def quantize(x: np.ndarray) -> np.ndarray:
    return np.rint(x * 32767.0).astype(np.int64)


def to16(x: np.ndarray) -> np.ndarray:
    return np.clip(x, -32768, 32767).astype(np.int64)


# ---------------------------------------------------------------------------
# effects
# ---------------------------------------------------------------------------

def _decaying_max(a: np.ndarray, decay: float) -> np.ndarray:
    """e_n = max(a_n, e_{n-1} * decay), e_{-1} = 0, for a >= 0."""
    if decay <= 0.0:
        return a.copy()
    ld = math.log(decay)
    k = np.arange(a.shape[0], dtype=np.float64)
    with np.errstate(divide="ignore"):
        la = np.log(a)
    return np.exp(np.maximum.accumulate(la - k * ld) + k * ld)


def _one_pole(x: np.ndarray, alpha: float, y0: float) -> np.ndarray:
    """y_n = y_{n-1} + alpha * (x_n - y_{n-1}), y_{-1} = y0."""
    return lfilter([alpha], [1.0, -(1.0 - alpha)], x,
                   zi=[(1.0 - alpha) * y0])[0]


def compress(x16: np.ndarray, prec: _Prec, threshold_db=-20.0, ratio=4.0,
             attack=0.005, release=0.1, makeup_db=0.0) -> np.ndarray:
    alpha = 1.0 if attack <= 0 else 1.0 - math.exp(-1.0 / (attack * SR))
    decay = 0.0 if release <= 0 else math.exp(-1.0 / (release * SR))
    slope = 1.0 - 1.0 / ratio
    a = np.max(np.abs(x16 / 32767.0), axis=1)
    e = _decaying_max(a, decay)
    level = 20.0 * np.log10(np.maximum(e, 1e-10))
    g = np.exp2(np.minimum(0.0, (threshold_db - level) * slope) / 6.0206)
    y = prec(_one_pole(g, alpha, 1.0))
    makeup = float(np.exp2(np.float32(makeup_db) / np.float32(6.0206)))
    gain = (y * makeup).astype(np.float32)
    return to16(np.floor(x16.astype(np.float32) * gain[:, None]))


def _comb(x: np.ndarray, D: int, fb, damp: float) -> np.ndarray:
    """Freeverb's damped comb: y_n = w_{n-D}; fs_n = y_n (1-damp) +
    fs_{n-1} damp; w_n = x_n + fs_n fb (zero state), block by block."""
    n = x.shape[0]
    y = np.zeros(n)
    w = np.zeros(n)
    fs = 0.0
    for b0 in range(0, n, D):
        b1 = min(n, b0 + D)
        if b0 >= D:
            y[b0:b1] = w[b0 - D:b1 - D]
        f, zf = lfilter([1.0 - damp], [1.0, -damp], y[b0:b1],
                        zi=[damp * fs])
        fs = f[-1]
        w[b0:b1] = x[b0:b1] + f * fb
    return y


def _allpass(x: np.ndarray, D: int, g: float) -> np.ndarray:
    """b_n = v_{n-D}; out_n = b_n - x_n; v_n = x_n + b_n g."""
    n = x.shape[0]
    v = np.zeros(n)
    out = np.empty(n)
    for b0 in range(0, n, D):
        b1 = min(n, b0 + D)
        b = v[b0 - D:b1 - D] if b0 >= D else np.zeros(b1 - b0)
        out[b0:b1] = b - x[b0:b1]
        v[b0:b1] = x[b0:b1] + b * g
    return out


def reverb(x16: np.ndarray, prec: _Prec, wet_n: np.ndarray, roomsize=0.7,
           damping=0.5, dry=0.7, width=1.0) -> np.ndarray:
    s = x16 / 32767.0
    mono = prec(np.sum(s, axis=1) * FIXED_GAIN)
    fb, damp = 0.7 + 0.28 * roomsize, 0.4 * damping
    revs = []
    for ch in range(2):
        combs = [max(2, int(round(d + STEREO_SPREAD * ch)))
                 for d in COMB_TUNING]
        aps = [max(2, int(round(d + STEREO_SPREAD * ch)))
               for d in ALLPASS_TUNING]
        out = prec(sum(_comb(mono, D, fb, damp) for D in combs))
        for D in aps:
            out = prec(_allpass(out, D, ALLPASS_FEEDBACK))
        revs.append(out)
    w1 = wet_n * (width / 2.0 + 0.5)
    w2 = wet_n * (1.0 - width) / 2.0
    out = np.stack([dry * s[:, 0] + w1 * revs[0] + w2 * revs[1],
                    dry * s[:, 1] + w1 * revs[1] + w2 * revs[0]], axis=1)
    return to16(quantize(prec(out)))


def echo(x16: np.ndarray, prec: _Prec, wet_n: np.ndarray, delay: float,
         feedback=0.4, dry=1.0) -> np.ndarray:
    D = max(1, int(delay * SR))
    s = x16 / 32767.0
    n = s.shape[0]
    d = np.zeros_like(s)
    for b0 in range(0, n, D):
        b1 = min(n, b0 + D)
        prev = d[b0 - D:b1 - D] if b0 >= D else 0.0
        d[b0:b1] = s[b0:b1] + feedback * prev
    e = np.zeros_like(s)
    e[D:] = d[:-D]
    return to16(quantize(prec(dry * s + wet_n[:, None] * prec(e))))


def echo_tail_frames(delay: float, feedback: float, wet: float) -> int:
    D = max(1, int(delay * SR))
    w = max(abs(wet), 1e-9)
    fb = min(abs(feedback), 0.98)
    if w * 32768.0 <= 1.0:
        return 0
    k = 1 if fb <= 1e-9 else 1 + int(math.ceil(
        math.log(1.0 / (w * 32768.0)) / math.log(fb)))
    return min(k * D, 10 * SR)


def limiter(x16: np.ndarray, prec: _Prec, ceiling_db=-1.0, release=0.05,
            lookahead=0.005) -> np.ndarray:
    """The lookahead limiter, withholding its L lookahead frames: the
    result is L frames shorter."""
    L = max(1, int(lookahead * SR))
    decay = 0.0 if release <= 0 else math.exp(-1.0 / (release * SR))
    n = x16.shape[0]
    a = np.max(np.abs(x16 / 32767.0), axis=1)
    need = np.maximum(0.0, 20.0 * np.log10(np.maximum(a, 1e-10))
                      - ceiling_db)
    w = _window_max(need, L)
    R = _decaying_max(w, decay)
    g = np.exp2(-R / 6.0206)
    c = np.concatenate([np.zeros(1), np.cumsum(np.concatenate(
        [np.ones(L), g]))])
    gs = prec((c[L + 1:L + 1 + n] - c[:n]) / (L + 1))
    y = to16(np.floor(x16.astype(np.float32) * gs.astype(np.float32)[:, None]))
    cl = int(np.rint(np.exp2(np.float32(ceiling_db) * np.float32(1 / 6.0206))
                     .astype(np.float64) * 32767))
    return np.clip(y, -cl, cl)[:n - L]


def _window_max(need: np.ndarray, L: int) -> np.ndarray:
    """w_n = max(need_n .. need_{n+L}), need past the end 0."""
    padded = np.concatenate([need, np.zeros(L)])
    return np.max(np.lib.stride_tricks.sliding_window_view(padded, L + 1),
                  axis=1)[:need.shape[0]]


def chorus(x16: np.ndarray, prec: _Prec, rate=0.5, depth=0.002, delay=0.02,
           voices=3, wet=0.4, dry=1.0) -> np.ndarray:
    n = x16.shape[0]
    s = x16 / 32767.0
    out = dry * s
    wv = wet / int(voices)
    idx = np.arange(n, dtype=np.int64)
    inc = int(round(rate / SR * 4294967296.0)) & 0xFFFFFFFF
    for ch in range(2):
        for v in range(int(voices)):
            phi = (v / int(voices) + 0.25 * ch) % 1.0
            p0 = int(round(phi * 4294967296.0)) & 0xFFFFFFFF
            p = (np.uint64(p0) + idx.astype(np.uint64) * np.uint64(inc)) \
                & MASK
            x = p.astype(np.float32) * TWO_NEG32
            lfo = F32(0.5) + F32(0.5) * np.sin(
                2.0 * np.pi * x.astype(np.float64)).astype(np.float32)
            d = (F32(delay) + F32(depth) * lfo) * F32(SR)
            df = np.floor(d)
            fr = (d - df).astype(np.float64)
            i0 = idx - df.astype(np.int64)
            x0 = np.where(i0 - 1 >= 0, s[np.clip(i0 - 1, 0, n - 1), ch], 0.0)
            x1 = np.where(i0 >= 0, s[np.clip(i0, 0, n - 1), ch], 0.0)
            out[:, ch] += wv * (x0 * fr + x1 * (1.0 - fr))
    return to16(quantize(prec(out)))


def run_chain(x16: np.ndarray, chain, song: SongText, prec: _Prec,
              automation_prefix: str = "fx.") -> np.ndarray:
    tickf = song.tick_seconds * SR
    t = np.arange(x16.shape[0]) / tickf

    def curve(key, default):
        pts = song.automation.get(automation_prefix + key)
        if pts is None:
            return np.full(x16.shape[0], default)
        return np.interp(t, [a for a, _ in pts], [b for _, b in pts])

    for name, p in chain:
        p = dict(p)
        if name == "compress":
            x16 = compress(x16, prec, **p)
        elif name == "reverb":
            p.pop("tail", None)
            wet = curve("reverb.wet", p.pop("wet", 0.33))
            x16 = reverb(x16, prec, wet, **p)
        elif name == "echo":
            p.pop("tail", None)
            wet = curve("echo.wet", p.pop("wet", 0.5))
            x16 = echo(x16, prec, wet, **p)
        elif name == "limiter":
            x16 = limiter(x16, prec, **p)
        elif name == "chorus":
            x16 = chorus(x16, prec, **p)
        else:
            raise ValueError(f"effect {name!r} is not in the reference")
    return x16


def chain_tail(chain) -> int:
    total = 0
    for name, p in chain:
        if name == "reverb":
            total += int(p.get("tail", 1.5) * SR)
        elif name == "echo":
            total += echo_tail_frames(p["delay"], p.get("feedback", 0.4),
                                      p.get("wet", 0.5))
    return total


def chain_flush(chain) -> int:
    return sum(max(1, int(p.get("lookahead", 0.005) * SR))
               for name, p in chain if name == "limiter")


# ---------------------------------------------------------------------------
# the mixdown
# ---------------------------------------------------------------------------

def mix(song: SongText, normalize: bool = True, tail_seconds: float = 0.3,
        control: bool = False) -> np.ndarray:
    """The song -> int16 [n, 2]: ``Song.mix(normalize, tail_seconds)``."""
    prec = _Prec(control)
    hits = drum_hits(song)
    voices = synth_voices(song)
    pitched = sampler_notes(song)
    sched_end = max((s + len(song.instruments[i]) for i, s, _ in hits),
                    default=0)
    pitched_end = max((s + int(np.floor((len(song.samplers[i]["frames"]) - 1)
                                        / max(float(r), 1e-9))) + 2
                       for i, s, r, _ in pitched), default=0)
    track_tail = max((chain_tail(song.track_fx[t]) for t in
                      {v["track"] for v in voices} if t in song.track_fx),
                     default=0)
    frames = max(sched_end, synth_end_frame(voices), pitched_end) \
        + track_tail
    total = frames + int(tail_seconds * SR)
    out = np.zeros((total, 2), np.int64)
    for inst, s, g in hits:
        w = song.instruments[inst][:max(0, total - s)]
        out[s:s + len(w)] += np.rint(w.astype(np.float32) * g).astype(
            np.int64)
    for inst, s, rate, g in pitched:
        w = song.samplers[inst]["frames"]
        last = len(w) - 1
        nr = np.arange(0, total - s, dtype=np.int64)
        pos = nr.astype(np.float32) * rate
        keep = pos <= F32(last)
        nr, pos = nr[keep], pos[keep]
        i = np.minimum(np.maximum(pos.astype(np.int64), 0), max(last - 1, 0))
        frac = (pos - i.astype(np.float32))[:, None]
        v0 = w[i].astype(np.float32)
        v1 = w[np.minimum(i + 1, last)].astype(np.float32)
        val = v0 + (v1 - v0) * frac
        out[s + nr] += np.rint(val * g).astype(np.int64)
    buses = {}
    for v in voices:
        buses.setdefault(v["track"] if v["track"] in song.track_fx
                         else None, []).append(v)
    for track, vs in buses.items():
        q = quantize(render_voices(vs, total, prec))
        if track is not None:
            q = run_chain(to16(q), song.track_fx[track], song, prec,
                          f"fx.{track}.")
        out += q
    out16 = to16(out)
    mv = song.automation.get("master.volume")
    if mv:
        t = np.arange(total) / (song.tick_seconds * SR)
        g = prec(np.interp(t, [a for a, _ in mv], [b for _, b in mv]))
        out16 = to16(np.rint(out16 * g.astype(np.float32)[:, None]))
    if song.fx:
        pad = chain_tail(song.fx) + chain_flush(song.fx)
        out16 = np.concatenate([out16, np.zeros((pad, 2), np.int64)])
        out16 = run_chain(out16, song.fx, song, prec)
    if normalize:
        peak = int(np.max(np.abs(out16))) if out16.size else 0
        if peak:
            f = np.float32(32767) / np.float32(peak)
            out16 = to16(np.floor(out16.astype(np.float32) * f))
    return out16.astype(np.int16)
