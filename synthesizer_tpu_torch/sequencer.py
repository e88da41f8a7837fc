"""Pattern sequencer: ``.ini`` song model -> batched device mixdown (port
of ``synthesizer_tpu.sequencer``).

Song files use the reference's schema (``docs/SONGS.md``): ``[song]`` (bpm,
ticks, swing, patterns), ``[paths]``, ``[instruments]`` (drum samples),
``[synth.NAME]`` (melodic voice-bank tracks), ``[sampler.NAME]`` (pitched,
optionally looped sample playback), ``[pattern.NAME]``, ``[fx]`` (the master
chain), ``[fx.TRACK]`` (per-track chains) and ``[automation]`` (tick:value
breakpoint curves).

How a song renders here, on the song's device (the card unless the caller
passes ``device="cpu"``):

* **drum hits**: every hit is a row of a gather from the padded instrument
  bank, velocity-scaled (f32 product, rounded), and one ``index_add_``
  places all rows into a widened int32 buffer, in memory-bounded batches
  (``_SCATTER_BATCH_ELEMS``).  Integer adds are exact in any order, so the
  result does not depend on the order the card adds in;
* **pitched samplers**: per-chunk rows of notes read their WAV at
  pos = (n - start) * rate with f32 linear interpolation (rate 1.0 is a
  bit-exact passthrough); looped notes read a 32-bit DDS phase over the
  loop, held as int64 masked to 32 bits.  The whole-song pass is a Python
  loop over chunks of the same stateless body as the streaming path, so
  both are bit-identical;
* **synth tracks**: all notes compile to one voice bank, rendered by the
  Hopper kernel on the card (``VoiceBank.render_song``); synth tracks with
  an ``[fx.TRACK]`` chain render as one grouped bank with a stereo bus per
  fx'd track (``VoiceBank.render_song_grouped``, the kernel's segment
  buses), and each bus runs its chain before it joins the mix;
* **master**: ``master.volume`` automation (``ops.wave.interp`` at absolute
  frames), then the ``[fx]`` chain (``effects.py``), then normalization.

``mix_generator`` streams fixed-size chunks from the same schedule
(bit-identical to ``mix(normalize=False)`` without fx, within the chain's
budgets with fx) and seeks with ``start_frame``.  The reference's device
functions (``_mixdown_kernel``, ``_pitched_chunk_body``, the chunk
programs) are XLA code, not Pallas kernels; they are plain PyTorch here.

With ``mesh=`` (a ``parallel.mesh.VoiceMesh``) ``mix`` and
``mix_generator`` run data-parallel over the mesh's devices: the main drum
hits and the pitched-sampler rows shard over the mesh with an exact int32
merge, and the synth voices (grouped into their track buses when
``[fx.TRACK]`` chains exist) shard over the same axis with the f32
partials added in shard order (within 1 LSB of the single-device mix).
The drum fx buses and the sidechain keys render unsharded, as in the
reference.
"""

from __future__ import annotations

import configparser
import dataclasses
import os
from typing import Dict, Iterator, List, Optional, Sequence, Tuple

import numpy as np
import torch

from . import params
from .models.voicebank import Voice, VoiceBank, pack_voices
from .ops.wave import U32, div, f32_to_i32, interp
from .sample import Sample
from .synth import note_freq
from .utils import profiling
from .utils.device import resolve

__all__ = ["Song", "HitSchedule", "SynthDef", "SamplerDef"]

#: every automatable EFFECT.KNOB -- valid as fx.EFFECT.KNOB on the master
#: [fx] chain AND as fx.TRACK.EFFECT.KNOB on a per-track chain
_FX_AUTO_SUBKEYS = frozenset((
    "filter.cutoff", "reverb.wet", "reverb.dry", "reverb.roomsize",
    "chorus.wet", "chorus.dry", "chorus.rate", "chorus.depth",
    "compress.makeup_db", "compress.threshold_db", "compress.ratio",
    "compress.attack", "compress.release", "compress.knee_db",
    "gate.threshold_db",
    "eq.low_db", "eq.mid_db", "eq.high_db",
    "echo.feedback", "echo.wet", "echo.dry",
    "width.amount", "limiter.ceiling_db", "limiter.release",
    "phaser.wet", "phaser.dry", "phaser.rate", "phaser.depth",
    "tremolo.rate", "tremolo.depth", "autopan.rate", "autopan.depth",
))


@dataclasses.dataclass
class SamplerDef:
    """A pitched sampler instrument (the [sampler.NAME] ini section):
    a note token plays the WAV resampled by note_freq(note) /
    note_freq(base_note), polyphonic.  Without a loop the full sample plays
    out; with ``loop_start < loop_end`` (seconds in the source) the note
    sustains by cycling the loop while held (its tie length gates it), then
    fades linearly over ``release`` seconds."""
    sample: Sample
    base_freq: float = 261.6255653005986      # C4
    loop_start: float = -1.0                  # seconds; <0 = no loop
    loop_end: float = -1.0
    release: float = 0.01                     # post-gate fade (looped)

    @property
    def looped(self) -> bool:
        return 0.0 <= self.loop_start < self.loop_end


@dataclasses.dataclass
class SynthDef:
    """A synth instrument definition (the [synth.NAME] ini section)."""
    wave: str = "sawtooth_bl"
    amplitude: float = 0.4
    attack: float = 0.01
    decay: float = 0.05
    sustain_level: float = 0.7
    release: float = 0.1
    pan: float = 0.0
    fm_frequency: float = 0.0
    fm_depth: float = 0.0
    pulse_width: float = 0.5
    harmonics: tuple = ()
    table: tuple = ()            # wave="wavetable": one cycle of samples
    damping: float = 1.0         # wave="pluck": loop-loss exponent scale
    seed: int = 0                # wave="pluck"/"white_noise" excitation
    glide: float = 0.0           # portamento seconds: each note slides
    #                              from the track's PREVIOUS note's pitch


class HitSchedule:
    """A flat schedule of (instrument index, start frame) hits plus the
    padded instrument bank, on the host (numpy)."""

    def __init__(self, bank: np.ndarray, lengths: np.ndarray,
                 instruments: Sequence[str], hits: np.ndarray,
                 samplerate: int, nchannels: int,
                 gains: Optional[np.ndarray] = None):
        self.bank = bank              # [S, Lmax, C] int32 (unscaled values)
        self.lengths = lengths        # [S] valid frames per instrument
        self.instruments = list(instruments)
        self.hits = hits              # [H, 2] (instrument_idx, start_frame)
        self.samplerate = samplerate
        self.nchannels = nchannels
        #: per-hit per-channel gains [H, C] f32 (track volume/pan
        #: automation); 1.0 reproduces the pure-integer path bit for bit
        #: (bank values are int16-scale, exact in f32)
        self.gains = (np.ones((len(hits), nchannels), np.float32)
                      if gains is None else np.asarray(gains, np.float32))

    @property
    def total_frames(self) -> int:
        if len(self.hits) == 0:
            return 0
        ends = self.hits[:, 1] + self.lengths[self.hits[:, 0]]
        return int(ends.max())


#: cap on the materialized [batch, Lmax, C] gather per scatter step:
#: ~32 M elements (128 MB of int32) whatever the song's length
_SCATTER_BATCH_ELEMS = 32 * 1024 * 1024


def _t(a, device, dtype=None) -> torch.Tensor:
    """A host array as a tensor on ``device``."""
    t = torch.from_numpy(np.ascontiguousarray(a))
    return t.to(device=device, dtype=dtype) if dtype else t.to(device)


def _sum_rows(vals: torch.Tensor) -> torch.Tensor:
    """Sum int32 rows [K, n, C] -> [n, C] with int32 wrap-around (summed in
    int64, then wrapped: the same value in any order)."""
    return vals.sum(dim=0, dtype=torch.int64).to(torch.int32)


def _scale_hits(vals: torch.Tensor, gains: torch.Tensor) -> torch.Tensor:
    """Velocity-scale gathered int32 hit waveforms: f32 product, rounded
    half to even.  Bank values are int16-scale (exact in f32), so a gain
    of 1.0 is the identity and the no-automation path stays exact."""
    return torch.round(vals.to(torch.float32) * gains).to(torch.int32)


def _mixdown_kernel(bank: torch.Tensor, hits_inst: torch.Tensor,
                    hits_start: torch.Tensor, total: int,
                    hits_gain: Optional[torch.Tensor] = None) -> torch.Tensor:
    """All hits -> one int32 [total, C] song buffer on bank's device.

    bank: [S, Lmax, C] int32; hits: [H].  Each batch of hits gathers its
    [batch, Lmax, C] waveforms, velocity-scales them by ``hits_gain``
    (None == all ones == the exact integer path) and adds them at their
    frames with one ``index_add_``; frames past ``total`` go to a spare
    row that is cut off.  Batches of at most ``_SCATTER_BATCH_ELEMS``
    elements bound the memory; integer adds make the result independent of
    the batching and of the card's order."""
    dev = bank.device
    H = int(hits_inst.shape[0])
    Lmax, C = int(bank.shape[1]), int(bank.shape[2])
    if hits_gain is None:
        hits_gain = torch.ones((H, C), dtype=torch.float32, device=dev)
    out = torch.zeros((total + 1, C), dtype=torch.int32, device=dev)
    arange_l = torch.arange(Lmax, dtype=torch.int64, device=dev)[None, :]
    batch = max(1, min(H, _SCATTER_BATCH_ELEMS // max(Lmax * C, 1)))
    for b0 in range(0, H, batch):
        ib = hits_inst[b0:b0 + batch].to(torch.int64)
        vals = _scale_hits(bank[ib], hits_gain[b0:b0 + batch, None, :])
        idx = (hits_start[b0:b0 + batch].to(torch.int64)[:, None]
               + arange_l).clamp_(max=total)
        out.index_add_(0, idx.reshape(-1), vals.reshape(-1, C))
    return out[:total]


def _stream_chunk(bank: torch.Tensor, inst_k, start_k, valid_k, gain_k,
                  c0: int, cf: int) -> torch.Tensor:
    """One streaming chunk of drum hits: rows [K] of (instrument, start,
    valid, gains) -> int32 [cf, C] at absolute frames [c0, c0 + cf)."""
    lmax = int(bank.shape[1])
    pos = (c0 + torch.arange(cf, dtype=torch.int64, device=bank.device)
           )[None, :] - start_k.to(torch.int64)[:, None]
    inrange = (pos >= 0) & (pos < lmax) & valid_k[:, None]
    vals = bank[inst_k.to(torch.int64)[:, None], pos.clamp(0, lmax - 1)]
    vals = _scale_hits(vals, gain_k[:, None, :])
    vals = torch.where(inrange[:, :, None], vals, torch.zeros_like(vals))
    return _sum_rows(vals)


def _pitched_chunk_body(bank, lens, idx_k, start_k, rate_k, gain_k, valid_k,
                        loopf_k, loopu_k, c0: int, cf: int) -> torch.Tensor:
    """One chunk of pitched-sampler playback -> int32 [cf, C]: each row
    reads its WAV at pos = (n - start) * rate with f32 linear interpolation
    (n relative to the note start), velocity/pan gains per channel, rows
    summed in int32.  Stateless in the absolute frame, so streaming ==
    offline.

    Looped rows (loopf = (flag, ls, lp, gate_total, fade_r); loopu = (inc,
    p0) as u32 in int64): past the loop end the read position comes from
    a 32-bit DDS phase over the loop, pos = ls + x(p0 + n_rel*inc) * lp,
    and a linear release fade gates the note after its tie length,
    g = clip((gate_total - n_rel) * fade_r, 0, 1).  bank is pair-packed
    [P, Lmax, 2C]: position i holds (wav[i], wav[i+1])."""
    dev = bank.device
    C = bank.shape[2] // 2
    n_rel = (c0 + torch.arange(cf, dtype=torch.int64, device=dev)
             )[None, :] - start_k.to(torch.int64)[:, None]
    n_rel_f = n_rel.to(torch.float32)
    pos = n_rel_f * rate_k[:, None]                            # [K, cf]
    lens_k = lens[idx_k.to(torch.int64)].to(torch.int64)
    last = (lens_k - 1).to(torch.float32)[:, None]
    flag = loopf_k[:, 0:1] > 0
    ls = loopf_k[:, 1:2]
    lp = loopf_k[:, 2:3]
    gate_total = loopf_k[:, 3:4]
    fade_r = loopf_k[:, 4:5]
    phase = (loopu_k[:, 1:2] + (n_rel & U32) * loopu_k[:, 0:1]) & U32
    pos_loop = ls + phase.to(torch.float32) * float(2.0 ** -32) * lp
    use_loop = flag & (pos > ls + lp)
    pos = torch.where(use_loop, pos_loop, pos)
    # a loop region ending at the sample's last frame sweeps pos through
    # (len-1, len): clamp to the final frame instead of extrapolating
    pos = torch.where(flag, torch.minimum(pos, last), pos)
    one = torch.ones((), dtype=torch.float32, device=dev)
    env = torch.where(flag, torch.clamp((gate_total - n_rel_f) * fade_r,
                                        0.0, 1.0), one)
    inr = (n_rel >= 0) & valid_k[:, None] & torch.where(
        flag, n_rel_f < gate_total, pos <= last)
    hi = torch.clamp_min(lens_k - 2, 0)[:, None]
    i = torch.minimum(torch.clamp_min(f32_to_i32(pos), 0), hi)
    frac = pos - i.to(torch.float32)
    v01 = bank[idx_k.to(torch.int64)[:, None], i].to(torch.float32)
    v0 = v01[..., :C]
    v1 = v01[..., C:]
    vals = v0 + (v1 - v0) * frac[:, :, None]
    vals = torch.round(vals * (gain_k[:, None, :] * env[:, :, None])
                       ).to(torch.int32)
    vals = torch.where(inr[:, :, None], vals, torch.zeros_like(vals))
    return _sum_rows(vals)


def _master_volume(x16: torch.Tensor, xs, vs, n0: int,
                   tickf: float) -> torch.Tensor:
    """Continuous master-volume automation: a per-frame gain from the
    breakpoint curve (``interp`` over ticks, ends held) on the
    int16-saturated mix.  Stateless in the absolute frame, so offline and
    streaming slices are bit-identical."""
    n = (n0 + torch.arange(x16.shape[0], dtype=torch.int64,
                           device=x16.device)).to(torch.float32)
    g = interp(div(n, tickf), xs, vs)
    return torch.clamp(torch.round(x16.to(torch.float32) * g[:, None]),
                       -32768, 32767).to(torch.int16)


def _quantize(stereo: torch.Tensor) -> torch.Tensor:
    """A synth mix or bus (f32 in [-1, 1]) -> int32 rint(x * 32767)."""
    return torch.round(stereo * float(np.float32(32767.0))).to(torch.int32)


def _to16(acc32: torch.Tensor) -> torch.Tensor:
    return torch.clamp(acc32, -32768, 32767).to(torch.int16)


def _finish_chunk(acc32: torch.Tensor, synth_stereo) -> torch.Tensor:
    if synth_stereo is not None:
        acc32 = acc32 + _quantize(synth_stereo)
    return _to16(acc32)


class Song:
    """Sample-based pattern song (the trackmixer model), rendered on
    ``device`` (the card unless the caller passes ``device="cpu"``)."""

    def __init__(self, device="cuda"):
        self.device = resolve(device)
        self.bpm = 128
        self.ticks = 4
        #: shuffle feel ([song] swing, 0..0.95): every odd tick is delayed
        #: by swing * half a tick, applied at schedule compile (_tick_pos),
        #: so drums, synth notes and sampler notes swing together
        self.swing = 0.0
        self.pattern_sequence: List[str] = []
        self.patterns: Dict[str, Dict[str, str]] = {}
        self.instruments: Dict[str, Sample] = {}
        self.synths: Dict[str, SynthDef] = {}
        self.samplers: Dict[str, SamplerDef] = {}
        self.samplerate = params.norm_samplerate
        self.nchannels = params.norm_nchannels
        #: master-bus effects ([fx]), applied in order to the final mix
        self.fx: List[Tuple[str, dict]] = []
        self.fx_irs: Dict[str, Sample] = {}      # convolve IRs by filename
        #: per-synth-track chains ([fx.SYNTHNAME]): the track's own stereo
        #: bus (a segment of the grouped bank) runs the chain before it
        #: joins the int32 mix
        self.synth_fx: Dict[str, List[Tuple[str, dict]]] = {}
        #: per-sampler-track chains: the track's pitched mix renders as its
        #: own int16 bus and runs the chain
        self.sampler_fx: Dict[str, List[Tuple[str, dict]]] = {}
        #: drum chains that need a timeline (sidechain compression, knob
        #: automation): the instrument's own hits render as a bus and the
        #: chain runs at mix time instead of baking into the banked WAV
        self.drum_fx_bus: Dict[str, List[Tuple[str, dict]]] = {}
        #: drum chains baked into the banked WAV at add_track_fx time
        self._baked_fx: set = set()
        #: tracks whose [fx.NAME] knobs are automated (pre-scanned from
        #: [automation] in a song file): their drum chains route to a bus
        self._auto_fx_tracks: set = set()
        #: automation curves ([automation]): (tick, value) breakpoint
        #: lists, linearly interpolated, ends held
        self.automation: Dict[str, List[Tuple[float, float]]] = {}

    # -- loading ----------------------------------------------------------

    @classmethod
    def from_ini(cls, ini_file: str, sample_dir: Optional[str] = None,
                 device="cuda") -> "Song":
        song = cls(device=device)
        song.read(ini_file, sample_dir)
        return song

    def read(self, ini_file: str, sample_dir: Optional[str] = None) -> None:
        # ';' only: '#' appears in note names (C#4)
        cp = configparser.ConfigParser(inline_comment_prefixes=(";",))
        with open(ini_file) as f:
            cp.read_file(f)
        base = sample_dir
        if base is None:
            base = cp.get("paths", "samples", fallback="")
            if not os.path.isabs(base):
                base = os.path.join(os.path.dirname(os.path.abspath(ini_file)),
                                    base)
        self._read_cp(cp, base)

    @classmethod
    def from_string(cls, ini_text: str, sample_dir: str = "",
                    device="cuda") -> "Song":
        """Build a Song directly from ini text (no temp file).

        Instrument WAVs resolve under ``sample_dir`` only; any ``[paths]``
        section in the text is ignored (callers that accept untrusted song
        text must control the sample root)."""
        song = cls(device=device)
        cp = configparser.ConfigParser(inline_comment_prefixes=(";",))
        cp.read_string(ini_text)
        song._read_cp(cp, sample_dir)
        return song

    def _load(self, path: str, name: str) -> Sample:
        return Sample(wave_file=path, name=name, device=self.device)

    def _read_cp(self, cp: configparser.ConfigParser, base: str) -> None:
        self.bpm = cp.getint("song", "bpm")
        self.ticks = cp.getint("song", "ticks")
        if self.bpm <= 0 or self.ticks <= 0:
            raise ValueError(f"bpm and ticks must be positive "
                             f"(got bpm={self.bpm}, ticks={self.ticks})")
        self.swing = cp.getfloat("song", "swing", fallback=0.0)
        if not 0.0 <= self.swing <= 0.95:
            raise ValueError(f"swing must be in [0, 0.95] "
                             f"(got {self.swing})")
        self.pattern_sequence = cp.get("song", "patterns").split()
        for name, filename in (cp.items("instruments")
                               if cp.has_section("instruments") else []):
            smp = self._load(os.path.join(base, filename), name)
            smp.normalize()
            self._check_format(name, smp)
            self.instruments[name] = smp
            self.samplerate = smp.samplerate
            self.nchannels = smp.nchannels
        self._read_sections(cp, base)

    def _read_sections(self, cp: configparser.ConfigParser,
                       base: str = "") -> None:
        for section in cp.sections():
            if section.startswith("synth."):
                name = section[len("synth."):]
                g = cp[section]
                self.synths[name] = SynthDef(
                    wave=g.get("wave", "sawtooth_bl"),
                    amplitude=g.getfloat("amplitude", 0.4),
                    attack=g.getfloat("attack", 0.01),
                    decay=g.getfloat("decay", 0.05),
                    sustain_level=g.getfloat("sustain_level", 0.7),
                    release=g.getfloat("release", 0.1),
                    pan=g.getfloat("pan", 0.0),
                    fm_frequency=g.getfloat("fm_frequency", 0.0),
                    fm_depth=g.getfloat("fm_depth", 0.0),
                    pulse_width=g.getfloat("pulse_width", 0.5),
                    harmonics=tuple(float(x) for x in
                                    g.get("harmonics", "").split()),
                    table=tuple(float(x) for x in g.get("table", "").split()),
                    damping=g.getfloat("damping", 1.0),
                    seed=g.getint("seed", 0),
                    glide=g.getfloat("glide", 0.0),
                )
        for section in cp.sections():
            if section.startswith("sampler."):
                name = section[len("sampler."):]
                g = cp[section]
                smp = self._load(os.path.join(base, g["file"]), name)
                self.add_sampler(name, smp, g.get("base_note", "C4"),
                                 loop_start=g.getfloat("loop_start", -1.0),
                                 loop_end=g.getfloat("loop_end", -1.0),
                                 release=g.getfloat("release", 0.01))
        for section in cp.sections():
            if section.startswith("pattern."):
                pname = section[len("pattern."):]
                self.add_pattern(pname, dict(cp.items(section)))
        if cp.has_section("fx"):
            from .effects import parse_fx_items
            self.fx = parse_fx_items(cp.items("fx"))
            for name, p in self.fx:
                if name == "convolve":
                    self._load_fx_ir(p["ir"], base)
                self._resolve_fx_tempo(name, p)
        if cp.has_section("automation"):
            # pre-scan before [fx.X]: a drum chain whose knobs will be
            # automated needs the bus route, not the baked WAV
            for key in cp.options("automation"):
                parts = key.split(".")
                if len(parts) == 4 and parts[0] == "fx":
                    self._auto_fx_tracks.add(parts[1])
        for section in cp.sections():
            if section.startswith("fx."):
                inst = section[len("fx."):]
                self.add_track_fx(inst, cp.items(section), base)
        if cp.has_section("automation"):
            for key, value in cp.items("automation"):
                self.add_automation(key, value)

    def _load_fx_ir(self, filename: str, base: str) -> None:
        """Load a convolution impulse response, converted to the song's
        rate (mono IRs stay mono: they apply to every channel)."""
        ir = self._load(os.path.join(base, filename), filename)
        self.fx_irs[filename] = self._prep_fx_ir(ir)

    def _prep_fx_ir(self, ir: Sample) -> Sample:
        ir = self._on_device(ir)
        ir.resample(self.samplerate)
        if ir.nchannels == 2 and self.nchannels == 1:
            ir.mono()
        return ir

    def _on_device(self, sample: Sample) -> Sample:
        """A copy of ``sample`` on the song's device (the frames are
        shared when it is there already: no op writes into them)."""
        return Sample.from_torch(sample.torch_frames.to(self.device),
                                 sample.samplerate, sample.samplewidth,
                                 sample.name)

    def _resolve_fx_tempo(self, name: str, p: dict) -> None:
        """Resolve tempo-synced knobs against the song's bpm: ``echo
        beats=`` becomes ``delay=`` seconds (beats are quarter notes), and
        ``chorus``/``phaser``/``tremolo``/``autopan`` ``rate_beats=`` (LFO
        period in beats) becomes ``rate=`` Hz."""
        if name == "echo" and "beats" in p:
            p["delay"] = float(p.pop("beats")) * 60.0 / float(self.bpm)
        if name in ("chorus", "phaser", "tremolo", "autopan") \
                and "rate_beats" in p:
            b = float(p.pop("rate_beats"))
            if b <= 0:
                raise ValueError(f"[fx] {name}: rate_beats must be > 0")
            p["rate"] = float(self.bpm) / (60.0 * b)

    def add_track_fx(self, instrument: str, items, base: str = "",
                     bus: bool = False) -> None:
        """Per-track effects ([fx.NAME] ini sections).

        A sample instrument's chain is applied to its sample once at load,
        so that it reaches the offline scatter and the streaming path
        through the hit bank.  A synth or sampler track's chain is stored
        and processes the track's own bus at mix time.  ``bus=True`` forces
        a drum instrument's chain onto a mix-time bus (needed when its
        knobs will be automated programmatically)."""
        from .effects import HOLDBACK_FX, apply_fx_sample, parse_fx_items
        if (instrument not in self.instruments
                and instrument not in self.synths
                and instrument not in self.samplers):
            raise ValueError(f"[fx.{instrument}]: unknown instrument "
                             f"{instrument!r} (define it in [instruments], "
                             f"[synth.{instrument}], or "
                             f"[sampler.{instrument}] first)")
        fx = parse_fx_items(list(items))
        irs = {}
        for name, p in fx:
            if name in HOLDBACK_FX:
                raise ValueError(
                    f"[fx.{instrument}]: {name} is master-chain only (its "
                    f"lookahead holdback cannot ride a fixed-size track "
                    f"bus — put it in [fx])")
            if name == "convolve":
                self._load_fx_ir(p["ir"], base)
                irs[p["ir"]] = self.fx_irs[p["ir"]]
            self._resolve_fx_tempo(name, p)
        if instrument in self.synths:
            self.synth_fx[instrument] = fx
        elif instrument in self.samplers:
            self.sampler_fx[instrument] = fx
        elif (bus or any(n == "compress" and p.get("sidechain")
                         for n, p in fx)
              or instrument in self._auto_fx_tracks):
            # a timeline-dependent chain cannot bake into the WAV: the
            # instrument's hits get their own bus at mix time
            self.drum_fx_bus[instrument] = fx
        else:
            apply_fx_sample(self.instruments[instrument], fx, irs)
            self._baked_fx.add(instrument)

    def add_automation(self, key: str, points) -> None:
        """Attach an automation curve (the [automation] ini section).

        ``key`` is ``master.volume``, ``track.NAME.volume``,
        ``track.NAME.pan``, ``fx.EFFECT.KNOB`` or ``fx.TRACK.EFFECT.KNOB``;
        ``points`` is ``[(tick, value), ...]`` or the ini string form
        ``"0:1.0 16:0.5 32:1.0"``.  Ticks must be strictly ascending."""
        if isinstance(points, str):
            parsed = []
            for tok in points.split():
                if ":" not in tok:
                    raise ValueError(f"automation {key}: breakpoint {tok!r} "
                                     f"is not tick:value")
                t, v = tok.split(":", 1)
                parsed.append((float(t), float(v)))
            points = parsed
        pts = [(float(t), float(v)) for t, v in points]
        if not pts:
            raise ValueError(f"automation {key}: empty curve")
        for (t0, _), (t1, _) in zip(pts, pts[1:]):
            if t1 <= t0:
                raise ValueError(f"automation {key}: ticks must be strictly "
                                 f"ascending (got {t0} then {t1})")
        parts = key.split(".")
        subkey = None
        if parts[0] == "fx" and len(parts) == 3 \
                and ".".join(parts[1:]) in _FX_AUTO_SUBKEYS:
            subkey = ".".join(parts[1:])
        elif parts[0] == "fx" and len(parts) == 4 \
                and ".".join(parts[2:]) in _FX_AUTO_SUBKEYS:
            subkey = ".".join(parts[2:])
        neg_ok = (key.endswith(".pan") or key.endswith(".makeup_db")
                  or key.endswith(".threshold_db")
                  or key.endswith(".ceiling_db")
                  or (subkey is not None and subkey.startswith("eq.")))
        for t, v in pts:
            if (not (np.isfinite(t) and np.isfinite(v))
                    or (v < 0 and not neg_ok)):
                raise ValueError(f"automation {key}: bad breakpoint "
                                 f"({t}, {v})")
        if key == "master.volume":
            pass
        elif subkey is not None and len(parts) == 3:
            self._check_fx_automation(key, subkey, self.fx, "[fx]", pts)
        elif subkey is not None:
            tname = parts[1]
            if tname in self.synth_fx:
                chain = self.synth_fx[tname]
            elif tname in self.sampler_fx:
                chain = self.sampler_fx[tname]
            elif tname in self.drum_fx_bus:
                chain = self.drum_fx_bus[tname]
            elif tname in self._baked_fx:
                raise ValueError(
                    f"automation {key}: the [fx.{tname}] chain was baked "
                    f"into the instrument sample at load (no timeline to "
                    f"automate against) — in a song file this routes to a "
                    f"bus automatically (the [automation] section is "
                    f"pre-scanned); programmatically pass bus=True to "
                    f"add_track_fx")
            else:
                raise ValueError(f"automation {key}: no [fx.{tname}] "
                                 f"chain (add it first)")
            self._check_fx_automation(key, subkey, chain,
                                      f"[fx.{tname}]", pts)
        elif (len(parts) == 3 and parts[0] == "track"
              and parts[2] in ("volume", "pan")):
            name = parts[1]
            if (name not in self.instruments and name not in self.synths
                    and name not in self.samplers):
                raise ValueError(f"automation {key}: unknown track "
                                 f"{name!r}")
            if parts[2] == "pan":
                if self.nchannels != 2:
                    raise ValueError(f"automation {key}: pan automation "
                                     f"needs a stereo song")
                for t, v in pts:
                    if not -1.0 <= v <= 1.0:
                        raise ValueError(f"automation {key}: pan values "
                                         f"must be in [-1, 1] (got {v})")
        else:
            raise ValueError(f"automation key {key!r} not understood "
                             f"(master.volume, track.NAME.volume, "
                             f"track.NAME.pan, fx.filter.cutoff, "
                             f"fx.reverb.wet/.dry/.roomsize, "
                             f"fx.chorus.wet/.dry/.rate/.depth, "
                             f"fx.compress.makeup_db/.threshold_db/"
                             f".ratio/.attack/.release, "
                             f"fx.gate.threshold_db, "
                             f"fx.eq.low_db/.mid_db/.high_db, "
                             f"fx.echo.feedback/.wet/.dry, "
                             f"fx.width.amount, "
                             f"fx.limiter.ceiling_db/.release, "
                             f"fx.phaser.wet/.dry/.rate/.depth, or any "
                             f"of those fx knobs track-scoped as "
                             f"fx.TRACK.EFFECT.KNOB)")
        self.automation[key] = pts

    def _check_fx_automation(self, key: str, subkey: str, chain,
                             where: str, pts) -> None:
        """Validate an EFFECT.KNOB curve against a chain: the effect must
        appear exactly once, and knob values must lie in its range."""
        target = subkey.split(".")[0]
        nfx = sum(1 for n, _ in chain if n == target)
        if nfx == 0:
            raise ValueError(f"automation {key}: the {where} chain has "
                             f"no {target} entry (add it first)")
        if nfx > 1:
            raise ValueError(f"automation {key}: the {where} chain has "
                             f"several {target} entries — only one "
                             f"can be automated")
        ranges = {
            "reverb.roomsize": (0.0, 1.0, "roomsize", "[0, 1]"),
            "echo.feedback": (0.0, 0.95, "feedback", "[0, 0.95]"),
            "width.amount": (0.0, 4.0, "width amount", "[0, 4]"),
            "limiter.ceiling_db": (-60.0, 0.0, "ceiling", "[-60, 0] dB"),
            "phaser.depth": (0.0, 1.0, "depth", "[0, 1]"),
            "tremolo.depth": (0.0, 1.0, "depth", "[0, 1]"),
            "autopan.depth": (0.0, 1.0, "depth", "[0, 1]"),
        }
        open_ranges = {
            "limiter.release": (0.0, 5.0, "release", "(0, 5] s"),
            "phaser.rate": (0.0, 20.0, "rate", "(0, 20] Hz"),
            "tremolo.rate": (0.0, 20.0, "rate", "(0, 20] Hz"),
            "autopan.rate": (0.0, 20.0, "rate", "(0, 20] Hz"),
            # strictly positive: the soft-knee form divides by the width
            "compress.knee_db": (0.0, 24.0, "knee", "(0, 24] dB"),
        }
        if subkey in ranges:
            lo, hi, what, rng = ranges[subkey]
            for t, v in pts:
                if not lo <= v <= hi:
                    raise ValueError(f"automation {key}: {what} must be "
                                     f"in {rng} (got {v})")
        if subkey in open_ranges:
            lo, hi, what, rng = open_ranges[subkey]
            for t, v in pts:
                if not lo < v <= hi:
                    raise ValueError(f"automation {key}: {what} must be "
                                     f"in {rng} (got {v})")

    def _fx_tickf(self) -> float:
        return self.tick_duration * self.samplerate

    def _track_fx_automation(self, name: str):
        """The track's fx.NAME.EFFECT.KNOB curves with the track prefix
        stripped to the master form (fx.EFFECT.KNOB), or None."""
        pre = f"fx.{name}."
        out = {}
        for k, pts in self.automation.items():
            parts = k.split(".")
            if len(parts) == 4 and k.startswith(pre):
                out[f"fx.{parts[2]}.{parts[3]}"] = pts
        return out or None

    def _curve_at(self, key: str, tick: float):
        pts = self.automation.get(key)
        if not pts:
            return None
        return float(np.interp(tick, [t for t, _ in pts],
                               [v for _, v in pts]))

    def _track_gain_at(self, name: str, tick: float) -> float:
        g = self._curve_at(f"track.{name}.volume", tick)
        return 1.0 if g is None else g

    def _track_pan_at(self, name: str, tick: float):
        """Pan-automation value at a tick, or None when not automated."""
        return self._curve_at(f"track.{name}.pan", tick)

    def _hit_gain_at(self, name: str, tick: float) -> np.ndarray:
        """Per-channel gain for one hit: velocity times the equal-gain pan
        law (lg = min(1, 1-p), rg = min(1, 1+p), the voice bank's law)."""
        vel = self._track_gain_at(name, tick)
        pan = self._track_pan_at(name, tick)
        if pan is None or self.nchannels == 1:
            return np.full(self.nchannels, vel, np.float32)
        return np.asarray([vel * min(1.0, 1.0 - pan),
                           vel * min(1.0, 1.0 + pan)], np.float32)

    @profiling.spanned("sequencer.volume")
    def _apply_master_volume(self, x16: torch.Tensor,
                             n0: int) -> torch.Tensor:
        pts = self.automation["master.volume"]
        return _master_volume(x16, [t for t, _ in pts], [v for _, v in pts],
                              int(n0), self.tick_duration * self.samplerate)

    def add_fx(self, name: str, ir: Optional[Sample] = None,
               **fx_params) -> None:
        """Append a master-bus effect programmatically (the [fx] section's
        validation; ``ir`` supplies the convolve impulse)."""
        from .effects import validate_fx_params
        prm = dict(fx_params)
        if name == "convolve":
            if ir is None:
                raise ValueError("convolve needs an ir Sample")
            key = f"__ir{len(self.fx_irs)}__"
            self.fx_irs[key] = self._prep_fx_ir(ir)
            prm["ir"] = key
        prm = validate_fx_params(name, prm)
        self._resolve_fx_tempo(name, prm)
        self.fx.append((name, prm))

    def _check_format(self, name: str, sample: Sample) -> None:
        """All instruments and samplers must agree on rate and channels."""
        if not self.instruments and not self.samplers:
            return
        if (sample.samplerate != self.samplerate
                or sample.nchannels != self.nchannels):
            raise ValueError(
                f"instrument {name!r} is {sample.samplerate} Hz/"
                f"{sample.nchannels}ch but the song's instruments are "
                f"{self.samplerate} Hz/{self.nchannels}ch — convert with "
                f"resample()/stereo() first")

    def add_instrument(self, name: str, sample: Sample) -> None:
        sample = self._on_device(sample).normalize()
        self._check_format(name, sample)
        self.instruments[name] = sample
        self.samplerate = sample.samplerate
        self.nchannels = sample.nchannels

    def add_synth(self, name: str, synthdef: SynthDef) -> None:
        if name in self.samplers:
            raise ValueError(f"synth {name!r}: a sampler with that name "
                             f"already exists (one instrument per track "
                             f"name)")
        self.synths[name] = synthdef

    def add_sampler(self, name: str, sample: Sample,
                    base_note: str = "C4", loop_start: float = -1.0,
                    loop_end: float = -1.0,
                    release: float = 0.01) -> None:
        """Register a pitched sampler instrument: ``sample`` plays at
        note_freq(note)/note_freq(base_note) for each note token of the
        track (normalized like a drum instrument; it must match the song's
        rate and channels).  ``loop_start``/``loop_end`` (seconds) define an
        optional sustain loop (see SamplerDef)."""
        if name in self.synths:
            raise ValueError(f"sampler {name!r}: a synth with that name "
                             f"already exists (one instrument per track "
                             f"name)")
        sample = self._on_device(sample).normalize()
        self._check_format(name, sample)
        sd = SamplerDef(sample, note_freq(base_note), loop_start, loop_end,
                        release)
        if (loop_start >= 0.0 or loop_end >= 0.0) and not sd.looped:
            raise ValueError(
                f"sampler {name!r}: loop region [{loop_start}, "
                f"{loop_end}]s is inverted or incomplete (need "
                f"0 <= loop_start < loop_end)")
        if sd.looped:
            n = sample.nframes
            le = int(sd.loop_end * sample.samplerate)
            ls = int(sd.loop_start * sample.samplerate)
            if le > n or le - ls < 2:
                raise ValueError(
                    f"sampler {name!r}: loop region [{sd.loop_start}, "
                    f"{sd.loop_end}]s is outside the sample or too short")
        self.samplers[name] = sd
        self.samplerate = sample.samplerate
        self.nchannels = sample.nchannels

    def add_pattern(self, name: str, tracks: Dict[str, str]) -> None:
        """Drum tracks are contiguous x/. strings (spaces cosmetic); synth
        and sampler tracks are whitespace-separated note tokens."""
        out = {}
        for inst, pat in tracks.items():
            if inst in self.synths or inst in self.samplers:
                out[inst] = " ".join(pat.split())
            else:
                out[inst] = pat.replace(" ", "")
        self.patterns[name] = out

    # -- schedule compilation ----------------------------------------------

    @property
    def tick_duration(self) -> float:
        return 60.0 / self.bpm / self.ticks

    #: drum-pattern dynamics characters (tracker-style accents); any other
    #: non-rest character is a normal 1.0 hit
    DRUM_DYNAMICS = {"X": 1.5, "o": 0.5}

    @staticmethod
    def _split_note_token(tok: str):
        """'C4' -> ('C4', 1.0); 'C4@0.5' -> ('C4', 0.5) (inline per-note
        velocity, multiplying any track volume curve)."""
        if "@" in tok:
            note, _, v = tok.partition("@")
            try:
                vel = float(v)
            except ValueError:
                raise ValueError(f"bad note velocity in token {tok!r}")
            if not 0.0 <= vel:
                raise ValueError(f"negative velocity in token {tok!r}")
            return note, vel
        return tok, 1.0

    def _tick_pos(self, tick_idx: int) -> float:
        """Grid tick index -> (possibly swung) tick position."""
        if self.swing and tick_idx % 2:
            return tick_idx + self.swing * 0.5
        return float(tick_idx)

    def pattern_ticks(self, pattern: Dict[str, str]) -> int:
        n = 0
        for inst, p in pattern.items():
            n = max(n, len(p.split())
                    if (inst in self.synths or inst in self.samplers)
                    else len(p))
        return n

    @staticmethod
    def _notes(patstr: str):
        """(tick, token, held ticks) of each note of a melodic track: a
        note token starts at its tick, following '-' tokens tie it, '.'
        tokens are rests."""
        tokens = patstr.split()
        t = 0
        while t < len(tokens):
            tok = tokens[t]
            if tok == "-" or set(tok) <= {"."}:
                t += 1
                continue
            held = 1
            while t + held < len(tokens) and tokens[t + held] == "-":
                held += 1
            yield t, tok, held
            t += held

    @staticmethod
    def _bank_of(arrays: Sequence[np.ndarray], nchannels: int):
        """Pad [len, C] int32 arrays into (bank [S, Lmax, C], lengths [S])."""
        lmax = max((len(a) for a in arrays), default=1)
        bank = np.zeros((max(len(arrays), 1), lmax, nchannels), np.int32)
        lengths = np.zeros(max(len(arrays), 1), np.int64)
        for i, a in enumerate(arrays):
            bank[i, :len(a)] = a
            lengths[i] = len(a)
        return bank, lengths

    def compile_schedule(self) -> HitSchedule:
        """Song -> flat hit schedule + padded instrument bank (host)."""
        names = sorted(self.instruments)
        index = {n: i for i, n in enumerate(names)}
        bank, lengths = self._bank_of(
            [self.instruments[n].get_frame_array().astype(np.int32)
             for n in names], self.nchannels)
        C = self.nchannels
        hits: List[Tuple[int, int]] = []
        gains: List[np.ndarray] = []
        tickf = self.tick_duration * self.samplerate
        bar_start_ticks = 0
        for pname in self.pattern_sequence:
            pattern = self.patterns[pname]
            nticks = self.pattern_ticks(pattern)
            for inst, patstr in pattern.items():
                if inst in self.synths or inst in self.samplers:
                    continue
                if inst not in index:
                    raise KeyError(f"pattern {pname} uses unknown instrument "
                                   f"{inst}")
                for t, ch in enumerate(patstr):
                    if ch not in ". ":
                        start = int(self._tick_pos(bar_start_ticks + t)
                                    * tickf)
                        hits.append((index[inst], start))
                        dyn = np.float32(self.DRUM_DYNAMICS.get(ch, 1.0))
                        gains.append(dyn * self._hit_gain_at(
                            inst, bar_start_ticks + t))
            bar_start_ticks += nticks
        hits_arr = np.asarray(hits, np.int64).reshape(-1, 2)
        return HitSchedule(bank, lengths, names, hits_arr, self.samplerate,
                           C, gains=np.asarray(gains, np.float32)
                           .reshape(-1, C))

    def compile_synth_voices(self, return_tracks: bool = False):
        """All melodic notes of the song -> one flat Voice list (and, with
        ``return_tracks``, the synth-track name of each voice).

        Portamento (``glide =``): every note after a track's first slides
        from the previous note's pitch over the configured seconds (the
        bank renders it as an exact integer-DDS chirp)."""
        voices: List[Voice] = []
        tracks: List[str] = []
        last_freq: Dict[str, float] = {}
        tick = self.tick_duration
        bar_start = 0
        for pname in self.pattern_sequence:
            pattern = self.patterns[pname]
            nticks = self.pattern_ticks(pattern)
            for inst, patstr in pattern.items():
                if inst not in self.synths:
                    continue
                sd = self.synths[inst]
                for t, tok, held in self._notes(patstr):
                    tracks.append(inst)
                    note_pan = self._track_pan_at(inst, bar_start + t)
                    note, vel = self._split_note_token(tok)
                    freq = note_freq(note)
                    prev = last_freq.get(inst)
                    glide_from = (prev if sd.glide > 0.0 and prev is not None
                                  and prev != freq else 0.0)
                    last_freq[inst] = freq
                    voices.append(Voice(
                        wave=sd.wave,
                        frequency=freq,
                        amplitude=sd.amplitude * vel
                        * self._track_gain_at(inst, bar_start + t),
                        pan=sd.pan if note_pan is None else note_pan,
                        start=self._tick_pos(bar_start + t) * tick,
                        duration=held * tick,
                        attack=sd.attack, decay=sd.decay,
                        sustain_level=sd.sustain_level, release=sd.release,
                        fm_frequency=sd.fm_frequency, fm_depth=sd.fm_depth,
                        pulse_width=sd.pulse_width,
                        harmonics=sd.harmonics,
                        table=sd.table,
                        damping=sd.damping,
                        seed=sd.seed,
                        glide_from=glide_from,
                        glide_time=sd.glide if glide_from else 0.0,
                    ))
            bar_start += nticks
        if return_tracks:
            return voices, tracks
        return voices

    def compile_pitched_hits(self):
        """All sampler-track notes -> flat pitched-hit arrays plus the
        padded sampler bank (host): (bank [P, Lmax, 2C] int32 pair-packed,
        lens [P] int64, idx [N] int32, start [N] int64, rate [N] f32,
        gains [N, C] f32, loopf [N, 5] f32, loopu [N, 2] u32).

        rate = note_freq(note)/base_freq.  For a looped sampler a note's
        ties set its gate length; loopf rows are (flag, loop_start,
        loop_len, gate_total, 1/fade) in source/output frames and loopu
        rows the loop-phase DDS (increment, initial phase).  One-shot
        samplers ignore ties (the whole sample plays out)."""
        names = sorted(self.samplers)
        index = {n: i for i, n in enumerate(names)}
        bank, lens = self._bank_of(
            [self.samplers[n].sample.get_frame_array().astype(np.int32)
             for n in names], self.nchannels)
        C = self.nchannels
        # pair-pack: position i holds (wav[i], wav[i+1]), so that the
        # interpolation reads one row
        bank = np.concatenate(
            [bank, np.concatenate([bank[:, 1:], bank[:, -1:]], axis=1)],
            axis=2)
        idx: List[int] = []
        starts: List[int] = []
        rates: List[float] = []
        gains: List[np.ndarray] = []
        loopf: List[tuple] = []
        loopu: List[tuple] = []
        ptracks: List[str] = []
        tickf = self.tick_duration * self.samplerate
        sr = self.samplerate
        bar_start = 0
        for pname in self.pattern_sequence:
            pattern = self.patterns[pname]
            nticks = self.pattern_ticks(pattern)
            for inst, patstr in pattern.items():
                if inst not in self.samplers or inst in self.synths:
                    continue
                sd = self.samplers[inst]
                for t, tok, held in self._notes(patstr):
                    note, vel = self._split_note_token(tok)
                    rate = note_freq(note) / sd.base_freq
                    ptracks.append(inst)
                    idx.append(index[inst])
                    starts.append(int(self._tick_pos(bar_start + t) * tickf))
                    rates.append(rate)
                    gains.append(np.float32(vel)
                                 * self._hit_gain_at(inst, bar_start + t))
                    if sd.looped:
                        ls = float(int(sd.loop_start * sr))
                        le = float(int(sd.loop_end * sr))
                        lp = le - ls
                        fade = max(1, int(sd.release * sr))
                        gate_total = held * tickf + fade
                        inc = int(round(rate / lp * 4294967296.0)) \
                            & 0xFFFFFFFF
                        p0 = int(round(((-ls / lp) % 1.0)
                                       * 4294967296.0)) & 0xFFFFFFFF
                        loopf.append((1.0, ls, lp, gate_total, 1.0 / fade))
                        loopu.append((inc, p0))
                    else:
                        loopf.append((0.0, 0.0, 1.0, 0.0, 1.0))
                        loopu.append((0, 0))
            bar_start += nticks
        self._last_pitched_tracks = ptracks   # aligned with the hit rows
        return (bank, lens, np.asarray(idx, np.int32),
                np.asarray(starts, np.int64),
                np.asarray(rates, np.float32),
                np.asarray(gains, np.float32).reshape(-1, C),
                np.asarray(loopf, np.float32).reshape(-1, 5),
                np.asarray(loopu, np.uint32).reshape(-1, 2))

    def _pitched_end_frames(self, lens, idx, starts, rates,
                            loopf=None) -> np.ndarray:
        """Per-hit end frame (exclusive): one-shot hits end when
        n_rel * rate passes len-1, looped hits at gate_total (tie length +
        release fade); +2 frames of slack for the f32 decision."""
        if len(idx) == 0:
            return np.zeros(0, np.int64)
        ends = (starts + np.floor((lens[idx] - 1)
                                  / np.maximum(rates, 1e-9)).astype(np.int64)
                + 2)
        if loopf is not None and len(loopf):
            looped = loopf[:, 0] > 0
            ends = np.where(looped,
                            starts + loopf[:, 3].astype(np.int64) + 2,
                            ends)
        return ends

    @staticmethod
    def _bucket(starts, ends, nchunks: int, cf: int, start_frame: int,
                ndev: int = 0):
        """Per-chunk row indices of hits [start, end) for chunks
        [start_frame + c*cf, ...) -> (per_chunk lists, K >= 1), K padded
        to a multiple of ``ndev`` (a mesh's size) when one is given."""
        first_c = np.maximum(0, (starts - start_frame) // cf)
        last_c = np.minimum(nchunks - 1, (ends - 1 - start_frame) // cf)
        per_chunk: List[List[int]] = [[] for _ in range(nchunks)]
        for h in range(len(starts)):
            for c in range(int(first_c[h]), int(last_c[h]) + 1):
                per_chunk[c].append(h)
        K = max((len(h) for h in per_chunk), default=1) or 1
        if ndev:
            K += -K % ndev
        return per_chunk, K

    def _pitched_rows(self, per_chunk, K, idx, starts, rates, gains,
                      loopf, loopu):
        """Bucketed pitched hits as dense [nchunks, K(, ...)] row tensors on
        the song's device (loopu as int64 u32 values)."""
        nchunks = len(per_chunk)
        C = self.nchannels
        idx_b = np.zeros((nchunks, K), np.int32)
        start_b = np.zeros((nchunks, K), np.int64)
        rate_b = np.ones((nchunks, K), np.float32)
        gain_b = np.zeros((nchunks, K, C), np.float32)
        valid_b = np.zeros((nchunks, K), bool)
        loopf_b = np.zeros((nchunks, K, 5), np.float32)
        loopf_b[:, :, 2] = 1.0
        loopf_b[:, :, 4] = 1.0
        loopu_b = np.zeros((nchunks, K, 2), np.int64)
        for c, hs in enumerate(per_chunk):
            hs = hs[:K]
            if not hs:
                continue
            j = slice(0, len(hs))
            idx_b[c, j] = idx[hs]
            start_b[c, j] = starts[hs]
            rate_b[c, j] = rates[hs]
            gain_b[c, j] = gains[hs]
            loopf_b[c, j] = loopf[hs]
            loopu_b[c, j] = loopu[hs]
            valid_b[c, j] = True
        return tuple(_t(a, self.device) for a in
                     (idx_b, start_b, rate_b, gain_b, valid_b, loopf_b,
                      loopu_b))

    def _pitched_mix(self, bank, lens, idx, starts, rates, gains,
                     loopf, loopu, ends, total: int, cf: int = 32768,
                     mesh=None) -> torch.Tensor:
        """Offline pitched-sampler mixdown -> int32 [total, C]: a loop over
        chunks of the streaming body, rows bucketed per chunk.  With
        ``mesh`` the rows (padded to a multiple of the mesh size) shard
        over its devices and merge exactly in int32."""
        nchunks = -(-total // cf)
        per_chunk, K = self._bucket(starts, ends, nchunks, cf, 0,
                                    mesh.size if mesh is not None else 0)
        rows = self._pitched_rows(per_chunk, K, idx, starts, rates, gains,
                                  loopf, loopu)
        bank_d = _t(bank, self.device)
        lens_d = _t(lens, self.device)
        if mesh is not None:
            from .parallel.mesh import pitched_song_sharded
            out = pitched_song_sharded(bank_d, lens_d, *rows,
                                       range(0, nchunks * cf, cf), cf, mesh)
            return out.to(self.device)[:total]
        out = torch.cat([
            _pitched_chunk_body(bank_d, lens_d, *(r[c] for r in rows),
                                c * cf, cf) for c in range(nchunks)])
        return out[:total]

    def _synth_end_frame(self, voices: Sequence[Voice]) -> int:
        if not voices:
            return 0
        # envelope end = attack + decay + max(gate - attack - decay, 0) +
        # release
        return max(
            int((v.start + v.attack + v.decay
                 + max(v.duration - v.attack - v.decay, 0.0)
                 + v.release) * self.samplerate) + 1
            for v in voices)

    def export_midi(self, bpm: Optional[int] = None) -> bytes:
        """Serialize the song to a format-0 SMF byte string: synth notes on
        one channel per synth track, sampler notes on their own channels
        after those, drum hits on the GM percussion channel 10."""
        import math as _math
        from .midi import MidiNote, write_midi
        notes = []
        synth_channels = {name: i if i < 9 else i + 1
                          for i, name in enumerate(sorted(self.synths))}
        tick = self.tick_duration
        bar_start = 0
        drum_keys = {name: 35 + i for i, name in
                     enumerate(sorted(self.instruments))}
        for pname in self.pattern_sequence:
            pattern = self.patterns[pname]
            nticks = self.pattern_ticks(pattern)
            for inst, patstr in pattern.items():
                if inst in self.synths:
                    continue
                if inst in self.samplers:
                    base = len(self.synths)
                    si = sorted(self.samplers).index(inst) + base
                    chn = si if si < 9 else si + 1
                    sd = self.samplers[inst]
                    for t, tok, held in self._notes(patstr):
                        tok, nv = self._split_note_token(tok)
                        f = note_freq(tok)
                        note = int(round(69 + 12 * _math.log2(f / 440.0)))
                        vel = max(1, min(127, int(round(
                            100 * nv * self._track_gain_at(
                                inst, bar_start + t)))))
                        if sd.looped:
                            dur = held * tick
                        else:
                            dur = ((sd.sample.nframes / self.samplerate)
                                   / max(f / sd.base_freq, 1e-9))
                        notes.append(MidiNote(
                            self._tick_pos(bar_start + t) * tick, dur,
                            max(0, min(127, note)), vel, min(chn, 15)))
                    continue
                for t, ch in enumerate(patstr):
                    if ch not in ". ":
                        dyn = self.DRUM_DYNAMICS.get(ch, 1.0)
                        vel = max(1, min(127, int(round(
                            100 * dyn
                            * self._track_gain_at(inst, bar_start + t)))))
                        notes.append(MidiNote(
                            self._tick_pos(bar_start + t) * tick,
                            tick * 0.9, drum_keys[inst], vel, 9))
            bar_start += nticks
        for v in self.compile_synth_voices():
            note = int(round(69 + 12 * _math.log2(max(v.frequency, 1e-3)
                                                  / 440.0)))
            ch = 0
            for name, c in synth_channels.items():
                if self.synths[name].wave == v.wave:
                    ch = c
                    break
            vel = max(1, min(127, int(round(v.amplitude / 0.4 * 100))))
            notes.append(MidiNote(v.start, v.duration, max(0, min(127, note)),
                                  vel, ch))
        notes.sort(key=lambda n: n.start)
        return write_midi(notes, bpm=bpm or self.bpm)

    # -- per-track buses, sidechains --------------------------------------

    def _check_synth_format(self, voices: Sequence[Voice]) -> None:
        if voices and self.nchannels != 2:
            raise ValueError("synth tracks require a stereo song format")

    def _fx_synth_tracks(self, vtracks: Sequence[str]) -> List[str]:
        """The fx'd synth tracks that sound in this song, in their stable
        (sorted) bus order."""
        present = set(vtracks)
        return [n for n in sorted(self.synth_fx) if n in present]

    def _fx_sampler_tracks(self, ptracks: Sequence[str]) -> List[str]:
        present = set(ptracks)
        return [n for n in sorted(self.sampler_fx) if n in present]

    def _chains_tail(self, chains) -> int:
        from .effects import chain_tail_frames
        return max((chain_tail_frames(fx, self.samplerate, self.fx_irs)
                    for fx in chains), default=0)

    def _sampler_fx_masks(self, ptracks: Sequence[str]):
        """(mask, track-or-None) groups for the pitched paths: one clean
        group for the tracks without fx plus a group per fx'd sampler
        track; shared by mix() and mix_generator()."""
        ptr = np.asarray(ptracks)
        sfx = self._fx_sampler_tracks(ptracks)
        if not sfx:
            return [(np.ones(len(ptr), bool), None)]
        masks = []
        clean = ~np.isin(ptr, sfx)
        if clean.any():
            masks.append((clean, None))
        masks += [(ptr == n, n) for n in sfx]
        return masks

    def _drum_bus_split(self, sched: HitSchedule):
        """(main_mask [H] bool, {name: hit_mask}): hits of drum-bus
        instruments leave the main scatter and render as their own buses."""
        main = np.ones(len(sched.hits), bool)
        buses = {}
        for name in sorted(self.drum_fx_bus):
            if name not in sched.instruments:
                continue
            m = sched.hits[:, 0] == sched.instruments.index(name)
            if m.any():
                buses[name] = m
                main &= ~m
        return main, buses

    def _used_sidechains(self) -> set:
        """Instrument names that ``compress sidechain=`` entries name."""
        names = set()
        for chain in ([self.fx] + list(self.synth_fx.values())
                      + list(self.sampler_fx.values())
                      + list(self.drum_fx_bus.values())):
            for n, p in chain:
                if n == "compress" and p.get("sidechain"):
                    names.add(p["sidechain"])
        return names

    def _sidechain_hit_rows(self, name: str, sched: HitSchedule):
        """(bank tensor, instrument index, starts [H], gains [H, C],
        length) for one instrument's own hits: the ducking key source."""
        if name not in sched.instruments:
            raise ValueError(
                f"compress sidechain={name!r}: unknown sample instrument "
                f"(sidechain keys come from [instruments] tracks)")
        idx = sched.instruments.index(name)
        m = sched.hits[:, 0] == idx
        return (_t(sched.bank, self.device), idx, sched.hits[m, 1],
                sched.gains[m], int(sched.lengths[idx]))

    def _scatter(self, sched: HitSchedule, mask, total: int,
                 bank_d=None, mesh=None) -> torch.Tensor:
        """The hits ``mask`` selects -> int32 [total, C] (sharded over
        ``mesh`` with an exact int32 merge when one is given)."""
        dev = self.device
        if mesh is not None:
            from .parallel.mesh import scatter_mix_sharded
            return scatter_mix_sharded(
                _t(sched.bank, dev) if bank_d is None else bank_d,
                sched.hits[mask, 0], sched.hits[mask, 1], total, mesh,
                hits_gain=sched.gains[mask]).to(dev)
        return _mixdown_kernel(
            _t(sched.bank, dev) if bank_d is None else bank_d,
            _t(sched.hits[mask, 0], dev, torch.int64),
            _t(sched.hits[mask, 1], dev, torch.int64), total,
            _t(sched.gains[mask], dev))

    def _sidechain_key_samples(self, total: int) -> Dict[str, Sample]:
        """Offline key buses: {name: int16 Sample of ``total`` frames} of
        each referenced instrument's own hits (velocity and pan included)."""
        out: Dict[str, Sample] = {}
        names = self._used_sidechains()
        if not names:
            return out
        sched = self.compile_schedule()
        for name in names:
            self._sidechain_hit_rows(name, sched)      # checks the name
            m = sched.hits[:, 0] == sched.instruments.index(name)
            out[name] = Sample.from_torch(
                _to16(self._scatter(sched, m, total)), self.samplerate, 2,
                name=f"key:{name}")
        return out

    def _sidechain_key_fns(self) -> Dict[str, "object"]:
        """Streaming key providers: {name: key_fn(n0, n) -> int16 [n, C]},
        stateless in the absolute frame (seek-exact)."""
        fns: Dict[str, "object"] = {}
        C = self.nchannels
        names = self._used_sidechains()
        if not names:
            return fns
        sched = self.compile_schedule()
        dev = self.device
        for name in names:
            bank, idx, starts, gains, length = \
                self._sidechain_hit_rows(name, sched)
            starts = np.asarray(starts, np.int64)
            gains = np.asarray(gains, np.float32).reshape(-1, C)

            def key_fn(n0, n, idx=idx, starts=starts, gains=gains,
                       length=length, bank=bank):
                with profiling.span("sequencer.sidechain_key"):
                    act = np.nonzero((starts < n0 + n)
                                     & (starts + length > n0))[0]
                    acc = _stream_chunk(
                        bank, _t(np.full(len(act), idx, np.int64), dev),
                        _t(starts[act], dev),
                        torch.ones(len(act), dtype=torch.bool, device=dev),
                        _t(gains[act], dev), int(n0), int(n))
                    return _to16(acc)

            fns[name] = key_fn
        return fns

    def _synth_fx_groups(self, voices: Sequence[Voice],
                         vtracks: Sequence[str], chunk_frames: int):
        """Pack all synth voices into one grouped bank whose buses are:
        bus 0 the shared clean bus (tracks without fx), buses 1..N the
        fx'd tracks in ``_fx_synth_tracks`` order.  One render per chunk
        or song."""
        fx_tracks = self._fx_synth_tracks(vtracks)
        seg_index = {n: i + 1 for i, n in enumerate(fx_tracks)}
        return self._grouped_bank(voices, [seg_index.get(t, 0)
                                           for t in vtracks],
                                  chunk_frames) + (fx_tracks,)

    def _grouped_bank(self, voices, tags, chunk_frames: int):
        vp, layout, seg = pack_voices(voices, self.samplerate,
                                      num_harmonics=8, sort_by_wave=True,
                                      tags=tags, device=self.device)
        bank = VoiceBank.for_voices(voices, self.samplerate,
                                    chunk_frames=chunk_frames,
                                    num_harmonics=8, layout=layout,
                                    nvoices=layout.nvoices,
                                    device=self.device)
        return bank, vp, _t(seg, self.device)

    def _run_track_chain(self, t16: torch.Tensor, fx, name: str, total: int,
                         sidechain_keys) -> torch.Tensor:
        """A track's int16 bus through its chain (already tail-padded to
        the song's length) -> int32 [total, C]."""
        from .effects import run_fx_chain_ops
        ts = Sample.from_torch(t16, self.samplerate, 2, name=f"track:{name}")
        run_fx_chain_ops(ts, fx, self.fx_irs,
                         automation=self._track_fx_automation(name),
                         tickf=self._fx_tickf(), sidechain_keys=sidechain_keys)
        return ts.torch_frames[:total].to(torch.int32)

    def _add_synth_buses(self, out32: torch.Tensor, buses: torch.Tensor,
                         fx_tracks: Sequence[str], total: int,
                         sidechain_keys=None) -> torch.Tensor:
        """Fold a grouped bus stack [total, nseg, 2] into the int32 mix:
        bus 0 (clean) adds directly; each fx'd track's bus quantizes to
        int16 (what a banked sample instrument would be), runs its chain
        over the tail-padded song length and joins the mix."""
        out32 = out32 + _quantize(buses[:, 0])
        for i, tname in enumerate(fx_tracks):
            out32 = out32 + self._run_track_chain(
                _to16(_quantize(buses[:, i + 1])), self.synth_fx[tname],
                tname, total, sidechain_keys)
        return out32

    def _synth_bank(self, voices: Sequence[Voice], chunk_frames: int):
        if self.nchannels != 2:
            raise ValueError("synth tracks require a stereo song format")
        vp, layout = pack_voices(voices, self.samplerate, num_harmonics=8,
                                 sort_by_wave=True, device=self.device)
        bank = VoiceBank.for_voices(voices, self.samplerate,
                                    chunk_frames=chunk_frames,
                                    num_harmonics=8, layout=layout,
                                    nvoices=layout.nvoices,
                                    device=self.device)
        return bank, vp

    @profiling.spanned("sequencer.compile")
    def _compile(self):
        """The one schedule compile every path shares -> (sched, voices,
        vtracks, pitched arrays (8), pitched end frames, song frames
        without any tail seconds: content + the longest track chain's
        tail)."""
        sched = self.compile_schedule()
        voices, vtracks = self.compile_synth_voices(return_tracks=True)
        self._check_synth_format(voices)
        pitched = self.compile_pitched_hits()
        _, plens, pidx, pstart, prate, _, ploopf, _ = pitched
        pends = self._pitched_end_frames(plens, pidx, pstart, prate, ploopf)
        pitched_end = int(pends.max()) if len(pends) else 0
        ptracks = self._last_pitched_tracks
        tail = max(
            self._chains_tail(self.synth_fx[n]
                              for n in self._fx_synth_tracks(vtracks)),
            self._chains_tail(self.sampler_fx[n]
                              for n in self._fx_sampler_tracks(ptracks)),
            self._chains_tail(self.drum_fx_bus.values()))
        frames = max(sched.total_frames, self._synth_end_frame(voices),
                     pitched_end) + tail
        return sched, voices, vtracks, pitched, pends, frames

    def duration_frames(self, tail_seconds: float = 0.0) -> int:
        """Total frames of song content (schedule end + the track chains'
        tails + ``tail_seconds``).  With the default 0 this is where
        ``mix_generator`` ends, so it bounds ``start_frame`` for seeking;
        ``mix()`` adds its own ``tail_seconds`` (0.3 s by default)."""
        return self._compile()[5] + int(tail_seconds * self.samplerate)

    # -- offline mixdown ----------------------------------------------------

    @profiling.spanned("sequencer.mix")
    def mix(self, normalize: bool = True, tail_seconds: float = 0.3,
            mesh=None, max_frames: Optional[int] = None) -> Sample:
        """Offline song mixdown on the song's device -> an int16 Sample.

        Sums all tracks in a widened int32 buffer, then narrows: with
        ``normalize`` the peak is amplified to full scale first (make_16bit
        semantics), otherwise values saturate at int16.  With a master
        chain or master volume the int16-saturated mix goes through them
        (volume, chain) before the normalization.

        With ``mesh`` (a ``parallel.mesh.VoiceMesh``) the main drum hits
        and the pitched rows shard over its devices (exact int32 merges)
        and the synth voices shard over the same axis (f32 partials added
        in shard order: within 1 LSB of the single-device mix)."""
        from .effects import apply_fx_sample, chain_tail_frames
        sched, voices, vtracks, pitched, pends, frames = self._compile()
        (pbank, plens, pidx, pstart, prate, pgains, ploopf,
         ploopu) = pitched
        total = frames + int(tail_seconds * self.samplerate)
        if max_frames is not None:
            # a caller's limit counts the master chain's decay tails too
            with_tail = total + chain_tail_frames(self.fx, self.samplerate,
                                                  self.fx_irs)
            if with_tail > max_frames:
                raise ValueError(
                    f"mixdown of {with_tail} frames "
                    f"({with_tail / self.samplerate:.1f}s incl. fx tails) "
                    f"exceeds the caller's limit of {max_frames} frames")
        if len(sched.hits) == 0 and not voices and len(pidx) == 0:
            return Sample.from_raw_frames(b"", 2, self.samplerate,
                                          self.nchannels, device=self.device)
        sc_keys = self._sidechain_key_samples(total)
        out32 = torch.zeros((total, self.nchannels), dtype=torch.int32,
                            device=self.device)
        with profiling.span("sequencer.pitched"):
            for m, tname in (self._sampler_fx_masks(
                    self._last_pitched_tracks) if len(pidx) else ()):
                bus32 = self._pitched_mix(pbank, plens, pidx[m], pstart[m],
                                          prate[m], pgains[m], ploopf[m],
                                          ploopu[m], pends[m], total,
                                          mesh=mesh)
                if tname is None:
                    out32 = out32 + bus32
                else:
                    out32 = out32 + self._run_track_chain(
                        _to16(bus32), self.sampler_fx[tname], tname, total,
                        sc_keys)
        with profiling.span("sequencer.drums"):
            if len(sched.hits):
                main_m, drum_buses = self._drum_bus_split(sched)
                bank_d = _t(sched.bank, self.device)
                if main_m.any():
                    out32 = out32 + self._scatter(sched, main_m, total,
                                                  bank_d, mesh)
                for name, m in drum_buses.items():
                    out32 = out32 + self._run_track_chain(
                        _to16(self._scatter(sched, m, total, bank_d)),
                        self.drum_fx_bus[name], name, total, sc_keys)
        fx_tracks = self._fx_synth_tracks(vtracks)
        if voices and mesh is not None:
            from .parallel import mesh as PM
            if fx_tracks:
                # the grouped render over the mesh: each shard renders its
                # voices into the track buses, the bus stacks add in shard
                # order, and each fx'd bus runs its chain as below
                vp, seg, uw, ufm, ugl = PM.song_synth_shards_grouped(
                    voices, vtracks, fx_tracks, self.samplerate, mesh)
                buses = PM.render_song_grouped_sharded(
                    vp, seg, len(fx_tracks) + 1, total, self.samplerate,
                    chunk_frames=32768, num_harmonics=8, mesh=mesh,
                    used_waves=uw, use_fm=ufm, use_glide=ugl)
                out32 = self._add_synth_buses(out32, buses.to(self.device),
                                              fx_tracks, total, sc_keys)
            else:
                vp, uw, ufm, ugl, ub, ua, ud = PM.song_synth_shards(
                    voices, self.samplerate, mesh)
                stereo = PM.render_song_sharded(
                    vp, total, self.samplerate, chunk_frames=32768,
                    num_harmonics=8, mesh=mesh, used_waves=uw, use_fm=ufm,
                    use_glide=ugl, use_bend=ub, use_amp=ua, use_dmod=ud)
                out32 = out32 + _quantize(stereo.to(self.device))
        elif voices:
            if fx_tracks:
                # the grouped render: the clean bus plus a stereo bus per
                # fx'd track from one kernel launch
                bank, vp, seg, fx_tracks = self._synth_fx_groups(
                    voices, vtracks, chunk_frames=32768)
                buses = bank.render_song_grouped(vp, seg,
                                                 len(fx_tracks) + 1, total)
                out32 = self._add_synth_buses(out32, buses, fx_tracks,
                                              total, sc_keys)
            else:
                bank, vp = self._synth_bank(voices, chunk_frames=32768)
                out32 = out32 + _quantize(bank.render_song(vp, total))
        mv = self.automation.get("master.volume")
        if self.fx or mv:
            # the master chain takes the int16-saturated mix, the signal
            # the streaming path feeds its processors; normalization last
            out16 = _to16(out32)
            if mv:
                out16 = self._apply_master_volume(out16, 0)
            mixed = Sample.from_torch(out16, self.samplerate, 2,
                                      name="mixdown")
            if self.fx:
                apply_fx_sample(mixed, self.fx, self.fx_irs,
                                automation=self.automation,
                                tickf=self.tick_duration * self.samplerate,
                                sidechain_keys=sc_keys)
            if normalize:
                mixed.amplify_max()
            return mixed
        if normalize:
            mixed = Sample.from_torch(out32, self.samplerate, 4,
                                      name="mixdown")
            return mixed.make_16bit(maximize_amplitude=True)
        return Sample.from_torch(_to16(out32), self.samplerate, 2,
                                 name="mixdown")

    def mix_stems(self, tail_seconds: float = 0.3) -> Dict[str, Sample]:
        """Every track as its own stereo int16 stem, all of one length,
        with per-track fx (a drum instrument's baked chain is in its WAV).
        The master chain, master volume and normalization are not applied.
        Summing the stems gives ``mix(normalize=False)``'s pre-master bus
        (exactly for drum and sampler stems; for synth stems each bus sums
        its own voices, within float rounding of the flat sum) as long as
        no stem clips on its own."""
        sched, voices, vtracks, pitched, pends, frames = self._compile()
        (pbank, plens, pidx, pstart, prate, pgains, ploopf,
         ploopu) = pitched
        total = frames + int(tail_seconds * self.samplerate)
        if total == 0:
            return {}
        sc_keys = self._sidechain_key_samples(total)
        stems: Dict[str, Sample] = {}

        def stem(t16, name, chain):
            smp = Sample.from_torch(t16, self.samplerate, 2,
                                    name=f"stem:{name}")
            if chain is not None:
                smp._replace_frames(_to16(self._run_track_chain(
                    t16, chain, name, total, sc_keys)))
            stems[name] = smp

        bank_d = _t(sched.bank, self.device)
        for i, name in enumerate(sched.instruments):
            m = sched.hits[:, 0] == i
            if m.any():
                stem(_to16(self._scatter(sched, m, total, bank_d)), name,
                     self.drum_fx_bus.get(name))
        ptr = np.asarray(self._last_pitched_tracks)
        for name in sorted(self.samplers):
            m = ptr == name
            if m.any():
                stem(_to16(self._pitched_mix(
                    pbank, plens, pidx[m], pstart[m], prate[m], pgains[m],
                    ploopf[m], ploopu[m], pends[m], total)), name,
                    self.sampler_fx.get(name))
        if voices:
            # one grouped render with a bus per synth track
            track_names = sorted(set(vtracks))
            seg_index = {n: i for i, n in enumerate(track_names)}
            bank, vp, seg = self._grouped_bank(
                voices, [seg_index[t] for t in vtracks], 32768)
            buses = bank.render_song_grouped(vp, seg, len(track_names),
                                             total)
            for i, name in enumerate(track_names):
                stem(_to16(_quantize(buses[:, i])), name,
                     self.synth_fx.get(name))
        return stems

    # -- streaming mixdown ------------------------------------------------

    def mix_generator(self, chunk_frames: Optional[int] = None,
                      mesh=None, start_frame: int = 0) -> Iterator[Sample]:
        """Stream the song as fixed-size int16 chunks rendered on the
        song's device.

        With a master ``[fx]`` chain every chunk runs through the stateful
        streaming processors, and silence-fed chunks drain the decay tails
        at the end: the result matches ``mix(normalize=False,
        tail_seconds=0)`` within the per-effect budgets.  Seeking with fx
        starts the effect state cold at ``start_frame``.  With ``mesh``
        each chunk renders sharded as ``mix(mesh=)`` does, bit-identical
        to the sharded offline mix."""
        sc_fns = self._sidechain_key_fns()
        gen = self._mix_generator_raw(chunk_frames, start_frame, sc_fns,
                                      mesh)
        if "master.volume" in self.automation:
            gen = self._volume_chunks(gen, start_frame)
        if not self.fx:
            yield from gen
            return
        from .effects import FxChain
        chain = FxChain(self.fx, self.samplerate, self.nchannels,
                        self.fx_irs, automation=self.automation,
                        tickf=self.tick_duration * self.samplerate,
                        start_frame=int(start_frame),
                        sidechain_keys=sc_fns, device=self.device)
        cf = chunk_frames or params.norm_frames_per_chunk
        ck = 0
        for chunk in gen:
            ck += 1
            yield Sample.from_torch(chain.process(chunk.torch_frames),
                                    self.samplerate, 2, name=chunk.name)
        left = chain.tail_frames + chain.flush_frames
        while left > 0:
            n = min(cf, left)
            z = torch.zeros((n, self.nchannels), dtype=torch.int16,
                            device=self.device)
            yield Sample.from_torch(chain.process(z), self.samplerate, 2,
                                    name=f"fxtail@{ck}")
            ck += 1
            left -= n

    def _volume_chunks(self, gen: Iterator[Sample],
                       start_frame: int) -> Iterator[Sample]:
        """Master-volume automation chunk by chunk (the offline path's
        absolute-frame formula: bit-exact at any chunk size)."""
        n0 = int(start_frame)
        for chunk in gen:
            yield Sample.from_torch(
                self._apply_master_volume(chunk.torch_frames, n0),
                self.samplerate, 2, name=chunk.name)
            n0 += chunk.nframes

    def _rows(self, per_chunk, K: int, insts, starts, gains):
        """Bucketed drum hits as [nchunks, K] row tensors on the device:
        (instrument, start, valid, gains [.., C])."""
        nchunks = len(per_chunk)
        ii = np.zeros((nchunks, K), np.int64)
        ss = np.zeros((nchunks, K), np.int64)
        vv = np.zeros((nchunks, K), bool)
        gg = np.zeros((nchunks, K, self.nchannels), np.float32)
        for c, hs in enumerate(per_chunk):
            hs = hs[:K]
            ii[c, :len(hs)] = insts[hs]
            ss[c, :len(hs)] = starts[hs]
            vv[c, :len(hs)] = True
            gg[c, :len(hs)] = gains[hs]
        return tuple(_t(a, self.device) for a in (ii, ss, vv, gg))

    def _mix_generator_raw(self, chunk_frames: Optional[int] = None,
                           start_frame: int = 0,
                           sidechain_keys: Optional[Dict] = None,
                           mesh=None) -> Iterator[Sample]:
        """Stream the song as fixed-size chunks, before the master volume
        and chain.  Host control walks the hit schedule; each chunk is one
        gather and sum over the hits overlapping it, the pitched rows of
        the chunk, and one bank render.  Bit-identical to
        ``mix(normalize=False)`` sliced (streaming saturates at int16; it
        cannot normalize).  ``start_frame`` seeks: every render is
        stateless in the absolute frame, so the first chunk starts exactly
        there, mid-hit and mid-note included, bit-exact with the offline
        slice (track chains start cold at the seek).  With ``mesh`` the
        main drum rows and the pitched rows (each padded to a multiple of
        the mesh size) and the synth voices shard as in ``mix(mesh=)``;
        the drum fx buses stay unsharded."""
        plan = self._stream_plan(chunk_frames, start_frame, sidechain_keys,
                                 mesh)
        if plan is None:
            return
        (start_frame, total, cf, bank, main_rows, bus_rows, drum_chunk,
         pitched_groups, pitched_chunk, pbank_d, plens_d, synth,
         track_chains) = plan
        for ci, c0 in enumerate(range(start_frame, total, cf)):
            # the chunk's span closes before the chunk is handed out
            with profiling.span("sequencer.chunk"):
                with profiling.span("sequencer.drums"):
                    acc = drum_chunk(bank, *(r[ci] for r in main_rows), c0,
                                     cf)
                    for rows, chain in bus_rows.values():
                        b16 = _to16(_stream_chunk(
                            bank, *(r[ci] for r in rows), c0, cf))
                        acc = acc + chain.process(b16).to(torch.int32)
                with profiling.span("sequencer.pitched"):
                    for rows, chain in pitched_groups:
                        pc = pitched_chunk(pbank_d, plens_d,
                                           *(r[ci] for r in rows), c0, cf)
                        acc = acc + (pc if chain is None else
                                     chain.process(_to16(pc)).to(torch.int32))
                synth_chunk = None
                if synth is not None:
                    synth_chunk, tbuses = synth(c0)
                    for tname, tb in tbuses.items():
                        acc = acc + track_chains[tname].process(
                            _to16(_quantize(tb))).to(torch.int32)
                chunk = _finish_chunk(acc, synth_chunk)
                n = min(cf, total - c0)
                out = Sample.from_torch(chunk[:n], self.samplerate, 2,
                                        name=f"chunk@{c0}")
            yield out

    @profiling.spanned("sequencer.stream_setup")
    def _stream_plan(self, chunk_frames, start_frame, sidechain_keys, mesh):
        """A pass's set-up for ``_mix_generator_raw``: the compiled song,
        the bucketed rows of every chunk, the banks and the track chains;
        None when nothing is left to stream."""
        from .effects import FxChain
        sched, voices, vtracks, pitched, pends, total = self._compile()
        (pbank, plens, pidx, pstart, prate, pgains, ploopf,
         ploopu) = pitched
        fx_tracks = self._fx_synth_tracks(vtracks)
        cf = chunk_frames or params.norm_frames_per_chunk
        start_frame = int(start_frame)
        if start_frame < 0:
            raise ValueError("start_frame must be >= 0")
        if total == 0 or start_frame >= total:
            return None
        dev = self.device
        sc_fns = (sidechain_keys if sidechain_keys is not None
                  else self._sidechain_key_fns())

        def track_chain(fx, name):
            return FxChain(fx, self.samplerate, self.nchannels, self.fx_irs,
                           automation=self._track_fx_automation(name),
                           tickf=self._fx_tickf(), start_frame=start_frame,
                           sidechain_keys=sc_fns, device=dev)

        synth = None          # c0 -> (clean f32 [cf, 2], {track: bus})
        track_chains: Dict[str, "object"] = {}
        if voices and fx_tracks:
            nseg = len(fx_tracks) + 1
            if mesh is not None:
                from .parallel import mesh as PM
                gvp, gseg, uw, ufm, ugl = PM.song_synth_shards_grouped(
                    voices, vtracks, fx_tracks, self.samplerate, mesh)
                gfn = PM.render_chunk_grouped_sharded_fn(
                    mesh, cf, self.samplerate, 8, uw, ufm, nseg,
                    use_glide=ugl)

                def grouped(c0):
                    return gfn(gvp, gseg, c0).to(dev)
            else:
                gbank, gvp, gseg, fx_tracks = self._synth_fx_groups(
                    voices, vtracks, chunk_frames=cf)

                def grouped(c0):
                    return gbank.render_chunk_grouped(gvp, gseg, nseg, c0)
            track_chains = {n: track_chain(self.synth_fx[n], n)
                            for n in fx_tracks}

            def synth(c0):
                buses = grouped(c0)
                return buses[:, 0], {n: buses[:, i + 1]
                                     for i, n in enumerate(fx_tracks)}
        elif voices and mesh is not None:
            from .parallel import mesh as PM
            svp, uw, ufm, ugl, ub, ua, ud = PM.song_synth_shards(
                voices, self.samplerate, mesh)
            sfn = PM.render_chunk_sharded_fn(
                mesh, cf, self.samplerate, 8, uw, ufm, use_glide=ugl,
                use_bend=ub, use_amp=ua, use_dmod=ud)

            def synth(c0):
                return sfn(svp, c0).to(dev), {}
        elif voices:
            sbank, svp = self._synth_bank(voices, chunk_frames=cf)

            def synth(c0):
                return sbank.render_chunk(svp, c0), {}

        # chunk ci covers [start_frame + ci*cf, start_frame + (ci+1)*cf)
        nchunks = -(-(total - start_frame) // cf)
        ndev = mesh.size if mesh is not None else 0
        drum_chunk, pitched_chunk = _stream_chunk, _pitched_chunk_body
        if mesh is not None:
            from .parallel import mesh as PM
            sharded_drums = PM.stream_chunk_sharded_fn(mesh, cf)
            sharded_pitched = PM.pitched_chunk_sharded_fn(mesh, cf)

            # the sharded fns hold cf: the bodies' last argument drops
            def drum_chunk(*a):
                return sharded_drums(*a[:-1]).to(dev)

            def pitched_chunk(*a):
                return sharded_pitched(*a[:-1]).to(dev)
        pitched_groups = []     # (rows, chain or None)
        pbank_d = plens_d = None
        if len(pidx):
            pbank_d = _t(pbank, dev)
            plens_d = _t(plens, dev)
            for m, tname in self._sampler_fx_masks(
                    self._last_pitched_tracks):
                pper, PK = self._bucket(pstart[m], pends[m], nchunks, cf,
                                        start_frame, ndev)
                rows = self._pitched_rows(pper, PK, pidx[m], pstart[m],
                                          prate[m], pgains[m], ploopf[m],
                                          ploopu[m])
                pitched_groups.append((rows, None if tname is None else
                                       track_chain(self.sampler_fx[tname],
                                                   tname)))
        bank = _t(sched.bank, dev)
        starts = sched.hits[:, 1]
        insts = sched.hits[:, 0]
        main_m, drum_buses = self._drum_bus_split(sched)
        ends = starts + sched.lengths[insts]
        main_rows = self._rows(*self._bucket(starts[main_m], ends[main_m],
                                             nchunks, cf, start_frame, ndev),
                               insts[main_m], starts[main_m],
                               sched.gains[main_m])
        bus_rows = {
            name: (self._rows(*self._bucket(starts[m], ends[m], nchunks, cf,
                                            start_frame),
                              insts[m], starts[m], sched.gains[m]),
                   track_chain(self.drum_fx_bus[name], name))
            for name, m in drum_buses.items()}
        return (start_frame, total, cf, bank, main_rows, bus_rows, drum_chunk,
                pitched_groups, pitched_chunk, pbank_d, plens_d, synth,
                track_chains)
