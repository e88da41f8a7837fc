#!/usr/bin/env python3
"""keyboard_gui — piano-keyboard synthesizer GUI (the port's copy of the
repo's ``keyboard_gui.py``).

A Tk piano keyboard with per-oscillator panels (waveform, ratio/
detune, amplitude, phase), an ADSR editor, FM & PWM LFO routing, an echo
toggle, instrument presets saved/loaded as ``.ini``, and a live VU meter.

The synthesis logic lives in :class:`SynthController`, which is fully
headless (tested in CI without a display): key presses build an oscillator
patch from the current panel state — exactly the reference's flow (§4.5) —
and render through the device graph into the mixed-mode Output, on the
controller's ``device`` (the card unless the caller asks for the CPU).  The
Tk layer (:class:`SynthGUI`) is a thin view over the controller.

Run:  python -m synthesizer_tpu_torch.apps.keyboard_gui [--device cpu]
      (requires a display + audio device)
"""

from __future__ import annotations

import configparser
import dataclasses
from typing import Dict, List, Optional, Tuple

import torch

from synthesizer_tpu_torch import (LevelMeter, Output, RealtimeVoice, Sample,
                                   WaveSynth, key_freq)
from synthesizer_tpu_torch import oscillators as osc
from synthesizer_tpu_torch import params
from synthesizer_tpu_torch.utils.device import resolve

WAVEFORMS = ["sine", "triangle", "square", "square_h", "sawtooth",
             "sawtooth_h", "pulse", "harmonics", "semicircle", "pointy",
             "white_noise", "sawtooth_bl", "square_bl", "wavetable",
             "pluck", "off"]


@dataclasses.dataclass
class OscSettings:
    """One oscillator panel (the reference had several of these)."""
    waveform: str = "sine"
    amplitude: float = 0.5
    ratio: float = 1.0            # frequency multiplier vs the played key
    detune: float = 0.0           # extra Hz
    phase: float = 0.0
    pulse_width: float = 0.1
    fm_source: Optional[int] = None    # index of the oscillator used as FM LFO
    pwm_source: Optional[int] = None
    num_harmonics: int = 16
    harmonics: Tuple[Tuple[float, float], ...] = ((1, 1.0), (2, 0.5), (4, 0.25))
    table: Tuple[float, ...] = (0.0, 0.7, 1.0, 0.7, 0.0, -0.7, -1.0, -0.7)
    seed: int = 0                 # pluck/white_noise excitation
    damping: float = 1.0          # pluck loop loss


@dataclasses.dataclass
class EnvSettings:
    attack: float = 0.02
    decay: float = 0.1
    sustain: float = 0.4          # sustain duration while key held (s)
    sustain_level: float = 0.6
    release: float = 0.4


@dataclasses.dataclass
class FilterSettings:
    """Beyond-reference: a resonant biquad on the summed patch."""
    enabled: bool = False
    kind: str = "lowpass"         # lowpass | highpass | bandpass
    cutoff: float = 1200.0
    q: float = 0.7071
    lfo_source: Optional[int] = None   # osc panel index sweeping the cutoff
                                       # (its output is octaves of sweep)


@dataclasses.dataclass
class ReverbSettings:
    """Beyond-reference: master-bus Freeverb on the Output's mixed chunks
    (synthesizer_tpu_torch.effects.FxChain — the playback twin of [fx])."""
    enabled: bool = False
    roomsize: float = 0.6
    damping: float = 0.5
    wet: float = 0.25
    dry: float = 0.9
    tail: float = 1.0


@dataclasses.dataclass
class LimiterSettings:
    """Beyond-reference: lookahead brickwall limiter at the END of the
    master bus — keeps many held keys (or a hot reverb) from clipping
    the output sink.  Rides the same FxChain as the reverb."""
    enabled: bool = False
    ceiling_db: float = -1.0
    release: float = 0.05
    lookahead: float = 0.005


@dataclasses.dataclass
class EchoSettings:
    enabled: bool = False
    after: float = 0.05
    amount: int = 4
    delay: float = 0.125
    decay: float = 0.5


class ArpSettings:
    """Arpeggiator: when enabled, a held key loops a chord arpeggio."""

    def __init__(self, enabled: bool = False, intervals=(0, 4, 7, 12),
                 rate: float = 8.0):
        self.enabled = enabled
        self.intervals = tuple(intervals)   # semitone offsets from the key
        self.rate = rate                    # notes per second


class SynthController:
    """Headless synthesizer state + voice factory (the GUI's brain),
    rendering on ``device``."""

    NUM_OSC = 3

    def __init__(self, samplerate: int = 0, output: Optional[Output] = None,
                 device="cuda"):
        self.device = resolve(device)
        self.samplerate = samplerate or params.norm_samplerate
        self.oscs: List[OscSettings] = [OscSettings()]
        self.oscs += [OscSettings(waveform="off", amplitude=0.3)
                      for _ in range(self.NUM_OSC - 1)]
        self.env = EnvSettings()
        self.echo = EchoSettings()
        self.filter = FilterSettings()
        self.reverb = ReverbSettings()
        self.limiter = LimiterSettings()
        self.arp = ArpSettings()
        self.a4 = 440.0
        #: blocks rendered per device round trip (None = pick by platform)
        self.voice_lookahead: Optional[int] = None
        #: sampler mode: a loaded Sample played repitched per key (FL
        #: sampler-channel style); None = synthesize from the osc panels
        self.sampler_sample: Optional[Sample] = None
        self.sampler_base_key: int = 60            # C4
        self.synth = WaveSynth(samplerate=self.samplerate, samplewidth=2,
                               device=self.device)
        self.output = output
        self._active: Dict[int, int] = {}   # key number -> playback sid
        self.meter = LevelMeter()

    # -- patch building (reference stack §4.5) --------------------------------

    def _lfo_for(self, index: Optional[int], freq: float) -> Optional[osc.Oscillator]:
        if index is None:
            return None
        s = self.oscs[index]
        if s.waveform == "off":
            return None
        return self._make_osc(s, freq)

    def _make_osc(self, s: OscSettings, key_frequency: float,
                  allow_routing: bool = False) -> osc.Oscillator:
        freq = key_frequency * s.ratio + s.detune
        fm = self._lfo_for(s.fm_source, key_frequency) if allow_routing else None
        kw = dict(amplitude=s.amplitude, phase=s.phase, samplerate=self.samplerate)
        w = s.waveform
        if w == "sine":
            return osc.Sine(freq, fm_lfo=fm, **kw)
        if w == "triangle":
            return osc.Triangle(freq, fm_lfo=fm, **kw)
        if w == "square":
            return osc.Square(freq, fm_lfo=fm, **kw)
        if w == "square_h":
            return osc.SquareH(freq, num_harmonics=s.num_harmonics, fm_lfo=fm, **kw)
        if w == "sawtooth":
            return osc.Sawtooth(freq, fm_lfo=fm, **kw)
        if w == "sawtooth_h":
            return osc.SawtoothH(freq, num_harmonics=s.num_harmonics, fm_lfo=fm, **kw)
        if w == "pulse":
            pwm = self._lfo_for(s.pwm_source, key_frequency) if allow_routing else None
            return osc.Pulse(freq, pulse_width=s.pulse_width, fm_lfo=fm,
                             pwm_lfo=pwm, **kw)
        if w == "harmonics":
            return osc.Harmonics(freq, s.harmonics, fm_lfo=fm, **kw)
        if w == "semicircle":
            return osc.Semicircle(freq, fm_lfo=fm, **kw)
        if w == "pointy":
            return osc.Pointy(freq, fm_lfo=fm, **kw)
        if w == "white_noise":
            return osc.WhiteNoise(freq, amplitude=s.amplitude,
                                  samplerate=self.samplerate)
        if w == "sawtooth_bl":
            return osc.BandlimitedSawtooth(freq, **kw)
        if w == "square_bl":
            return osc.BandlimitedSquare(freq, **kw)
        if w == "wavetable":
            return osc.Wavetable(freq, s.table, fm_lfo=fm, **kw)
        if w == "pluck":
            return osc.Pluck(freq, amplitude=s.amplitude, phase=s.phase,
                             num_harmonics=s.num_harmonics, seed=s.seed,
                             damping=s.damping, samplerate=self.samplerate)
        raise ValueError(f"waveform {w!r}")

    def build_raw_patch(self, key_number: int,
                        include_echo: bool = True) -> osc.Oscillator:
        """GUI state + key -> un-enveloped oscillator patch (mix of active
        panels, optional echo) — the realtime gate envelope applies on top.
        The realtime voice path passes ``include_echo=False`` and applies
        echo AFTER the gate instead (the reference's envelope->echo
        order); RealtimeVoice carries the echo tail across blocks."""
        freq = key_freq(key_number, self.a4)
        sources = [self._make_osc(s, freq, allow_routing=True)
                   for i, s in enumerate(self.oscs)
                   if s.waveform != "off" and not self._is_lfo_only(i)]
        if not sources:
            sources = [osc.Sine(freq, amplitude=0.5, samplerate=self.samplerate)]
        patch: osc.Oscillator = (sources[0] if len(sources) == 1
                                 else osc.MixingFilter(*sources))
        patch = self._apply_filter(patch)
        if include_echo and self.echo.enabled:
            patch = osc.EchoFilter(patch, self.echo.after, self.echo.amount,
                                   self.echo.delay, self.echo.decay)
        return patch

    def build_patch(self, key_number: int) -> osc.Oscillator:
        """GUI state + key -> finished patch with a duration-based ADSR
        (the offline render path; realtime playing uses build_raw_patch +
        a gate-driven RealtimeVoice, SURVEY.md §4.5)."""
        freq = key_freq(key_number, self.a4)
        sources = [self._make_osc(s, freq, allow_routing=True)
                   for i, s in enumerate(self.oscs)
                   if s.waveform != "off" and not self._is_lfo_only(i)]
        if not sources:
            sources = [osc.Sine(freq, amplitude=0.5, samplerate=self.samplerate)]
        patch: osc.Oscillator = (sources[0] if len(sources) == 1
                                 else osc.MixingFilter(*sources))
        patch = self._apply_filter(patch)
        e = self.env
        patch = osc.EnvelopeFilter(patch, e.attack, e.decay, e.sustain,
                                   e.sustain_level, e.release, stop_at_end=True)
        if self.echo.enabled:
            patch = osc.EchoFilter(patch, self.echo.after, self.echo.amount,
                                   self.echo.delay, self.echo.decay)
        return patch

    def _apply_filter(self, patch: osc.Oscillator) -> osc.Oscillator:
        if not self.filter.enabled:
            return patch
        cls = {"lowpass": osc.LowpassFilter, "highpass": osc.HighpassFilter,
               "bandpass": osc.BandpassFilter}[self.filter.kind]
        lfo = (self._lfo_for(self.filter.lfo_source, self.filter.cutoff)
               if self.filter.lfo_source is not None else None)
        return cls(patch, self.filter.cutoff, self.filter.q, cutoff_lfo=lfo)

    def _is_lfo_only(self, index: int) -> bool:
        """Panels used as FM/PWM/filter-LFO sources do not sound directly."""
        if self.filter.enabled and self.filter.lfo_source == index:
            return True
        return any(s.fm_source == index or s.pwm_source == index
                   for s in self.oscs)

    def render_key(self, key_number: int) -> Sample:
        """Render one key press to a finished Sample (offline voice)."""
        patch = self.build_patch(key_number)
        dur = patch.duration or (self.env.attack + self.env.decay
                                 + self.env.sustain + self.env.release)
        if self.echo.enabled:
            dur += self.echo.after + self.echo.amount * self.echo.delay
        return self.synth.render_oscillator(patch, dur, name=f"key{key_number}")

    def render_arpeggio(self, key_number: int) -> Sample:
        """One cycle of the arpeggio for a held key (loopable Sample)."""
        step = 1.0 / self.arp.rate
        total = Sample.from_raw_frames(b"", 2, self.samplerate, 1,
                                       device=self.device)
        for i, semi in enumerate(self.arp.intervals):
            e = self.env
            note = self.build_raw_patch(key_number + semi)
            note = osc.EnvelopeFilter(note, min(e.attack, step / 4),
                                      min(e.decay, step / 4),
                                      max(step / 2 - e.release, 0.01),
                                      e.sustain_level,
                                      min(e.release, step / 4),
                                      stop_at_end=True)
            s = self.synth.render_oscillator(note, step, name=f"arp{i}")
            total.mix_at(i * step, s, pad_shortest=True)
        want = int(len(self.arp.intervals) * step * self.samplerate)
        if total.nframes < want:
            total.add_silence((want - total.nframes) / self.samplerate)
        return total.clip(0, want / self.samplerate)

    def _probe_lookahead(self) -> int:
        """Measure one host<->device round trip: devices behind a slow
        link (over 5 ms a sync against a 33 ms block) get 4-block
        superblocks (bit-identical audio; bare key-up latency grows to the
        superblock), locally attached ones keep per-block latency."""
        import time
        x = torch.zeros((), device=self.device)
        float(x)                                   # warm the path
        t0 = time.perf_counter()
        for _ in range(3):
            float(x + 0)
        per_sync = (time.perf_counter() - t0) / 3
        return 4 if per_sync > 0.005 else 1

    def load_sampler(self, wav_file_or_sample, base_key: int = 60) -> None:
        """Enter sampler mode: keys play ``wav_file_or_sample`` repitched
        by the equal-tempered ratio from ``base_key`` (Sample.speed — the
        exact audioop-ratecv resampler).  ``clear_sampler()`` returns to
        the synthesizer panels."""
        if isinstance(wav_file_or_sample, Sample):
            smp = wav_file_or_sample.copy()
        else:
            smp = Sample(wave_file=wav_file_or_sample, device=self.device)
        if smp.samplerate != self.samplerate:
            smp.resample(self.samplerate)
        self.sampler_sample = smp
        self.sampler_base_key = int(base_key)

    def clear_sampler(self) -> None:
        self.sampler_sample = None

    def render_sampler_key(self, key_number: int) -> Sample:
        """The loaded sampler WAV repitched for one key."""
        assert self.sampler_sample is not None
        ratio = 2.0 ** ((key_number - self.sampler_base_key) / 12.0)
        out = self.sampler_sample.copy().speed(ratio)
        out.name = f"smp{key_number}"
        return out

    def key_down(self, key_number: int) -> None:
        """Start a gate-driven streaming voice (held until key_up)."""
        if self.output is None or key_number in self._active:
            return
        if self.sampler_sample is not None:
            smp = self.render_sampler_key(key_number)
            if self.output.nchannels == 2 and smp.nchannels == 1:
                smp.stereo()
            self.meter.update(smp)
            sid = self.output.play_sample(smp)
            self._active[key_number] = (sid, None)
            return
        if self.arp.enabled:
            cycle = self.render_arpeggio(key_number)
            if self.output.nchannels == 2:
                cycle.stereo()
            sid = self.output.play_sample(cycle, repeat=True)
            self._active[key_number] = (sid, "arp")
            return
        if self.output.mixing == "mixed":
            e = self.env
            echo = (self.echo.after, self.echo.amount, self.echo.delay,
                    self.echo.decay) if self.echo.enabled else None
            la = self.voice_lookahead
            if la is None:
                la = self.voice_lookahead = self._probe_lookahead()
            voice = RealtimeVoice(self.build_raw_patch(key_number,
                                                       include_echo=False),
                                  e.attack, e.decay, e.sustain_level, e.release,
                                  samplerate=self.samplerate,
                                  blocksize=self.output.frames_per_chunk,
                                  echo=echo, lookahead_blocks=la,
                                  device=self.device)
            sid = self.output.mixer.add_stream(voice.chunks())
            self._active[key_number] = (sid, voice)
        else:
            sample = self.render_key(key_number)
            self.meter.update(sample)
            self.output.play_sample(sample)
            self._active[key_number] = (None, None)

    def key_up(self, key_number: int) -> None:
        """Release the gate: the voice's envelope ramps out and the mixer
        drops the stream when it ends (arpeggio loops stop immediately)."""
        entry = self._active.pop(key_number, None)
        if entry is None:
            return
        sid, voice = entry
        if voice == "arp":
            # looping arpeggio cycles stop on release; one-shot sampler
            # notes (voice is None) play out regardless of the arp toggle
            if sid is not None and self.output is not None:
                self.output.stop_sample(sid)
        elif voice is not None:
            voice.release()

    def apply_reverb(self) -> None:
        """(Re)install the master chain on the output's mixed bus from
        the current ReverbSettings + LimiterSettings (reverb first, the
        brickwall last — console order; no-op headless)."""
        if self.output is None:
            return
        fx = []
        if self.reverb.enabled:
            r = self.reverb
            fx.append(("reverb", dict(roomsize=r.roomsize,
                                      damping=r.damping, wet=r.wet,
                                      dry=r.dry, tail=r.tail)))
        if self.limiter.enabled:
            lm = self.limiter
            fx.append(("limiter", dict(ceiling_db=lm.ceiling_db,
                                       release=lm.release,
                                       lookahead=lm.lookahead)))
        if fx:
            from synthesizer_tpu_torch.effects import FxChain
            self.output.fx = FxChain(fx, self.samplerate,
                                     self.output.nchannels,
                                     device=self.device)
            # superblock the bus: one device round trip per 4 chunks (the
            # realtime-voice lookahead trick); costs up to 3 chunks
            # (~0.1 s) of reverb onset latency
            self.output.fx_lookahead = 4
        else:
            self.output.fx = None

    # -- instrument presets (.ini, like the reference) ------------------------

    def save_preset(self, file) -> None:
        cp = configparser.ConfigParser()
        for i, s in enumerate(self.oscs):
            sec = f"osc{i}"
            cp[sec] = {k: str(v) for k, v in dataclasses.asdict(s).items()}
            cp[sec]["table"] = " ".join(str(v) for v in s.table)
        cp["envelope"] = {k: str(v) for k, v in dataclasses.asdict(self.env).items()}
        cp["echo"] = {k: str(v) for k, v in dataclasses.asdict(self.echo).items()}
        cp["filter"] = {k: str(v) for k, v in dataclasses.asdict(self.filter).items()}
        cp["reverb"] = {k: str(v) for k, v in dataclasses.asdict(self.reverb).items()}
        cp["limiter"] = {k: str(v) for k, v in dataclasses.asdict(self.limiter).items()}
        cp["arpeggio"] = {"enabled": str(self.arp.enabled),
                          "intervals": " ".join(str(i) for i in self.arp.intervals),
                          "rate": str(self.arp.rate)}
        if isinstance(file, str):
            with open(file, "w") as f:
                cp.write(f)
        else:
            cp.write(file)

    def load_preset(self, file) -> None:
        cp = configparser.ConfigParser()
        if isinstance(file, str):
            cp.read(file)
        else:
            cp.read_file(file)
        for i in range(self.NUM_OSC):
            sec = f"osc{i}"
            if sec not in cp:
                continue
            s = self.oscs[i]
            g = cp[sec]
            s.waveform = g.get("waveform", s.waveform)
            s.amplitude = g.getfloat("amplitude", s.amplitude)
            s.ratio = g.getfloat("ratio", s.ratio)
            s.detune = g.getfloat("detune", s.detune)
            s.phase = g.getfloat("phase", s.phase)
            s.pulse_width = g.getfloat("pulse_width", s.pulse_width)
            s.num_harmonics = g.getint("num_harmonics", s.num_harmonics)
            s.seed = g.getint("seed", s.seed)
            s.damping = g.getfloat("damping", s.damping)
            if g.get("table", "").strip():
                s.table = tuple(float(x) for x in g.get("table").split())
            for attr in ("fm_source", "pwm_source"):
                raw = g.get(attr, "None")
                setattr(s, attr, None if raw in ("None", "") else int(raw))
        if "envelope" in cp:
            g = cp["envelope"]
            for f in dataclasses.fields(EnvSettings):
                setattr(self.env, f.name, g.getfloat(f.name, getattr(self.env, f.name)))
        if "reverb" in cp:
            g = cp["reverb"]
            self.reverb.enabled = g.getboolean("enabled", self.reverb.enabled)
            for f in ("roomsize", "damping", "wet", "dry", "tail"):
                setattr(self.reverb, f, g.getfloat(f, getattr(self.reverb, f)))
            self.apply_reverb()
        if "limiter" in cp:
            g = cp["limiter"]
            self.limiter.enabled = g.getboolean("enabled",
                                                self.limiter.enabled)
            for f in ("ceiling_db", "release", "lookahead"):
                setattr(self.limiter, f,
                        g.getfloat(f, getattr(self.limiter, f)))
            self.apply_reverb()
        if "echo" in cp:
            g = cp["echo"]
            self.echo.enabled = g.getboolean("enabled", self.echo.enabled)
            self.echo.after = g.getfloat("after", self.echo.after)
            self.echo.amount = g.getint("amount", self.echo.amount)
            self.echo.delay = g.getfloat("delay", self.echo.delay)
            self.echo.decay = g.getfloat("decay", self.echo.decay)
        if "filter" in cp:
            g = cp["filter"]
            self.filter.enabled = g.getboolean("enabled", self.filter.enabled)
            self.filter.kind = g.get("kind", self.filter.kind)
            self.filter.cutoff = g.getfloat("cutoff", self.filter.cutoff)
            self.filter.q = g.getfloat("q", self.filter.q)
            raw = g.get("lfo_source", "None")
            self.filter.lfo_source = (None if raw in ("None", "")
                                      else int(raw))
        if "arpeggio" in cp:
            g = cp["arpeggio"]
            self.arp.enabled = g.getboolean("enabled", self.arp.enabled)
            self.arp.rate = g.getfloat("rate", self.arp.rate)
            iv = g.get("intervals", "")
            if iv:
                self.arp.intervals = tuple(int(x) for x in iv.split())


# ---------------------------------------------------------------------------
# Tk view
# ---------------------------------------------------------------------------

KEYBOARD_KEYS = "zsxdcvgbhnjm"      # one octave of QWERTY keys
FIRST_KEY = 40                      # middle C


class SynthGUI:
    """Tk piano-keyboard view over SynthController (display required)."""

    def __init__(self, controller: Optional[SynthController] = None,
                 device="cuda"):
        import tkinter as tk
        from tkinter import filedialog, ttk

        self.tk = tk
        self.filedialog = filedialog
        self.root = tk.Tk()
        self.root.title("synthesizer_tpu_torch keyboard")
        s_ctrl = controller or SynthController(device=device)
        self.output = Output(mixing="mixed", meter=s_ctrl.meter)
        self.ctrl = s_ctrl
        self.ctrl.output = self.output

        panel = ttk.Frame(self.root)
        panel.pack(side=tk.TOP, fill=tk.X)
        self.wave_vars = []
        for i, s in enumerate(self.ctrl.oscs):
            f = ttk.LabelFrame(panel, text=f"osc {i}")
            f.pack(side=tk.LEFT, padx=4, pady=4)
            var = tk.StringVar(value=s.waveform)
            self.wave_vars.append(var)
            ttk.Combobox(f, textvariable=var, values=WAVEFORMS,
                         width=10).pack()
            amp = tk.DoubleVar(value=s.amplitude)
            tk.Scale(f, from_=0.0, to=1.0, resolution=0.01, variable=amp,
                     orient=tk.HORIZONTAL, label="amp",
                     command=lambda v, i=i: self._set(i, "amplitude", float(v))
                     ).pack()
            # pluck loop loss (ignored by other waveforms)
            tk.Scale(f, from_=0.2, to=4.0, resolution=0.1, orient=tk.HORIZONTAL,
                     label="damping",
                     command=lambda v, i=i: self._set(i, "damping", float(v))
                     ).pack()
            var.trace_add("write",
                          lambda *_, i=i, var=var: self._set(i, "waveform", var.get()))

        env = ttk.LabelFrame(panel, text="ADSR")
        env.pack(side=tk.LEFT, padx=4)
        for name, lo, hi in (("attack", 0.0, 1.0), ("decay", 0.0, 1.0),
                             ("sustain_level", 0.0, 1.0), ("release", 0.0, 2.0)):
            tk.Scale(env, from_=lo, to=hi, resolution=0.01,
                     orient=tk.HORIZONTAL, label=name,
                     command=lambda v, n=name: setattr(self.ctrl.env, n, float(v))
                     ).pack()

        filt = ttk.LabelFrame(panel, text="filter")
        filt.pack(side=tk.LEFT, padx=4)
        self.filter_var = tk.BooleanVar(value=False)
        ttk.Checkbutton(filt, text="enabled", variable=self.filter_var,
                        command=lambda: setattr(self.ctrl.filter, "enabled",
                                                self.filter_var.get())).pack()
        self.filter_kind = tk.StringVar(value=self.ctrl.filter.kind)
        ttk.Combobox(filt, textvariable=self.filter_kind, width=9,
                     values=["lowpass", "highpass", "bandpass"],
                     postcommand=lambda: setattr(self.ctrl.filter, "kind",
                                                 self.filter_kind.get())).pack()
        tk.Scale(filt, from_=50, to=12000, resolution=10, orient=tk.HORIZONTAL,
                 label="cutoff",
                 command=lambda v: setattr(self.ctrl.filter, "cutoff",
                                           float(v))).pack()
        tk.Scale(filt, from_=0.3, to=12.0, resolution=0.1, orient=tk.HORIZONTAL,
                 label="q",
                 command=lambda v: setattr(self.ctrl.filter, "q",
                                           float(v))).pack()

        echo = ttk.LabelFrame(panel, text="echo")
        echo.pack(side=tk.LEFT, padx=4)
        self.echo_var = tk.BooleanVar(value=False)
        ttk.Checkbutton(echo, text="enabled", variable=self.echo_var,
                        command=lambda: setattr(self.ctrl.echo, "enabled",
                                                self.echo_var.get())).pack()

        rev = ttk.LabelFrame(panel, text="reverb")
        rev.pack(side=tk.LEFT, padx=4)
        self.reverb_var = tk.BooleanVar(value=False)

        def _set_reverb(field, value):
            setattr(self.ctrl.reverb, field, value)
            self.ctrl.apply_reverb()
        ttk.Checkbutton(rev, text="enabled", variable=self.reverb_var,
                        command=lambda: _set_reverb(
                            "enabled", self.reverb_var.get())).pack()
        tk.Scale(rev, from_=0.0, to=1.0, resolution=0.05,
                 orient=tk.HORIZONTAL, label="room",
                 command=lambda v: _set_reverb("roomsize", float(v))).pack()
        tk.Scale(rev, from_=0.0, to=1.0, resolution=0.05,
                 orient=tk.HORIZONTAL, label="wet",
                 command=lambda v: _set_reverb("wet", float(v))).pack()

        lim = ttk.LabelFrame(panel, text="limiter")
        lim.pack(side=tk.LEFT, padx=4)
        self.limiter_var = tk.BooleanVar(value=False)

        def _set_limiter(field, value):
            setattr(self.ctrl.limiter, field, value)
            self.ctrl.apply_reverb()
        ttk.Checkbutton(lim, text="enabled", variable=self.limiter_var,
                        command=lambda: _set_limiter(
                            "enabled", self.limiter_var.get())).pack()
        tk.Scale(lim, from_=-24.0, to=0.0, resolution=0.5,
                 orient=tk.HORIZONTAL, label="ceiling dB",
                 command=lambda v: _set_limiter("ceiling_db",
                                                float(v))).pack()
        ttk.Button(echo, text="save preset", command=self._save).pack()
        ttk.Button(echo, text="load preset", command=self._load).pack()
        ttk.Button(echo, text="sampler wav", command=self._load_sampler).pack()
        ttk.Button(echo, text="synth mode",
                   command=self.ctrl.clear_sampler).pack()

        self.canvas = tk.Canvas(self.root, width=840, height=120, bg="white")
        self.canvas.pack(side=tk.BOTTOM)
        self._draw_keys()
        self.root.bind("<KeyPress>", self._on_key_down)
        self.root.bind("<KeyRelease>", self._on_key_up)

    def _set(self, i, attr, value):
        setattr(self.ctrl.oscs[i], attr, value)

    def _draw_keys(self):
        for i in range(24):
            x = i * 35
            self.canvas.create_rectangle(x, 0, x + 35, 120, fill="white",
                                         outline="black", tags=f"key{FIRST_KEY+i}")

    def _on_key_down(self, ev):
        idx = KEYBOARD_KEYS.find(ev.char)
        if idx >= 0:
            self.ctrl.key_down(FIRST_KEY + idx)

    def _on_key_up(self, ev):
        idx = KEYBOARD_KEYS.find(ev.char)
        if idx >= 0:
            self.ctrl.key_up(FIRST_KEY + idx)

    def _load_sampler(self):
        path = self.filedialog.askopenfilename(
            filetypes=[("WAV files", "*.wav")])
        if path:
            self.ctrl.load_sampler(path)

    def _save(self):
        path = self.filedialog.asksaveasfilename(defaultextension=".ini")
        if path:
            self.ctrl.save_preset(path)

    def _load(self):
        path = self.filedialog.askopenfilename()
        if path:
            self.ctrl.load_preset(path)
            for var, s in zip(self.wave_vars, self.ctrl.oscs):
                var.set(s.waveform)

    def run(self):
        try:
            self.root.mainloop()
        finally:
            self.output.close()


def main(argv=None) -> None:
    import argparse
    ap = argparse.ArgumentParser(description="piano-keyboard synthesizer")
    ap.add_argument("--device", default="cuda",
                    help="torch device to render on (default: cuda)")
    SynthGUI(device=ap.parse_args(argv).device).run()


if __name__ == "__main__":
    main()
