"""General MIDI files, rendered by ``synthesizer_tpu_torch.midi.
render_midi``."""

from __future__ import annotations

import importlib
import math

import numpy as np

from ..harness import roofline
from ..reference import midi as ref

SR = ref.SR


class MidiKind:
    """A pool of distinct GM files made from the seed in set-up (the
    traffic's ``pool`` of them, ``notes`` notes over ``seconds``); jobs
    take them in turn."""

    #: where the program renders (the harness's tests set the CPU)
    device = "cuda"

    def __init__(self, run):
        self.run = run
        p = run.params
        s = run.seed
        # the file generator of ``inputs/`` that the configuration names
        gm = importlib.import_module(
            f"benchmark.inputs.{run.config['generator']}")
        self.files = [gm.gm_file(p["notes"], p["seconds"],
                                 [s & 0xFFFFFFFF, s >> 32, 5, i])
                      for i in range(p["pool"])]
        self.shapes = len(self.files)
        #: no device program is keyed by the file: one job loads the
        #: kernel library and sizes the allocator
        self.warm_shapes = 1
        self.keep_first = 0

    def job(self, stream: int, j: int) -> bytes:
        return self.files[j % len(self.files)]

    def render(self, data: bytes) -> np.ndarray:
        """One job: ``render_midi``, the int16 frames on the host; in a
        traced run its steps one by one, each in a span of its own."""
        if self.run.trace:
            return self.render_steps(data)
        from synthesizer_tpu_torch.midi import render_midi
        with self.run.span("midi.render_midi"):
            out = render_midi(data, device=self.device)
        with self.run.span("sample.to_host"):
            return np.array(out.get_frame_array())

    def render_steps(self, data: bytes) -> np.ndarray:
        """``render_midi``'s steps (``render_notes``' sparse route, or
        its flat route where the plan declines)."""
        from synthesizer_tpu_torch import midi as M
        from synthesizer_tpu_torch.models.voicebank import (VoiceBank,
                                                            pack_voices)
        from synthesizer_tpu_torch.sample import Sample
        span, dev = self.run.span, self.device
        with span("midi.parse"):
            notes = M.parse_midi(data, release_grace=M.release_grace_for(None))
            voices = M.midi_to_voices(notes)
        total = M.song_frames(voices, SR)
        with span("voicebank.pack"):
            vp = pack_voices(voices, SR, num_harmonics=8, device=dev)
            V = int(vp.start.shape[0])
            bank = VoiceBank.for_voices(voices, SR, num_harmonics=8,
                                        nvoices=V, device=dev)
            plan = bank.sparse_plan(vp, total,
                                    ranges=M.note_ranges(voices, V, SR))
            if plan is None:
                vp, layout = pack_voices(voices, SR, num_harmonics=8,
                                         sort_by_wave=True, device=dev)
                bank = VoiceBank.for_voices(voices, SR, num_harmonics=8,
                                            layout=layout,
                                            nvoices=layout.nvoices,
                                            device=dev)
        with span("voicebank.render"):
            if plan is not None:
                fn, idx, pad, nchunks = plan
                f32 = fn(vp, idx, pad, nchunks)[:total]
            else:
                f32 = bank.render_song(vp, total)
            out = Sample.from_torch(VoiceBank.to_int16(f32), SR, 2)
        with span("sample.to_host"):
            return np.array(out.get_frame_array())

    def after_window(self) -> None:
        """A traced run's steps against ``render_midi`` on one file, bit
        for bit."""
        if not self.run.trace:
            return
        from synthesizer_tpu_torch.midi import render_midi
        data = self.files[0]
        whole = np.array(render_midi(data, device=self.device)
                         .get_frame_array())
        steps = self.render_steps(data)
        same = whole.shape == steps.shape and np.array_equal(whole, steps)
        self.run.check("steps_differ_from_render_midi", 0 if same else 1, 0)

    def reference(self, data: bytes, control: bool = False):
        """The reference's render, or for the check (not ``control``) the
        (lowest, highest) renders it allows."""
        if control:
            return ref.render(data, control=True)
        return ref.render(data, spread=True)

    def bound(self, data: bytes, total: int) -> float:
        """Seconds the render kernels need at least for the file's voices,
        from the reference's voice list."""
        vs = ref.voices(ref.parse(data))
        ops = 0
        for v in vs:
            s0 = int(v["start"] * SR)
            gate = int(v["duration"] * SR) / SR
            end = v["attack"] + v["decay"] + max(
                gate - v["attack"] - v["decay"], 0.0) + v["release"]
            audible = min(total, s0 + math.ceil(end * SR)) - s0
            partials = sum(1 for a in v["harmonics"][:8] if a) or 1
            ops += roofline.voice_ops(
                v["wave"], audible, partials,
                fm=bool(v["fm_depth"] or v["depth_curve"]),
                bend=bool(v["pitch_curve"]), amp=bool(v["amp_curve"]),
                dmod=bool(v["depth_curve"]))
        nbytes = total * 8 + len(vs) * roofline.VOICE_BYTES
        return roofline.bound_seconds(ops, nbytes)


make = MidiKind
