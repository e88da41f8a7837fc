"""Pattern songs (the trackmixer ``.ini`` format), rendered by
``synthesizer_tpu_torch.sequencer.Song``."""

from __future__ import annotations

import importlib
import math
import os

import numpy as np

from ..harness import roofline
from ..inputs import kit as kitmod
from ..reference import song as ref

SR = ref.SR


class SongKind:
    """A configuration's song and kit: the kit from the seed as WAV files
    under the run's temporary directory, the text of each job."""

    #: where the program renders (the harness's tests set the CPU)
    device = "cuda"

    def __init__(self, run):
        self.run = run
        #: the song's text and its seeded variants: the module of
        #: ``inputs/`` that the configuration names
        self.module = importlib.import_module(
            f"benchmark.inputs.{run.config['song']}")
        self.kitdir = kitmod.write(kitmod.make(run.seed),
                                   os.path.join(run.tmpdir, "kit"))
        #: the song lengths of a render cell, cycled job by job
        self.repeats = run.params.get("repeats", [1])
        self.shapes = len(self.repeats)
        #: each length keys device programs of its own: set-up warms all
        self.warm_shapes = self.shapes
        #: the check compares the first job of each length
        self.keep_first = self.shapes

    def job(self, stream: int, j: int) -> str:
        """Job ``j`` of a render cell: a seeded order at the length its
        turn gives (``stream`` keeps set-up's jobs apart from the
        window's)."""
        s = self.run.seed
        rng = np.random.default_rng([s & 0xFFFFFFFF, s >> 32, stream, j])
        return self.text(rng, self.repeats[j % len(self.repeats)])

    def after_window(self) -> None:
        pass

    def text(self, rng: np.random.Generator = None, k: int = 1) -> str:
        """The song as written (no ``rng``), or a seeded variant of it
        repeated ``k`` times."""
        if rng is None:
            return self.module.TEXT
        return self.module.variant(self.module.pattern_order(rng), k)

    def load(self, text: str):
        from synthesizer_tpu_torch.sequencer import Song
        with self.run.span("sequencer.song_load"):
            return Song.from_string(text, self.kitdir, device=self.device)

    def render(self, text: str) -> np.ndarray:
        """One offline job: load, ``mix()``, the int16 frames on the
        host (a copy the caller owns)."""
        song = self.load(text)
        with self.run.span("sequencer.mix"):
            out = song.mix()
        with self.run.span("sample.to_host"):
            return np.array(out.get_frame_array())

    def reference(self, text: str, control: bool = False,
                  stream: bool = False) -> np.ndarray:
        """The reference's frames of ``Song.mix()``, or with ``stream``
        of ``mix_generator``: ``mix(normalize=False, tail_seconds=0)``."""
        st = ref.SongText(text, self.kitdir, kitmod.read_wav)
        if stream:
            return ref.mix(st, normalize=False, tail_seconds=0.0,
                           control=control)
        return ref.mix(st, control=control)

    def bound(self, text: str, total: int) -> float:
        """Seconds the render kernels need at least for this song's voices
        over ``total`` frames, from the reference's voice list."""
        st = ref.SongText(text, self.kitdir, kitmod.read_wav)
        voices = ref.synth_voices(st)
        ops = 0
        for v in voices:
            s0, *_, end = ref.envelope_times(v)
            audible = min(total, s0 + math.ceil(end * SR)) - max(s0, 0)
            partials = 1
            if v["wave"] == "pluck":
                inc = ref.phase_increment(v["frequency"])
                partials = sum(1 for k in range(1, ref.NUM_HARMONICS + 1)
                               if inc and k * inc < 2 ** 31)
            ops += roofline.voice_ops(v["wave"], audible, partials)
        buses = 1 + len({v["track"] for v in voices} & set(st.track_fx))
        nbytes = total * 8 * buses + len(voices) * roofline.VOICE_BYTES
        return roofline.bound_seconds(ops, nbytes)


def gap(got: np.ndarray, want) -> float:
    """The widest gap in LSB between two int16 renders, or between a
    render and the (lowest, highest) renders ``want`` allows; a render of
    another length is compared over the longer one, the missing frames as
    silence, and counts as no less than 65536."""
    lo, hi = want if isinstance(want, tuple) else (want, want)
    n = max(len(got), len(lo))
    a = np.zeros((n, 2), np.int64)
    b = np.zeros((n, 2), np.int64)
    c = np.zeros((n, 2), np.int64)
    a[:len(got)] = got
    b[:len(lo)] = lo
    c[:len(hi)] = hi
    g = float(np.max(np.maximum(b - a, a - c))) if n else 0.0
    return max(g, 0.0) if len(got) == len(lo) else max(g, 65536.0)


#: the constructor the harness calls
make = SongKind
