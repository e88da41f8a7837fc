"""PyTorch/CUDA port of ``synthesizer_tpu``.

The JAX package stays the reference; this package mirrors its layout
(``models/``, ``ops/``, ``utils/``) and names, so each module sits opposite
the one it is held against.  It imports ``torch`` and numpy and never
``jax`` or ``synthesizer_tpu``.

Ported so far: the voice-bank song mixdown (``models.voicebank``) with
pitch, amplitude and FM-depth curves and the sparse bucketed render; its
fused render as two hand-written Hopper kernels, a per-voice setup and a
render that skips silent voice-tiles and takes the curves and the sparse
rows (``ops.kernels`` and ``csrc/voicebank_render.cu``); the MIDI path
(``midi``: SMF parse and write, GM mapping, ``render_midi``); the
turn-unit trig helpers, ``params``, the ``sequencer.SynthDef`` and WAV
output; and the WaveSynth -> Sample -> WAV path: the patch spec
(``models.spec``), its lowering (``models.graph``), the ``oscillators``,
``WaveSynth`` (``synth``), the PCM primitives (``ops.pcm``) and the
``Sample`` core (``sample``), whose ``get_frame_array`` copies a result to
the host through pinned memory.  Its entry points run on the card unless
the caller passes ``device="cpu"``.
"""

from . import oscillators, params
from .sample import Sample
from .synth import WaveSynth, key_freq, note_freq

__all__ = ["Sample", "WaveSynth", "key_freq", "note_freq", "oscillators",
           "params"]
