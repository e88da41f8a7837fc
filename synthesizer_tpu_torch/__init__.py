"""PyTorch/CUDA port of ``synthesizer_tpu``.

The JAX package stays the reference; this package mirrors its layout
(``models/``, ``ops/``, ``parallel/``, ``utils/``) and names, so each module
sits opposite the one it is held against.  It imports ``torch`` and numpy
and never ``jax`` or ``synthesizer_tpu``.

Everything the JAX package does is ported: the voice-bank song mixdown
(``models.voicebank``, with pitch, amplitude and FM-depth curves, the
sparse bucketed render and the segment buses) and its fused render as two
hand-written Hopper kernels, a per-voice setup and a tiled render
(``ops.kernels`` and ``csrc/voicebank_render.cu``); the MIDI path
(``midi``); the WaveSynth -> Sample -> WAV path (``models.spec``,
``models.graph``, ``oscillators``, ``synth``, ``ops.pcm``, ``sample``);
resampling, effects and loudness (``ops.resample``, ``ops.effects``,
``ops.coeffs``, ``ops.loudness``); the pattern sequencer and its fx rack
(``sequencer``, ``effects``); the realtime layer and the render server
(``streaming``, ``playback``, ``voice``, ``server``, the host codecs in
``utils``); the sharded render over several devices (``parallel.mesh``,
``Song.mix(mesh=)``, ``render_midi(mesh=)``) with its dry run
(``parallel.dryrun``); and the apps (``apps.trackmixer``,
``apps.keyboard_gui``, ``apps.jukebox``).  Its entry points run on the card
unless the caller passes ``device="cpu"``.
"""

__version__ = "0.1.0"

from . import oscillators, params
from .midi import render_midi
from .models.voicebank import Voice, VoiceBank, pack_voices
from .ops.loudness import StreamingLoudness
from .playback import Output, RealTimeMixer
from .sample import LevelMeter, Sample
from .sequencer import Song
from .server import RenderServer
from .streaming import (AudiofileToWavStream, EndlessFramesFilter,
                        SampleStream, StreamMixer, VolumeFilter)
from .synth import WaveSynth, key_freq, note_freq
from .utils.profiling import RenderTimer
from .voice import RealtimeVoice

__all__ = ["AudiofileToWavStream", "EndlessFramesFilter", "LevelMeter",
           "Output", "RealTimeMixer", "RealtimeVoice", "RenderServer",
           "RenderTimer", "Sample", "SampleStream", "Song", "StreamMixer",
           "StreamingLoudness", "Voice", "VoiceBank", "VolumeFilter",
           "WaveSynth", "key_freq", "note_freq", "oscillators", "pack_voices",
           "params", "render_midi"]
