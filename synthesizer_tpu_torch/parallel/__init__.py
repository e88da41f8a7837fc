"""Multi-device scaling: voice-axis sharding over a list of devices."""

from .mesh import VoiceMesh, render_song_sharded, voice_mesh  # noqa: F401
