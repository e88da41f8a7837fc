"""Host-side DDS helpers (copied from ``synthesizer_tpu.models.spec``).

Exact Python integer arithmetic: the 32-bit fixed-point phase contract
every render path shares.
"""

from __future__ import annotations


def phase_increment(frequency: float, samplerate: int) -> int:
    """Exact host-side DDS increment: round(freq/sr * 2**32), wrapped u32."""
    return int(round(frequency / samplerate * 4294967296.0)) & 0xFFFFFFFF


def phase_offset(phase_turns: float) -> int:
    return int(round((phase_turns % 1.0) * 4294967296.0)) & 0xFFFFFFFF
