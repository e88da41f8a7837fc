"""The bound of the voice-bank render kernels (``csrc/voicebank_render.cu``
of the port): the larger of the operations on the audible voice-frames at
the card's float32 rate and the bytes read and written once at its memory
rate.  The operation counts per voice-frame are the repository's
(``chip_smoke.py``), counted from the kernel source; they are applied here
to the reference's own voice list, never to what the program packed.
"""

from __future__ import annotations

#: NVIDIA H100 SXM, the data sheet's dense rates at 700 W
HBM_BYTES_S = 3.35e12
F32_OPS_S = 67e12

#: operations on every audible voice-frame: phase, note frame, ADSR, gain
#: and pan sum
OPS_COMMON = 23
#: the FM phase offset
OPS_FM = 32
#: the waveform, by the bank's waveform id (8: per partial of nonzero
#: weight; 12: per sounding partial)
OPS_WAVE = {0: 18, 1: 6, 2: 2, 3: 4, 4: 2, 5: 9, 6: 8, 7: 32, 8: 21, 9: 22,
            10: 38, 11: 12, 12: 32}
#: the curves' closed forms: the bend chirp, the amplitude ramp, the depth
#: curve
OPS_BEND, OPS_AMP, OPS_DMOD = 16, 5, 110
#: the bank's waveform ids
WAVE_IDS = {"sine": 0, "triangle": 1, "square": 2, "sawtooth": 3,
            "pulse": 4, "semicircle": 5, "pointy": 6, "white_noise": 7,
            "harmonics": 8, "sawtooth_bl": 9, "square_bl": 10,
            "wavetable": 11, "pluck": 12}
#: bytes of one voice's parameters read once (an assumption: the 32-bit
#: fields of one voice's row)
VOICE_BYTES = 128


def voice_ops(wave: str, audible_frames: int, partials: int = 1,
              fm: bool = False, bend: bool = False, amp: bool = False,
              dmod: bool = False) -> int:
    """Operations of one voice over its audible frames; ``partials`` is
    the number of sounding partials (harmonics, pluck)."""
    w = WAVE_IDS[wave]
    per = OPS_COMMON + OPS_WAVE[w] * (partials if w in (8, 12) else 1)
    per += OPS_FM if fm else 0
    per += (OPS_BEND if bend else 0) + (OPS_AMP if amp else 0)
    per += OPS_DMOD if dmod else 0
    return per * max(0, int(audible_frames))


def bound_seconds(ops: float, nbytes: float) -> float:
    """The least time the card needs: operations or bytes, the larger."""
    return max(ops / F32_OPS_S, nbytes / HBM_BYTES_S)
