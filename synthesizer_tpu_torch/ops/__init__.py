"""Device-side ops: turn-unit trig and the fused voice-bank render kernel."""
