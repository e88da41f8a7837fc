"""Synthesis models: the DDS host helpers and the batched voice-bank
render engine."""
