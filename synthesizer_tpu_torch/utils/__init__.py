"""Host-side utilities: WAV I/O, the codecs, the native libraries, where
tensors live."""
