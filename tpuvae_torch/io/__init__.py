"""Host I/O: WAV decoding and the preprocessing normalizers."""
