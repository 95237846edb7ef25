"""Host I/O: audio decoding (native C++ loader, WAV, FLAC, MP3), the
synthetic corpus, the preprocessing normalizers and artifacts."""
