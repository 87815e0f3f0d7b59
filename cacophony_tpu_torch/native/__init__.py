"""Host audio decode: a C++ WAV / FLAC decoder loaded with ctypes."""
