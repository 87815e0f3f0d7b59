"""Host audio decode: a C++ WAV / FLAC decoder loaded with ctypes (built
with g++ at first use, not at import)."""
from cacophony_tpu_torch.native import wavio  # noqa: F401
