"""ctypes bindings for the native WAV / FLAC decoder (wavio.cpp, flacio.cpp).

The port's own copy of cacophony_tpu/native (which it cannot import).  The
library is built with g++ at first use, never at import, into
`cacophony_tpu_torch/_build/` (listed in .gitignore) under a name that
carries a hash of the sources and flags, as ops/_kernels.py builds the CUDA
kernels: an edited source is rebuilt, and concurrent builds each write a
temporary file and rename it.  A failed build raises; nothing catches it.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import subprocess
import tempfile
import threading
from typing import List, Tuple

import numpy as np

_DIR = os.path.dirname(os.path.abspath(__file__))
SOURCES = ("wavio.cpp", "flacio.cpp")
BUILD_DIR = os.path.join(os.path.dirname(_DIR), "_build")
# no -march=native: the library may outlive the build host; decode is IO-bound
CXX_FLAGS = ["-O3", "-std=c++17", "-shared", "-fPIC", "-pthread"]

_lock = threading.Lock()
_lib = None


class NativeBuildError(RuntimeError):
    pass


def library_path() -> str:
    digest = hashlib.sha256(" ".join(CXX_FLAGS).encode())
    for name in SOURCES:
        with open(os.path.join(_DIR, name), "rb") as f:
            digest.update(name.encode() + b"\0" + f.read())
    return os.path.join(BUILD_DIR, f"libcaco_wavio_{digest.hexdigest()[:16]}.so")


def _build(out: str) -> None:
    os.makedirs(BUILD_DIR, exist_ok=True)
    fd, tmp = tempfile.mkstemp(suffix=".so", dir=BUILD_DIR)
    os.close(fd)
    try:
        proc = subprocess.run(["g++", *CXX_FLAGS, *(os.path.join(_DIR, s) for s in SOURCES),
                               "-o", tmp], capture_output=True, text=True)
        if proc.returncode != 0:
            raise NativeBuildError(f"g++ failed ({proc.returncode}):\n{proc.stdout}{proc.stderr}")
        os.replace(tmp, out)
    finally:
        if os.path.exists(tmp):
            os.unlink(tmp)


def load() -> ctypes.CDLL:
    """Build (once per source hash) and load the decoder library."""
    global _lib
    with _lock:
        if _lib is not None:
            return _lib
        path = library_path()
        if not os.path.exists(path):
            _build(path)
        lib = ctypes.CDLL(path)
        lib.cacoph_decode_wav.restype = ctypes.c_int
        lib.cacoph_decode_wav.argtypes = [
            ctypes.c_char_p, ctypes.POINTER(ctypes.POINTER(ctypes.c_float)),
            ctypes.POINTER(ctypes.c_int64), ctypes.POINTER(ctypes.c_int32)]
        lib.cacoph_decode_batch.restype = None
        lib.cacoph_decode_batch.argtypes = [
            ctypes.POINTER(ctypes.c_char_p), ctypes.c_int32,
            ctypes.POINTER(ctypes.c_float), ctypes.c_int64,
            ctypes.POINTER(ctypes.c_int32), ctypes.POINTER(ctypes.c_int32),
            ctypes.POINTER(ctypes.c_int32), ctypes.c_int32]
        lib.cacoph_free.restype = None
        lib.cacoph_free.argtypes = [ctypes.POINTER(ctypes.c_float)]
        _lib = lib
        return lib


def read_wav(path: str) -> Tuple[np.ndarray, int]:
    """→ (float32 mono samples, sample_rate).  Raises ValueError when the
    file cannot be decoded."""
    lib = load()
    data = ctypes.POINTER(ctypes.c_float)()
    n = ctypes.c_int64()
    sr = ctypes.c_int32()
    if not lib.cacoph_decode_wav(path.encode(), ctypes.byref(data),
                                 ctypes.byref(n), ctypes.byref(sr)):
        raise ValueError(f"native wav decode failed: {path}")
    try:
        out = np.ctypeslib.as_array(data, shape=(n.value,)).copy()
    finally:
        lib.cacoph_free(data)
    return out, int(sr.value)


def decode_batch(paths: List[str], buffer_samples: int,
                 num_threads: int = 0) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
    """Thread-pooled batch decode into a fixed buffer at each file's own
    rate → (buffers (n, buffer_samples) f32, lengths (n,) i32, rates (n,)
    i32).  A file that failed has length 0 and rate 0."""
    lib = load()
    n = len(paths)
    out = np.zeros((n, buffer_samples), np.float32)
    lengths = np.zeros(n, np.int32)
    rates = np.zeros(n, np.int32)
    ok = np.zeros(n, np.int32)
    arr = (ctypes.c_char_p * n)(*[p.encode() for p in paths])
    lib.cacoph_decode_batch(
        arr, n, out.ctypes.data_as(ctypes.POINTER(ctypes.c_float)),
        buffer_samples,
        lengths.ctypes.data_as(ctypes.POINTER(ctypes.c_int32)),
        rates.ctypes.data_as(ctypes.POINTER(ctypes.c_int32)),
        ok.ctypes.data_as(ctypes.POINTER(ctypes.c_int32)), num_threads)
    return out, lengths, rates
