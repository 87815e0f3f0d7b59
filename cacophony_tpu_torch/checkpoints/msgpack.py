"""Flax's msgpack checkpoint format, read and written in plain Python.

The released Cacophony checkpoints are legacy Flax checkpoints: one file,
`checkpoint_<N>`, holding `flax.serialization.msgpack_serialize` of the
state tree.  The port reads and writes that format itself (no `msgpack`,
no flax), so the card's machine can load a released file and write one.

The format (flax/serialization.py):
- a msgpack document of nested maps with str keys (flax writes every dict
  key as str: the released state is `state["0"]["params"]`);
- an array leaf is ext type 1 whose payload is a second msgpack document,
  the array `(shape, dtype name, raw C-order bytes)`; ext 2 is a complex
  `(real, imag)`; ext 3 a numpy scalar, encoded as a 0-d array;
- an array larger than MAX_CHUNK_SIZE bytes is a map
  `{"__msgpack_chunked_array__": True, "shape": {"0": d0, ...},
  "chunks": {"0": flat chunk, ...}}`.

Arrays come back as read-only numpy views of the file's bytes (no copy per
element); numpy has no bfloat16, so a bfloat16 array comes back as a
`torch.bfloat16` tensor.  Lengths are decoded with `struct.unpack_from` and
the buffer is sliced, so a 1.16-GB file reads in about the time the disk
takes.  The writer streams each array's bytes to the file after its
headers, encoding every value as the `msgpack` package does (smallest
integer and length forms, float64 for Python floats), so its files are
byte for byte what flax writes.
"""

from __future__ import annotations

import os
import re
import struct
from typing import Any, BinaryIO, Optional

import numpy as np
import torch

EXT_NDARRAY, EXT_COMPLEX, EXT_NPSCALAR = 1, 2, 3
CHUNKED = "__msgpack_chunked_array__"
MAX_CHUNK_SIZE = 2 ** 30  # flax.serialization.MAX_CHUNK_SIZE


class MsgpackError(ValueError):
    pass


# ------------------------------------------------------------------- reader

_FIXED = {  # type byte → (struct format, size) of the value that follows
    0xCA: (">f", 4), 0xCB: (">d", 8),
    0xCC: (">B", 1), 0xCD: (">H", 2), 0xCE: (">I", 4), 0xCF: (">Q", 8),
    0xD0: (">b", 1), 0xD1: (">h", 2), 0xD2: (">i", 4), 0xD3: (">q", 8),
}
_LEN = {1: ">B", 2: ">H", 4: ">I"}
_FIXEXT = {0xD4: 1, 0xD5: 2, 0xD6: 4, 0xD7: 8, 0xD8: 16}


class _Reader:
    """Recursive-descent decoder over a memoryview.  `top` says whether a
    bin value is returned as bytes (the outer document, as msgpack does)
    or as a memoryview slice (inside an array payload: no copy)."""

    def __init__(self, buf: memoryview, top: bool):
        self.buf, self.pos, self.top = buf, 0, top

    def _take(self, n: int) -> memoryview:
        start = self.pos
        if start + n > len(self.buf):
            raise MsgpackError(f"truncated document: {n} bytes at {start} past {len(self.buf)}")
        self.pos = start + n
        return self.buf[start:start + n]

    def _unpack(self, fmt: str, size: int):
        if self.pos + size > len(self.buf):
            raise MsgpackError(f"truncated document at {self.pos}")
        (v,) = struct.unpack_from(fmt, self.buf, self.pos)
        self.pos += size
        return v

    def _length(self, size: int) -> int:
        return self._unpack(_LEN[size], size)

    def value(self) -> Any:
        t = self._unpack(">B", 1)
        if t <= 0x7F:
            return t
        if t >= 0xE0:
            return t - 0x100
        if 0x80 <= t <= 0x8F:
            return self._map(t & 0x0F)
        if 0x90 <= t <= 0x9F:
            return self._array(t & 0x0F)
        if 0xA0 <= t <= 0xBF:
            return self._str(t & 0x1F)
        if t == 0xC0:
            return None
        if t == 0xC2:
            return False
        if t == 0xC3:
            return True
        if t in _FIXED:
            return self._unpack(*_FIXED[t])
        if 0xC4 <= t <= 0xC6:  # bin 8/16/32
            data = self._take(self._length(1 << (t - 0xC4)))
            return bytes(data) if self.top else data
        if 0xC7 <= t <= 0xC9:  # ext 8/16/32
            n = self._length(1 << (t - 0xC7))
            return self._ext(n)
        if t in _FIXEXT:
            return self._ext(_FIXEXT[t])
        if 0xD9 <= t <= 0xDB:  # str 8/16/32
            return self._str(self._length(1 << (t - 0xD9)))
        if t in (0xDC, 0xDD):
            return self._array(self._length(2 if t == 0xDC else 4))
        if t in (0xDE, 0xDF):
            return self._map(self._length(2 if t == 0xDE else 4))
        raise MsgpackError(f"unknown msgpack type byte 0x{t:02x} at {self.pos - 1}")

    def _str(self, n: int) -> str:
        return str(self._take(n), "utf-8")

    def _array(self, n: int) -> list:
        return [self.value() for _ in range(n)]

    def _map(self, n: int) -> dict:
        out = {}
        for _ in range(n):
            key = self.value()
            out[key] = self.value()
        return out

    def _ext(self, n: int) -> Any:
        code = self._unpack(">b", 1)
        payload = self._take(n)
        if code == EXT_NDARRAY:
            return _array_from_payload(payload)
        if code == EXT_NPSCALAR:
            arr = _array_from_payload(payload)
            return arr[()] if isinstance(arr, np.ndarray) else arr.reshape(())
        if code == EXT_COMPLEX:
            re_, im = _Reader(payload, top=False).value()
            return complex(re_, im)
        raise MsgpackError(f"unknown ext type {code}")


def _array_from_payload(payload: memoryview):
    shape, name, data = _Reader(payload, top=False).value()
    shape = tuple(int(d) for d in shape)
    if name == "bfloat16":
        if len(data) == 0:
            return torch.empty(shape, dtype=torch.bfloat16)
        return torch.frombuffer(bytearray(data), dtype=torch.bfloat16).reshape(shape)
    return np.frombuffer(data, dtype=np.dtype(name)).reshape(shape)


def _unchunk(tree):
    """Chunked-array maps → arrays, everywhere in the tree."""
    if not isinstance(tree, dict):
        return tree
    if CHUNKED in tree:
        shape = tuple(tree["shape"][str(i)] for i in range(len(tree["shape"])))
        chunks = [tree["chunks"][str(i)] for i in range(len(tree["chunks"]))]
        if isinstance(chunks[0], torch.Tensor):
            return torch.cat(chunks).reshape(shape)
        return np.concatenate(chunks).reshape(shape)
    return {k: _unchunk(v) for k, v in tree.items()}


def loads(data) -> Any:
    """A msgpack document (bytes-like) → the tree it encodes, with arrays
    restored (the counterpart of `flax.serialization.msgpack_restore`)."""
    reader = _Reader(memoryview(data).cast("B"), top=True)
    tree = reader.value()
    if reader.pos != len(reader.buf):
        raise MsgpackError(f"{len(reader.buf) - reader.pos} bytes after the document")
    return _unchunk(tree)


def latest_checkpoint(ckpt_dir: str) -> Optional[str]:
    """The `checkpoint_<N>` entry of `ckpt_dir` with the largest N, or None."""
    steps = [(float(m.group(1)), name) for name in os.listdir(ckpt_dir)
             if (m := re.fullmatch(r"checkpoint_(-?\d+(?:\.\d+)?)", name))]
    return os.path.join(ckpt_dir, max(steps)[1]) if steps else None


def restore_checkpoint(path: str, target=None):
    """`flax.training.checkpoints.restore_checkpoint(path, target=None)` for
    legacy msgpack checkpoints: a file is read as it is, a directory is
    resolved to its newest `checkpoint_<N>`.  Returns `target` when there
    is nothing to read, as flax does."""
    path = os.fspath(path)
    if not os.path.exists(path):
        return target
    if os.path.isdir(path):
        found = latest_checkpoint(path)
        if found is None:
            return target
        path = found
    if os.path.isdir(path):
        raise MsgpackError(f"{path} is a directory (an orbax checkpoint?); the port reads "
                           "only Flax's single-file msgpack checkpoints")
    with open(path, "rb") as f:
        return loads(f.read())


# ------------------------------------------------------------------- writer

def _uint_header(n: int, small: Optional[int], codes) -> bytes:
    """Length header: fix form below `small`, then 8/16/32-bit forms."""
    if small is not None and n < small:
        return bytes([codes[0] | n])
    for code, fmt, limit in zip(codes[1:], (">B", ">H", ">I"), (0xFF, 0xFFFF, 0xFFFFFFFF)):
        if code is not None and n <= limit:
            return bytes([code]) + struct.pack(fmt, n)
    raise MsgpackError(f"length {n} too large for msgpack")


def _int(v: int) -> bytes:
    if 0 <= v < 0x80:
        return bytes([v])
    if -32 <= v < 0:
        return struct.pack(">b", v)
    if v >= 0:
        for code, fmt, limit in ((0xCC, ">B", 0xFF), (0xCD, ">H", 0xFFFF),
                                 (0xCE, ">I", 0xFFFFFFFF), (0xCF, ">Q", 0xFFFFFFFFFFFFFFFF)):
            if v <= limit:
                return bytes([code]) + struct.pack(fmt, v)
    else:
        for code, fmt, limit in ((0xD0, ">b", 0x80), (0xD1, ">h", 0x8000),
                                 (0xD2, ">i", 0x80000000), (0xD3, ">q", 0x8000000000000000)):
            if v >= -limit:
                return bytes([code]) + struct.pack(fmt, v)
    raise MsgpackError(f"integer {v} out of msgpack's range")


def _str_bytes(s: str) -> bytes:
    data = s.encode("utf-8")
    return _uint_header(len(data), 32, (0xA0, 0xD9, 0xDA, 0xDB)) + data


def _bin_header(n: int) -> bytes:
    return _uint_header(n, None, (None, 0xC4, 0xC5, 0xC6))


def _ext_header(code: int, n: int) -> bytes:
    fix = {1: 0xD4, 2: 0xD5, 4: 0xD6, 8: 0xD7, 16: 0xD8}
    if n in fix:
        return bytes([fix[n]]) + struct.pack(">b", code)
    return _uint_header(n, None, (None, 0xC7, 0xC8, 0xC9)) + struct.pack(">b", code)


def _as_array(x):
    """An array leaf → (shape, dtype name, C-contiguous buffer)."""
    if isinstance(x, torch.Tensor):
        t = x.detach().cpu().contiguous()
        if t.dtype == torch.bfloat16:
            return tuple(t.shape), "bfloat16", t.view(torch.int16).numpy()
        return tuple(t.shape), np.dtype(t.numpy().dtype).name, t.numpy()
    a = np.asarray(x)
    if not a.flags.c_contiguous:  # (np.ascontiguousarray would make a 0-d array 1-d)
        a = a.copy(order="C")
    if a.dtype.hasobject or a.dtype.fields is not None:
        raise MsgpackError(f"cannot serialise an array of dtype {a.dtype}")
    return a.shape, a.dtype.name, a


def _array_parts(x, code: int = EXT_NDARRAY):
    """An array leaf as ext `code`: (headers, raw bytes written after them)."""
    shape, name, buf = _as_array(x)
    data = memoryview(buf).cast("B") if buf.size else b""
    inner = (bytes([0x93]) + _uint_header(len(shape), 16, (0x90, None, 0xDC, 0xDD))
             + b"".join(_int(int(d)) for d in shape) + _str_bytes(name) + _bin_header(len(data)))
    return _ext_header(code, len(inner) + len(data)) + inner, data


def _nbytes(x) -> int:
    return x.numel() * x.element_size() if isinstance(x, torch.Tensor) else x.nbytes


def _chunk(x):
    """An array above MAX_CHUNK_SIZE → flax's chunked-array map."""
    itemsize = x.element_size() if isinstance(x, torch.Tensor) else x.itemsize
    size = max(1, int(MAX_CHUNK_SIZE / itemsize))
    flat = x.reshape(-1)
    return {CHUNKED: True, "shape": {str(i): int(d) for i, d in enumerate(x.shape)},
            "chunks": {str(j): flat[i:i + size]
                       for j, i in enumerate(range(0, flat.shape[0], size))}}


def _write(f: BinaryIO, x) -> None:
    if isinstance(x, dict):
        f.write(_uint_header(len(x), 16, (0x80, None, 0xDE, 0xDF)))
        for k, v in x.items():
            f.write(_str_bytes(str(k)))
            big = isinstance(v, (np.ndarray, torch.Tensor)) and _nbytes(v) > MAX_CHUNK_SIZE
            _write(f, _chunk(v) if big else v)
    elif isinstance(x, (list, tuple)):
        f.write(_uint_header(len(x), 16, (0x90, None, 0xDC, 0xDD)))
        for v in x:
            _write(f, v)
    elif x is None:
        f.write(b"\xc0")
    elif isinstance(x, bool):
        f.write(b"\xc3" if x else b"\xc2")
    elif isinstance(x, (np.ndarray, torch.Tensor, np.generic)):
        # a numpy scalar is ext 3 around the 0-d array
        header, data = _array_parts(np.asarray(x) if isinstance(x, np.generic) else x,
                                    EXT_NPSCALAR if isinstance(x, np.generic) else EXT_NDARRAY)
        f.write(header)
        f.write(data)
    elif isinstance(x, int):
        f.write(_int(x))
    elif isinstance(x, float):
        f.write(b"\xcb" + struct.pack(">d", x))
    elif isinstance(x, complex):
        payload = b"\x92\xcb" + struct.pack(">d", x.real) + b"\xcb" + struct.pack(">d", x.imag)
        f.write(_ext_header(EXT_COMPLEX, len(payload)) + payload)
    elif isinstance(x, str):
        f.write(_str_bytes(x))
    elif isinstance(x, (bytes, bytearray, memoryview)):
        data = memoryview(x).cast("B")
        f.write(_bin_header(len(data)))
        f.write(data)
    else:
        raise MsgpackError(f"cannot serialise {type(x).__name__}")


def dump(tree, f: BinaryIO) -> None:
    """Write `tree` to the binary file `f` as `flax.serialization.msgpack_serialize` would."""
    _write(f, tree)


def dumps(tree) -> bytes:
    import io

    buf = io.BytesIO()
    dump(tree, buf)
    return buf.getvalue()


def save_checkpoint(ckpt_dir: str, target, step: int) -> str:
    """Write `target` to `ckpt_dir/checkpoint_<step>` in Flax's legacy
    msgpack format, through a temporary file and a rename; an existing
    checkpoint of that step is not overwritten.  → the file's path."""
    os.makedirs(ckpt_dir, exist_ok=True)
    path = os.path.join(ckpt_dir, f"checkpoint_{step}")
    if os.path.exists(path):
        raise FileExistsError(f"{path} exists")
    tmp = os.path.join(ckpt_dir, "checkpoint_tmp")
    with open(tmp, "wb") as f:
        dump(target, f)
    os.replace(tmp, path)
    return path
