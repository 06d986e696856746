"""A frozen copy of the port's pure-Python reader of compact checkpoints
(``export_compact``: one msgpack document ``{"params", "batch_stats",
"meta"}`` whose array leaves are flax's ext type 1, float leaves stored as
f16 and widened to f32 here). The harness reads the checkpoint once with it
and hands the same arrays to the program and to the reference.
"""

from __future__ import annotations

import pathlib
import struct

import numpy as np

_EXT_NDARRAY, _EXT_COMPLEX, _EXT_NPSCALAR = 1, 2, 3


class _Reader:
    def __init__(self, buf: bytes):
        self.buf = memoryview(buf)
        self.pos = 0
        u = self.unpack
        self.dispatch = {
            0xC0: lambda: None,
            0xC2: lambda: False,
            0xC3: lambda: True,
            0xC4: lambda: bytes(self.take(u(">B"))),
            0xC5: lambda: bytes(self.take(u(">H"))),
            0xC6: lambda: bytes(self.take(u(">I"))),
            0xC7: lambda: self.ext(u(">B")),
            0xC8: lambda: self.ext(u(">H")),
            0xC9: lambda: self.ext(u(">I")),
            0xCA: lambda: u(">f"),
            0xCB: lambda: u(">d"),
            0xCC: lambda: u(">B"),
            0xCD: lambda: u(">H"),
            0xCE: lambda: u(">I"),
            0xCF: lambda: u(">Q"),
            0xD0: lambda: u(">b"),
            0xD1: lambda: u(">h"),
            0xD2: lambda: u(">i"),
            0xD3: lambda: u(">q"),
            0xD4: lambda: self.ext(1),
            0xD5: lambda: self.ext(2),
            0xD6: lambda: self.ext(4),
            0xD7: lambda: self.ext(8),
            0xD8: lambda: self.ext(16),
            0xD9: lambda: self.str(u(">B")),
            0xDA: lambda: self.str(u(">H")),
            0xDB: lambda: self.str(u(">I")),
            0xDC: lambda: self.array(u(">H")),
            0xDD: lambda: self.array(u(">I")),
            0xDE: lambda: self.map(u(">H")),
            0xDF: lambda: self.map(u(">I")),
        }

    def take(self, n: int) -> memoryview:
        if self.pos + n > len(self.buf):
            raise ValueError("truncated msgpack document")
        out = self.buf[self.pos:self.pos + n]
        self.pos += n
        return out

    def unpack(self, fmt: str):
        return struct.unpack(fmt, self.take(struct.calcsize(fmt)))[0]

    def obj(self):
        b = self.take(1)[0]
        if b <= 0x7F:
            return b
        if b >= 0xE0:
            return b - 0x100
        if 0x80 <= b <= 0x8F:
            return self.map(b & 0x0F)
        if 0x90 <= b <= 0x9F:
            return self.array(b & 0x0F)
        if 0xA0 <= b <= 0xBF:
            return self.str(b & 0x1F)
        if b not in self.dispatch:
            raise ValueError(f"unsupported msgpack type byte 0x{b:02x}")
        return self.dispatch[b]()

    def str(self, n: int) -> str:
        return bytes(self.take(n)).decode("utf-8")

    def array(self, n: int) -> list:
        return [self.obj() for _ in range(n)]

    def map(self, n: int) -> dict:
        out = {}
        for _ in range(n):
            key = self.obj()
            out[key] = self.obj()
        return out

    def ext(self, n: int):
        code = self.unpack(">b")
        data = bytes(self.take(n))
        if code in (_EXT_NDARRAY, _EXT_NPSCALAR):
            arr = _ndarray_from_bytes(data)
            return arr if code == _EXT_NDARRAY else arr[()]
        if code == _EXT_COMPLEX:
            re, im = unpackb(data)
            return complex(re, im)
        raise ValueError(f"unsupported msgpack ext type {code}")


def _ndarray_from_bytes(data: bytes) -> np.ndarray:
    shape, dtype_name, buffer = unpackb(data)
    if isinstance(dtype_name, bytes):
        dtype_name = dtype_name.decode()
    if dtype_name == "bfloat16":  # numpy has no bf16: widen bit-exactly
        bits = np.frombuffer(buffer, np.uint16).astype(np.uint32) << 16
        return bits.view(np.float32).reshape(shape)
    return np.frombuffer(buffer, np.dtype(dtype_name)).reshape(shape)


def _unchunk(tree):
    """flax splits arrays over 1 GiB into ``__msgpack_chunked_array__`` maps."""
    if isinstance(tree, dict):
        if "__msgpack_chunked_array__" in tree:
            shape = tuple(tree["shape"][str(i)] for i in range(len(tree["shape"])))
            chunks = [tree["chunks"][str(i)] for i in range(len(tree["chunks"]))]
            return np.concatenate(chunks).reshape(shape)
        return {k: _unchunk(v) for k, v in tree.items()}
    return tree


def unpackb(buf: bytes):
    """Decode one msgpack document (the subset flax writes)."""
    reader = _Reader(buf)
    out = reader.obj()
    if reader.pos != len(reader.buf):
        raise ValueError("trailing bytes after msgpack document")
    return _unchunk(out)


def _widen(tree):
    if isinstance(tree, dict):
        return {k: _widen(v) for k, v in tree.items()}
    x = np.asarray(tree)
    return x.astype(np.float32) if x.dtype == np.float16 else x


def load_compact(path: str | pathlib.Path) -> tuple[dict, dict, dict]:
    """Read an ``export_compact`` file -> (params, batch_stats, meta), float
    leaves widened to f32, the same trees as the JAX package's loader."""
    payload = unpackb(pathlib.Path(path).read_bytes())
    return (
        _widen(payload["params"]),
        _widen(payload["batch_stats"]),
        payload.get("meta", {}),
    )
