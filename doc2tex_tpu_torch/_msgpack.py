"""Pure-Python reader for flax msgpack checkpoints.

flax (``flax.serialization.msgpack_serialize``) writes a msgpack map whose
array leaves are msgpack *ext* objects: code 1 holds an ndarray, code 3 a
numpy scalar, and the ext payload is itself a packed ``(shape, dtype name,
raw C-order bytes)`` triple.  This module decodes exactly that: maps,
arrays, strings, binaries, numbers, nil/bools, and those two ext codes.
Any other ext code raises.  Array leaves are ``np.frombuffer`` views into
the file's bytes (no copy).
"""

from __future__ import annotations

import struct

import numpy as np

_EXT_NDARRAY = 1
_EXT_NPSCALAR = 3


class _Reader:
    def __init__(self, buf):
        self.buf = buf
        self.pos = 0

    def take(self, n: int) -> int:
        start = self.pos
        self.pos += n
        if self.pos > len(self.buf):
            raise ValueError("truncated msgpack data")
        return start

    def unpack(self, fmt: str):
        size = struct.calcsize(fmt)
        return struct.unpack_from(fmt, self.buf, self.take(size))[0]

    def obj(self):
        b = self.buf[self.take(1)]
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
        if b == 0xC0:
            return None
        if b == 0xC2:
            return False
        if b == 0xC3:
            return True
        if b in (0xC4, 0xC5, 0xC6):
            n = self.unpack({0xC4: ">B", 0xC5: ">H", 0xC6: ">I"}[b])
            start = self.take(n)
            return self.buf[start : start + n]
        if b in (0xC7, 0xC8, 0xC9):
            n = self.unpack({0xC7: ">B", 0xC8: ">H", 0xC9: ">I"}[b])
            return self.ext(n)
        if b == 0xCA:
            return self.unpack(">f")
        if b == 0xCB:
            return self.unpack(">d")
        if 0xCC <= b <= 0xD3:
            fmt = {0xCC: ">B", 0xCD: ">H", 0xCE: ">I", 0xCF: ">Q",
                   0xD0: ">b", 0xD1: ">h", 0xD2: ">i", 0xD3: ">q"}[b]
            return self.unpack(fmt)
        if 0xD4 <= b <= 0xD8:
            return self.ext(1 << (b - 0xD4))
        if b in (0xD9, 0xDA, 0xDB):
            return self.str(self.unpack({0xD9: ">B", 0xDA: ">H", 0xDB: ">I"}[b]))
        if b in (0xDC, 0xDD):
            return self.array(self.unpack(">H" if b == 0xDC else ">I"))
        if b in (0xDE, 0xDF):
            return self.map(self.unpack(">H" if b == 0xDE else ">I"))
        raise ValueError(f"unsupported msgpack type byte 0x{b:02x}")

    def str(self, n: int) -> str:
        start = self.take(n)
        return bytes(self.buf[start : start + n]).decode("utf-8")

    def array(self, n: int) -> list:
        return [self.obj() for _ in range(n)]

    def map(self, n: int) -> dict:
        out = {}
        for _ in range(n):
            key = self.obj()
            out[key] = self.obj()
        if "__msgpack_chunked_array__" in out:
            raise ValueError("chunked flax arrays are not supported")
        return out

    def ext(self, n: int):
        code = self.unpack(">b")
        start = self.take(n)
        if code not in (_EXT_NDARRAY, _EXT_NPSCALAR):
            raise ValueError(f"unknown msgpack ext code {code}")
        inner = _Reader(self.buf[start : start + n])
        shape, dtype_name, data = inner.obj()
        if inner.pos != n:
            raise ValueError("malformed flax ndarray ext payload")
        if isinstance(dtype_name, (bytes, memoryview)):
            dtype_name = bytes(dtype_name).decode("ascii")
        arr = np.frombuffer(data, dtype=np.dtype(dtype_name)).reshape(shape)
        return arr[()] if code == _EXT_NPSCALAR else arr


def unpackb(data) -> object:
    """Decode one msgpack object from ``data`` (bytes-like)."""
    reader = _Reader(memoryview(data))
    out = reader.obj()
    if reader.pos != len(reader.buf):
        raise ValueError("trailing bytes after msgpack object")
    return out


def load(path: str) -> dict:
    """Read a flax msgpack checkpoint into nested dicts of numpy arrays."""
    with open(path, "rb") as f:
        data = f.read()
    return unpackb(data)
