"""Pure-Python reader and writer for flax msgpack checkpoints.

flax (``flax.serialization.msgpack_serialize``) writes a msgpack map whose
array leaves are msgpack *ext* objects: code 1 holds an ndarray, code 3 a
numpy scalar, and the ext payload is itself a packed ``(shape, dtype name,
raw C-order bytes)`` triple.  This module decodes exactly that: maps,
arrays, strings, binaries, numbers, nil/bools, and those two ext codes.
Any other ext code raises.  Array leaves are ``np.frombuffer`` views into
the file's bytes (no copy).

``packb``/``save`` write the same format, byte for byte what
``msgpack_serialize`` writes for a tree of dicts with string keys and
numpy leaves: map keys sorted, as flax's copy of the tree sorts them
(arrays over 1 GiB, which flax splits into chunks, raise).
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


# --- writer ---------------------------------------------------------------

_MAX_ARRAY_BYTES = 2 ** 30   # flax chunks larger arrays; the port never writes one


def _head(out: bytearray, n: int, fix: int, fix_max: int, codes: tuple) -> None:
    """A length-prefixed header: the fix form when ``n <= fix_max``, else the
    8/16/32-bit form among ``codes`` (None where msgpack has no such form)."""
    if n <= fix_max:
        out.append(fix | n)
        return
    for code, fmt, limit in zip(codes, (">B", ">H", ">I"), (0xFF, 0xFFFF, 0xFFFFFFFF)):
        if code is not None and n <= limit:
            out.append(code)
            out += struct.pack(fmt, n)
            return
    raise ValueError(f"msgpack length {n} too large")


def _int(out: bytearray, v: int) -> None:
    if 0 <= v <= 0x7F or -32 <= v < 0:
        out += struct.pack(">b" if v < 0 else ">B", v)
        return
    forms = ((0xCC, ">B", 0, 0xFF), (0xCD, ">H", 0, 0xFFFF), (0xCE, ">I", 0, 0xFFFFFFFF),
             (0xCF, ">Q", 0, 2 ** 64 - 1)) if v > 0 else \
            ((0xD0, ">b", -128, 127), (0xD1, ">h", -2 ** 15, 2 ** 15 - 1),
             (0xD2, ">i", -2 ** 31, 2 ** 31 - 1), (0xD3, ">q", -2 ** 63, 2 ** 63 - 1))
    for code, fmt, lo, hi in forms:
        if lo <= v <= hi:
            out.append(code)
            out += struct.pack(fmt, v)
            return
    raise ValueError(f"integer {v} out of msgpack range")


def _ext(out: bytearray, code: int, payload: bytes) -> None:
    n = len(payload)
    if n in (1, 2, 4, 8, 16):
        out.append(0xD4 + n.bit_length() - 1)
    else:
        _head(out, n, 0, -1, (0xC7, 0xC8, 0xC9))
    out += struct.pack(">b", code)
    out += payload


def _ndarray_payload(arr: np.ndarray) -> bytes:
    if arr.dtype.hasobject or arr.dtype.isalignedstruct:
        raise ValueError(f"cannot serialize dtype {arr.dtype}")
    if arr.nbytes > _MAX_ARRAY_BYTES:
        raise ValueError(f"array of {arr.nbytes} bytes: flax would chunk it")
    return packb((arr.shape, arr.dtype.name, np.ascontiguousarray(arr).tobytes()))


def _pack(out: bytearray, obj) -> None:
    if obj is None:
        out.append(0xC0)
    elif obj is True or obj is False:
        out.append(0xC3 if obj else 0xC2)
    elif isinstance(obj, np.ndarray):
        _ext(out, _EXT_NDARRAY, _ndarray_payload(obj))
    elif isinstance(obj, np.generic):
        _ext(out, _EXT_NPSCALAR, _ndarray_payload(np.asarray(obj)))
    elif isinstance(obj, int):
        _int(out, obj)
    elif isinstance(obj, float):
        out.append(0xCB)
        out += struct.pack(">d", obj)
    elif isinstance(obj, str):
        data = obj.encode("utf-8")
        _head(out, len(data), 0xA0, 31, (0xD9, 0xDA, 0xDB))
        out += data
    elif isinstance(obj, (bytes, bytearray, memoryview)):
        data = bytes(obj)
        _head(out, len(data), 0, -1, (0xC4, 0xC5, 0xC6))
        out += data
    elif isinstance(obj, (list, tuple)):
        _head(out, len(obj), 0x90, 15, (None, 0xDC, 0xDD))
        for item in obj:
            _pack(out, item)
    elif isinstance(obj, dict):
        _head(out, len(obj), 0x80, 15, (None, 0xDE, 0xDF))
        for key in sorted(obj):   # flax's copy of the tree sorts dict keys
            _pack(out, key)
            _pack(out, obj[key])
    else:
        raise TypeError(f"cannot serialize {type(obj).__name__}")


def packb(obj) -> bytes:
    """Encode ``obj`` (dicts, lists/tuples, str, bytes, int, float, bool,
    None, numpy arrays and scalars) as flax does."""
    out = bytearray()
    _pack(out, obj)
    return bytes(out)


def save(path: str, tree: dict) -> None:
    """Write ``tree`` as a flax msgpack checkpoint."""
    with open(path, "wb") as f:
        f.write(packb(tree))
