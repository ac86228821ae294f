"""PNG bytes -> grayscale uint8, without PIL (the card's machine has none).

The JAX package's HTTP front decodes uploads with PIL's
``Image.open(...).convert("L")``; this gives the same bytes for the PNGs it
covers: non-interlaced, bit depth 8, colour types 0 (gray), 2 (RGB),
3 (palette), 4 (gray + alpha) and 6 (RGBA), any of the five row filters.
Colour becomes ``L = (R*19595 + G*38470 + B*7471 + 0x8000) >> 16``, PIL's
integer luma; alpha (and ``tRNS``) is ignored, as ``convert("L")`` ignores
it.  Anything else raises ``ValueError``.
"""

from __future__ import annotations

import struct
import zlib

import numpy as np

_SIGNATURE = b"\x89PNG\r\n\x1a\n"
_CHANNELS = {0: 1, 2: 3, 3: 1, 4: 2, 6: 4}


def _chunks(data: bytes):
    pos = len(_SIGNATURE)
    while pos + 8 <= len(data):
        length, kind = struct.unpack(">I4s", data[pos:pos + 8])
        body = data[pos + 8:pos + 8 + length]
        if len(body) != length:
            raise ValueError("truncated PNG chunk")
        yield kind, body
        if kind == b"IEND":
            return
        pos += 12 + length
    raise ValueError("PNG has no IEND chunk")


def _paeth(a: int, b: int, c: int) -> int:
    p = a + b - c
    pa, pb, pc = abs(p - a), abs(p - b), abs(p - c)
    if pa <= pb and pa <= pc:
        return a
    return b if pb <= pc else c


def _unfilter(raw: bytes, h: int, stride: int, bpp: int) -> np.ndarray:
    """Undo the per-row filters: (h, stride) uint8 samples."""
    if len(raw) < h * (stride + 1):
        raise ValueError("PNG image data is shorter than its header says")
    out = np.zeros((h, stride), np.uint8)
    prev = np.zeros(stride, np.uint8)
    for y in range(h):
        start = y * (stride + 1)
        kind = raw[start]
        line = np.frombuffer(raw, np.uint8, stride, start + 1).copy()
        if kind == 1:      # Sub: a running sum along the row, per byte of a pixel
            line = (np.cumsum(line.reshape(-1, bpp).astype(np.int64), axis=0) % 256
                    ).astype(np.uint8).reshape(-1)
        elif kind == 2:    # Up
            line = line + prev
        elif kind in (3, 4):
            cur, up = bytearray(line.tobytes()), prev.tobytes()
            for i in range(stride):
                a = cur[i - bpp] if i >= bpp else 0
                if kind == 3:  # Average
                    cur[i] = (cur[i] + ((a + up[i]) >> 1)) & 255
                else:          # Paeth
                    c = up[i - bpp] if i >= bpp else 0
                    cur[i] = (cur[i] + _paeth(a, up[i], c)) & 255
            line = np.frombuffer(bytes(cur), np.uint8)
        elif kind != 0:
            raise ValueError(f"unknown PNG row filter {kind}")
        out[y] = line
        prev = out[y]
    return out


def _luma(rgb: np.ndarray) -> np.ndarray:
    r, g, b = (rgb[..., i].astype(np.uint32) for i in range(3))
    return ((r * 19595 + g * 38470 + b * 7471 + 0x8000) >> 16).astype(np.uint8)


def decode_png(data: bytes) -> np.ndarray:
    """PNG file bytes -> (H, W) uint8, as PIL's ``convert("L")`` gives."""
    if not data.startswith(_SIGNATURE):
        raise ValueError("not a PNG file (only PNG uploads are decoded)")
    header, palette, idat = None, None, []
    for kind, body in _chunks(data):
        if kind == b"IHDR":
            header = struct.unpack(">IIBBBBB", body)
        elif kind == b"PLTE":
            palette = np.frombuffer(body, np.uint8).reshape(-1, 3)
        elif kind == b"IDAT":
            idat.append(body)
    if header is None:
        raise ValueError("PNG has no IHDR chunk")
    w, h, depth, color, _compression, _filter, interlace = header
    if depth != 8 or color not in _CHANNELS or interlace:
        raise ValueError(f"unsupported PNG: bit depth {depth}, colour type {color}, "
                         f"interlace {interlace} (only 8-bit non-interlaced types 0, 2, 3, 4, 6)")
    ch = _CHANNELS[color]
    pixels = _unfilter(zlib.decompress(b"".join(idat)), h, w * ch, ch).reshape(h, w, ch)
    if color == 0:
        return pixels[..., 0]
    if color == 4:
        return pixels[..., 0].copy()
    if color == 3:
        if palette is None:
            raise ValueError("palette PNG has no PLTE chunk")
        idx = pixels[..., 0]
        if idx.max(initial=0) >= len(palette):
            raise ValueError("palette index out of range")
        return _luma(palette[idx])
    return _luma(pixels)


def encode_png(gray: np.ndarray) -> bytes:
    """(H, W) uint8 -> an 8-bit grayscale PNG, every row unfiltered."""
    gray = np.ascontiguousarray(gray, dtype=np.uint8)
    h, w = gray.shape

    def chunk(kind: bytes, body: bytes) -> bytes:
        return (struct.pack(">I", len(body)) + kind + body
                + struct.pack(">I", zlib.crc32(kind + body) & 0xFFFFFFFF))

    rows = np.concatenate([np.zeros((h, 1), np.uint8), gray], axis=1).tobytes()
    return (_SIGNATURE + chunk(b"IHDR", struct.pack(">IIBBBBB", w, h, 8, 0, 0, 0, 0))
            + chunk(b"IDAT", zlib.compress(rows)) + chunk(b"IEND", b""))
