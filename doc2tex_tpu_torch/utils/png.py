"""PNG bytes <-> uint8 arrays, without PIL (the card's machine has none).

The JAX package decodes PNGs with PIL: ``Image.open(...).convert("L")``
for uploads and crops, ``convert("RGB")`` for an ``rgb`` LMDB store.
``decode_png`` gives the same bytes for every PNG the format allows:
colour types 0 (gray, bit depth 1, 2, 4, 8, 16), 2 (RGB, 8, 16),
3 (palette, 1, 2, 4, 8), 4 (gray + alpha, 8, 16) and 6 (RGBA, 8, 16),
plain or Adam7-interlaced, any of the five row filters (undone by the
native library, ``native.png_unfilter``; ``_unfilter_py`` is its plain
version).  PIL's rules, which the tests hold it to:

- gray below 8 bits scales to 0..255 (1 bit to 0/255, 2 bits times 85,
  4 bits times 17); 16-bit gray is clipped to 255 (PIL's ``I;16`` to ``L``);
  16-bit colour keeps each sample's high byte;
- colour becomes ``L = (R*19595 + G*38470 + B*7471 + 0x8000) >> 16``, PIL's
  integer luma; gray becomes RGB by repeating it;
- alpha and ``tRNS`` are ignored, as ``convert("L")``/``convert("RGB")``
  ignore them.

Anything else raises ``ValueError``.
"""

from __future__ import annotations

import struct
import zlib

import numpy as np

from .. import native

_SIGNATURE = b"\x89PNG\r\n\x1a\n"
_CHANNELS = {0: 1, 2: 3, 3: 1, 4: 2, 6: 4}
_DEPTHS = {0: (1, 2, 4, 8, 16), 2: (8, 16), 3: (1, 2, 4, 8), 4: (8, 16), 6: (8, 16)}
# Adam7 passes: (first column, first row, column step, row step)
_ADAM7 = ((0, 0, 8, 8), (4, 0, 8, 8), (0, 4, 4, 8), (2, 0, 4, 4), (0, 2, 2, 4),
          (1, 0, 2, 2), (0, 1, 1, 2))


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


def _unfilter(raw: bytes, start: int, h: int, stride: int, bpp: int) -> np.ndarray:
    """Undo the per-row filters of ``h`` rows from ``raw[start:]``:
    (h, stride) uint8 bytes."""
    if len(raw) < start + h * (stride + 1):
        raise ValueError("PNG image data is shorter than its header says")
    return native.png_unfilter(raw, start, h, stride, bpp)


def _unfilter_py(raw: bytes, start: int, h: int, stride: int, bpp: int) -> np.ndarray:
    """The plain version of ``_unfilter``, byte after byte in Python."""
    if len(raw) < start + h * (stride + 1):
        raise ValueError("PNG image data is shorter than its header says")
    out = np.zeros((h, stride), np.uint8)
    prev = np.zeros(stride, np.uint8)
    for y in range(h):
        at = start + y * (stride + 1)
        kind = raw[at]
        line = np.frombuffer(raw, np.uint8, stride, at + 1).copy()
        if kind == 1:      # Sub: a running sum along the row, per byte of a pixel
            line = np.pad(line, (0, -stride % bpp))
            line = (np.cumsum(line.reshape(-1, bpp).astype(np.int64), axis=0) % 256
                    ).astype(np.uint8).reshape(-1)[:stride]
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


def _samples(rows: np.ndarray, w: int, ch: int, depth: int) -> np.ndarray:
    """(h, stride) unfiltered bytes -> (h, w, ch) samples (uint8, or
    uint16 at depth 16)."""
    h = rows.shape[0]
    if depth == 16:
        return rows.view(">u2").astype(np.uint16).reshape(h, w, ch)
    if depth < 8:
        bits = np.unpackbits(rows, axis=1)[:, :w * depth].reshape(h, w, depth)
        weights = (1 << np.arange(depth - 1, -1, -1)).astype(np.uint8)
        return (bits * weights).sum(-1, dtype=np.uint8)[..., None]
    return rows.reshape(h, w, ch)


def _pixels(raw: bytes, w: int, h: int, ch: int, depth: int, interlace: int) -> np.ndarray:
    """Decompressed IDAT -> (h, w, ch) samples, plain or Adam7."""
    bpp = max(ch * depth // 8, 1)

    def stride(width):
        return (width * ch * depth + 7) // 8

    if not interlace:
        return _samples(_unfilter(raw, 0, h, stride(w), bpp), w, ch, depth)
    out = np.zeros((h, w, ch), np.uint16 if depth == 16 else np.uint8)
    at = 0
    for x0, y0, dx, dy in _ADAM7:
        pw, ph = max(w - x0 + dx - 1, 0) // dx, max(h - y0 + dy - 1, 0) // dy
        if pw == 0 or ph == 0:      # an empty pass has no bytes at all
            continue
        out[y0::dy, x0::dx] = _samples(_unfilter(raw, at, ph, stride(pw), bpp), pw, ch, depth)
        at += ph * (stride(pw) + 1)
    return out


def _luma(rgb: np.ndarray) -> np.ndarray:
    r, g, b = (rgb[..., i].astype(np.uint32) for i in range(3))
    return ((r * 19595 + g * 38470 + b * 7471 + 0x8000) >> 16).astype(np.uint8)


def decode_png(data: bytes, rgb: bool = False) -> np.ndarray:
    """PNG file bytes -> (H, W) uint8 as PIL's ``convert("L")`` gives, or
    with ``rgb`` (H, W, 3) uint8 as ``convert("RGB")`` gives."""
    if not data.startswith(_SIGNATURE):
        raise ValueError("not a PNG file (only PNG images are decoded)")
    header, palette, idat = None, None, []
    for kind, body in _chunks(data):
        if kind == b"IHDR":
            if len(body) != 13:
                raise ValueError("PNG IHDR chunk is not 13 bytes")
            header = struct.unpack(">IIBBBBB", body)
        elif kind == b"PLTE":
            if len(body) % 3:
                raise ValueError("PNG PLTE chunk is not whole RGB triples")
            palette = np.frombuffer(body, np.uint8).reshape(-1, 3)
        elif kind == b"IDAT":
            idat.append(body)
    if header is None:
        raise ValueError("PNG has no IHDR chunk")
    w, h, depth, color, compression, filter_method, interlace = header
    if (color not in _DEPTHS or depth not in _DEPTHS[color] or compression or filter_method
            or interlace not in (0, 1) or w == 0 or h == 0):
        raise ValueError(f"unsupported PNG: {w}x{h}, bit depth {depth}, colour type {color}, "
                         f"compression {compression}, filter {filter_method}, "
                         f"interlace {interlace}")
    ch = _CHANNELS[color]
    try:
        raw = zlib.decompress(b"".join(idat))
    except zlib.error as e:
        raise ValueError(f"PNG image data does not inflate: {e}") from e
    px = _pixels(raw, w, h, ch, depth, interlace)
    if depth == 16:   # PIL: 16-bit gray clips to 255, 16-bit colour keeps the high byte
        px = (np.minimum(px, 255) if color == 0 else px >> 8).astype(np.uint8)
    elif depth < 8 and color == 0:
        px = px * np.uint8(255 // ((1 << depth) - 1))
    if color == 3:
        if palette is None:
            raise ValueError("palette PNG has no PLTE chunk")
        idx = px[..., 0]
        if idx.max(initial=0) >= len(palette):
            raise ValueError("palette index out of range")
        colour = palette[idx]
    elif color in (2, 6):
        colour = px[..., :3]
    else:   # gray, gray + alpha
        gray = px[..., 0]
        return np.repeat(gray[..., None], 3, axis=-1) if rgb else np.ascontiguousarray(gray)
    return np.ascontiguousarray(colour) if rgb else _luma(colour)


def _filter_rows(rows: np.ndarray, bpp: int) -> np.ndarray:
    """(h, stride) bytes -> (h, 1 + stride) PNG rows, each under the filter
    whose bytes, read as signed, have the least absolute sum (libpng's
    heuristic; PIL's writer also picks per row, so both write mostly
    Paeth rows)."""
    x = rows.astype(np.int16)
    up = np.zeros_like(x)
    up[1:] = x[:-1]
    a, c = np.zeros_like(x), np.zeros_like(x)
    a[:, bpp:], c[:, bpp:] = x[:, :-bpp], up[:, :-bpp]
    p = a + up - c
    pa, pb, pc = np.abs(p - a), np.abs(p - up), np.abs(p - c)
    paeth = np.where((pa <= pb) & (pa <= pc), a, np.where(pb <= pc, up, c))
    cand = ((np.stack([x, x - a, x - up, x - ((a + up) >> 1), x - paeth]) & 255)
            .astype(np.uint8))
    kind = np.abs(cand.view(np.int8).astype(np.int32)).sum(-1).argmin(0)
    return np.concatenate([kind.astype(np.uint8)[:, None],
                           cand[kind, np.arange(len(rows))]], axis=1)


def encode_png(img: np.ndarray) -> bytes:
    """(H, W) uint8 -> an 8-bit grayscale PNG, or (H, W, 3) uint8 -> an
    8-bit RGB PNG; each row under its own filter (``_filter_rows``)."""
    img = np.ascontiguousarray(img, dtype=np.uint8)
    if img.ndim == 3 and img.shape[2] == 3:
        color = 2
    elif img.ndim == 2:
        color = 0
    else:
        raise ValueError(f"encode_png takes (H, W) or (H, W, 3) uint8, not {img.shape}")
    h, w = img.shape[:2]

    def chunk(kind: bytes, body: bytes) -> bytes:
        return (struct.pack(">I", len(body)) + kind + body
                + struct.pack(">I", zlib.crc32(kind + body) & 0xFFFFFFFF))

    rows = _filter_rows(img.reshape(h, -1), 3 if color == 2 else 1).tobytes()
    return (_SIGNATURE + chunk(b"IHDR", struct.pack(">IIBBBBB", w, h, 8, color, 0, 0, 0))
            + chunk(b"IDAT", zlib.compress(rows)) + chunk(b"IEND", b""))
