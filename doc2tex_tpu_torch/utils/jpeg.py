"""Baseline JPEG bytes -> uint8 arrays, without PIL (the card's machine has
none).

The JAX package reads JPEGs through PIL (``Image.open(b).convert("L")`` or
``.convert("RGB")``), whose bundled libjpeg-turbo decodes with the
accurate integer IDCT (``JDCT_ISLOW``) and fancy upsampling.
``decode_jpeg`` gives the same bytes for the files that libjpeg's
sequential Huffman decoder takes:

- SOF0 and SOF1 frames, 8-bit samples, one or more scans, restart
  intervals, any Huffman and quantisation tables (DHT/DQT anywhere before
  the scan that uses them);
- one component (gray, straight to L), or three in YCbCr with any integer
  sampling ratio: 4:4:4, 4:2:2 (h2v1), 4:4:0 (h1v2) and 4:2:0 (h2v2)
  through libjpeg's triangle filters, other ratios by repetition, as
  ``jdsample.c`` does;
- libjpeg's fixed-point YCbCr -> RGB tables, then for L PIL's own
  ``(19595 R + 38470 G + 7471 B + 0x8000) >> 16``.

The scans' entropy decoding, dequantisation and IDCT, the upsampling and
the colour conversion run in the native library (``csrc/jpeg_decode.cpp``,
built by ``native.py``); ``decode_jpeg_py`` is the plain version of the
scan decoder and IDCT (Python) with numpy's upsampling and colour, which
the tests hold the library to.  Progressive (SOF2), lossless, arithmetic-
coded and 12-bit files, four components (CMYK, YCCK), an Adobe marker that
asks for no colour transform (transform 0), and RGB component ids raise
``NotImplementedError`` naming ROADMAP A12; bytes that are not a JPEG, or
a stream that ends or breaks before its frame is whole, raise
``ValueError``.
"""

from __future__ import annotations

import ctypes
import struct

import numpy as np

from .. import native

SOI = b"\xff\xd8"
UNPORTED = "ROADMAP A12"
# jpeg_natural_order: the zigzag position -> the natural (row-major) index
ZIGZAG = np.array([
    0, 1, 8, 16, 9, 2, 3, 10, 17, 24, 32, 25, 18, 11, 4, 5, 12, 19, 26, 33, 40, 48, 41, 34,
    27, 20, 13, 6, 7, 14, 21, 28, 35, 42, 49, 56, 57, 50, 43, 36, 29, 22, 15, 23, 30, 37,
    44, 51, 58, 59, 52, 45, 38, 31, 39, 46, 53, 60, 61, 54, 47, 55, 62, 63], np.int64)
_SOF_NAMES = {0xC2: "progressive", 0xC3: "lossless", 0xC5: "differential sequential",
              0xC6: "differential progressive", 0xC7: "differential lossless",
              0xC9: "arithmetic-coded sequential", 0xCA: "arithmetic-coded progressive",
              0xCB: "arithmetic-coded lossless", 0xCD: "arithmetic-coded differential",
              0xCE: "arithmetic-coded differential", 0xCF: "arithmetic-coded differential"}


class _Frame:
    """What the markers say: the frame, and each scan with the tables in
    force when it starts."""

    def __init__(self):
        self.width = self.height = 0
        self.components: list[dict] = []     # id, h, v, tq
        self.scans: list[dict] = []
        self.adobe_transform = None
        self.jfif = False


def _refuse(what: str):
    raise NotImplementedError(f"{what} JPEG: not decoded without PIL yet ({UNPORTED})")


def _scan_end(data: bytes, pos: int) -> int:
    """The offset of the first marker after ``pos`` that is not a stuffed
    0xFF00 or a restart marker (the end of an entropy-coded segment)."""
    n = len(data)
    while True:
        pos = data.find(b"\xff", pos)
        if pos < 0 or pos + 1 >= n:
            return n
        nxt = data[pos + 1]
        if nxt == 0x00 or 0xD0 <= nxt <= 0xD7 or nxt == 0xFF:
            pos += 1 if nxt == 0xFF else 2
            continue
        return pos


def parse(data: bytes) -> _Frame:
    """The markers of ``data`` up to EOI (see the module docstring for what
    raises)."""
    if not data.startswith(SOI):
        raise ValueError("not a JPEG file")
    frame = _Frame()
    qt = np.zeros((4, 64), np.uint16)
    huff: dict = {}                 # (class 0 DC / 1 AC, id) -> (bits[17], vals)
    restart = 0
    pos, n = 2, len(data)
    while pos < n:
        if data[pos] != 0xFF:
            raise ValueError(f"JPEG marker expected at byte {pos}")
        marker = data[pos + 1] if pos + 1 < n else 0xD9
        pos += 2
        if marker == 0xFF:          # fill byte
            pos -= 1
            continue
        if marker == 0xD9:
            break
        if 0xD0 <= marker <= 0xD7 or marker == 0x01:
            continue
        if pos + 2 > n:
            raise ValueError("JPEG ends inside a marker")
        (length,) = struct.unpack(">H", data[pos:pos + 2])
        body = data[pos + 2:pos + length]
        if len(body) != length - 2:
            raise ValueError("JPEG ends inside a marker segment")
        pos += length
        if marker in (0xC0, 0xC1):
            precision, h, w, nc = struct.unpack(">BHHB", body[:6])
            if precision != 8:
                _refuse(f"{precision}-bit")
            if h == 0:
                _refuse("DNL-sized (height 0)")
            if nc not in (1, 3):
                _refuse(f"{nc}-component (CMYK or YCCK)" if nc == 4 else f"{nc}-component")
            if w == 0 or len(body) < 6 + 3 * nc:
                raise ValueError("JPEG frame header is malformed")
            frame.width, frame.height = w, h
            for i in range(nc):
                cid, hv, tq = body[6 + 3 * i:9 + 3 * i]
                if not (1 <= hv >> 4 <= 4 and 1 <= hv & 15 <= 4 and tq < 4):
                    raise ValueError(f"JPEG component {cid}: sampling {hv >> 4}x{hv & 15}, "
                                     f"quantisation table {tq}")
                frame.components.append({"id": cid, "h": hv >> 4, "v": hv & 15, "tq": tq})
        elif marker in _SOF_NAMES:
            _refuse(_SOF_NAMES[marker])
        elif marker == 0xCC:
            _refuse("arithmetic-coded")
        elif marker == 0xC4:
            k = 0
            while k < len(body):
                tc, th = body[k] >> 4, body[k] & 15
                if tc > 1 or th > 3:
                    raise ValueError(f"JPEG Huffman table class {tc}, id {th}")
                bits = np.zeros(17, np.uint8)
                bits[1:] = np.frombuffer(body[k + 1:k + 17], np.uint8)
                total = int(bits.sum())
                vals = np.zeros(256, np.uint8)
                vals[:total] = np.frombuffer(body[k + 17:k + 17 + total], np.uint8)
                huff[(tc, th)] = (bits, vals)
                k += 17 + total
        elif marker == 0xDB:
            k = 0
            while k < len(body):
                pq, tq = body[k] >> 4, body[k] & 15
                if tq > 3:
                    raise ValueError(f"JPEG quantisation table id {tq}")
                if pq:
                    values = np.frombuffer(body[k + 1:k + 129], ">u2").astype(np.uint16)
                    k += 129
                else:
                    values = np.frombuffer(body[k + 1:k + 65], np.uint8).astype(np.uint16)
                    k += 65
                qt[tq, ZIGZAG] = values
        elif marker == 0xDD:
            (restart,) = struct.unpack(">H", body[:2])
        elif marker == 0xE0 and body[:5] == b"JFIF\x00":
            frame.jfif = True
        elif marker == 0xEE and body[:5] == b"Adobe" and len(body) >= 12:
            frame.adobe_transform = body[11]
        elif marker == 0xDA:
            if not frame.components:
                raise ValueError("JPEG scan before its frame header")
            ns = body[0]
            comps = []
            for i in range(ns):
                cid, tables = body[1 + 2 * i], body[2 + 2 * i]
                idx = next((j for j, c in enumerate(frame.components) if c["id"] == cid), None)
                if idx is None:
                    raise ValueError(f"JPEG scan names component {cid}, which the frame lacks")
                if tables >> 4 > 3 or tables & 15 > 3:
                    raise ValueError(f"JPEG scan names Huffman tables {tables >> 4}/{tables & 15}")
                comps.append((idx, tables >> 4, tables & 15))
            ss, se, ahal = body[1 + 2 * ns:4 + 2 * ns]
            if ss != 0 or se != 63 or ahal != 0:
                _refuse("progressive")
            end = _scan_end(data, pos)
            frame.scans.append({"components": comps, "data": data[pos:end],
                                "restart": restart, "quant": qt.copy(),
                                "huff": {k: (b.copy(), v.copy()) for k, (b, v) in huff.items()}})
            pos = end
    if not frame.scans:
        raise ValueError("JPEG has no scan")
    if len(frame.components) == 3:
        ids = tuple(c["id"] for c in frame.components)
        if frame.adobe_transform == 0 and not frame.jfif:
            _refuse("Adobe transform 0 (RGB-coded)")
        if ids == (82, 71, 66) and not frame.jfif and frame.adobe_transform is None:
            _refuse("RGB-coded")
    return frame


def _geometry(frame: _Frame):
    """Per component: (sampling h, v, downsampled width and height, blocks
    across and down as allocated), and the MCUs across and down."""
    hmax = max(c["h"] for c in frame.components)
    vmax = max(c["v"] for c in frame.components)
    mcux = -(-frame.width // (8 * hmax))
    mcuy = -(-frame.height // (8 * vmax))
    geo = []
    for c in frame.components:
        ds_w = -(-frame.width * c["h"] // hmax)
        ds_h = -(-frame.height * c["v"] // vmax)
        geo.append((c["h"], c["v"], ds_w, ds_h, mcux * c["h"], mcuy * c["v"]))
    return hmax, vmax, mcux, mcuy, geo


def _scan_layout(frame: _Frame, scan: dict, geo, mcux: int, mcuy: int):
    """(the scan's MCUs across and down, per scan component: (plane index,
    h, v, blocks across, blocks down to decode, DC table, AC table, quant
    table))."""
    comps = scan["components"]
    out = []
    if len(comps) == 1:    # non-interleaved: one block an MCU over the component's own blocks
        idx, td, ta = comps[0]
        _, _, ds_w, ds_h, _, _ = geo[idx]
        bw, bh = -(-ds_w // 8), -(-ds_h // 8)
        out.append((idx, 1, 1, bw, bh, td, ta, frame.components[idx]["tq"]))
        return bw, bh, out
    for idx, td, ta in comps:
        h, v, _, _, bw, bh = geo[idx]
        out.append((idx, h, v, bw, bh, td, ta, frame.components[idx]["tq"]))
    return mcux, mcuy, out


def _tables(scan: dict):
    bits = np.zeros((8, 17), np.uint8)
    vals = np.zeros((8, 256), np.uint8)
    present = np.zeros(8, np.uint8)
    for (tc, th), (b, v) in scan["huff"].items():
        if th < 4 and tc < 2:
            bits[4 * tc + th], vals[4 * tc + th], present[4 * tc + th] = b, v, 1
    return bits, vals, present


def _planes(frame: _Frame, geo, mcux: int, mcuy: int, scan_fn) -> list[np.ndarray]:
    """Every component's plane, views of one buffer (``planes[0].base``) in
    component order, filled scan by scan by ``scan_fn``."""
    sizes = [bh * 8 * bw * 8 for (_, _, _, _, bw, bh) in geo]
    buf = np.zeros(sum(sizes), np.uint8)
    offsets = np.cumsum([0] + sizes[:-1])
    planes = [buf[o:o + n].reshape(bh * 8, bw * 8)
              for o, n, (_, _, _, _, bw, bh) in zip(offsets, sizes, geo)]
    for scan in frame.scans:
        sx, sy, layout = _scan_layout(frame, scan, geo, mcux, mcuy)
        scan_fn(scan, sx, sy, layout, planes)
    return planes


def _check(err: int) -> None:
    if err == -1:
        raise ValueError("JPEG scan holds a code no Huffman table defines")
    if err == -2:
        raise ValueError("JPEG scan uses a Huffman table that is not defined")
    if err:
        raise ValueError(f"JPEG scan failed ({err})")


def _native_scan(scan, sx, sy, layout, planes):
    buf = planes[0].base        # the planes' one buffer (``_planes``)
    offset = [0]
    for p in planes[:-1]:
        offset.append(offset[-1] + p.size)
    info = np.array([[h, v, offset[idx], planes[idx].shape[1], bw, bh, td, ta, tq]
                     for idx, h, v, bw, bh, td, ta, tq in layout], np.int32)
    bits, vals, present = _tables(scan)
    quant = np.ascontiguousarray(scan["quant"])
    data = scan["data"]
    u8 = ctypes.POINTER(ctypes.c_uint8)
    err = native.load().d2t_jpeg_scan(
        data, len(data), len(layout), info.ctypes.data_as(ctypes.POINTER(ctypes.c_int)),
        bits.ctypes.data_as(u8), vals.ctypes.data_as(u8), present.ctypes.data_as(u8),
        quant.ctypes.data_as(ctypes.POINTER(ctypes.c_uint16)), sx, sy, scan["restart"],
        buf.ctypes.data_as(u8))
    _check(err)


def _native_upsample(plane, ds_w, ds_h, fh, fv, out_w, out_h) -> np.ndarray:
    src = np.ascontiguousarray(plane)
    out = np.empty((out_h, out_w), np.uint8)
    u8 = ctypes.POINTER(ctypes.c_uint8)
    native.load().d2t_jpeg_upsample(src.ctypes.data_as(u8), src.shape[1], ds_w, ds_h, fh, fv,
                                    out.ctypes.data_as(u8), out_w, out_h)
    return out


def _finish(frame: _Frame, planes, geo, hmax: int, vmax: int, rgb: bool, upsample, ycc):
    w, h = frame.width, frame.height
    full = []
    for plane, (ch, cv, ds_w, ds_h, _, _) in zip(planes, geo):
        if hmax % ch or vmax % cv:
            _refuse(f"sampling {ch}x{cv} of {hmax}x{vmax} (not an integer ratio)")
        fh, fv = hmax // ch, vmax // cv
        if fh == fv == 1:
            full.append(np.ascontiguousarray(plane[:h, :w]))
        else:
            full.append(upsample(plane, ds_w, ds_h, fh, fv, w, h))
    if len(full) == 1:
        gray = full[0]
        return np.repeat(gray[..., None], 3, axis=-1) if rgb else gray
    return ycc(*full, rgb)


def _native_ycc(y, cb, cr, rgb: bool) -> np.ndarray:
    out = np.empty(y.shape + ((3,) if rgb else ()), np.uint8)
    u8 = ctypes.POINTER(ctypes.c_uint8)
    native.load().d2t_jpeg_ycc(y.ctypes.data_as(u8), cb.ctypes.data_as(u8),
                               cr.ctypes.data_as(u8), y.size, 0 if rgb else 1,
                               out.ctypes.data_as(u8))
    return out


def decode_jpeg(data: bytes, rgb: bool = False) -> np.ndarray:
    """JPEG file bytes -> (H, W) uint8 as PIL's ``convert("L")`` gives, or
    with ``rgb`` (H, W, 3) uint8 as ``convert("RGB")`` gives."""
    frame = parse(bytes(data))
    hmax, vmax, mcux, mcuy, geo = _geometry(frame)
    planes = _planes(frame, geo, mcux, mcuy, _native_scan)
    return _finish(frame, planes, geo, hmax, vmax, rgb, _native_upsample, _native_ycc)


# --- the plain version ---------------------------------------------------------

_FIX = {"0298": 2446, "0390": 3196, "0541": 4433, "0765": 6270, "0899": 7373, "1175": 9633,
        "1501": 12299, "1847": 15137, "1961": 16069, "2053": 16819, "2562": 20995,
        "3072": 25172}


def _idct_limit(x: int) -> int:
    j = x & 1023
    return j + 128 if j < 128 else 255 if j < 512 else 0 if j < 896 else j - 896


def _idct_1d(s, descale: int):
    """One jidctint.c pass over 8 values (``s`` already dequantised)."""
    f = _FIX
    z2, z3 = s[2], s[6]
    z1 = (z2 + z3) * f["0541"]
    tmp2, tmp3 = z1 - z3 * f["1847"], z1 + z2 * f["0765"]
    tmp0, tmp1 = (s[0] + s[4]) << 13, (s[0] - s[4]) << 13
    tmp10, tmp13, tmp11, tmp12 = tmp0 + tmp3, tmp0 - tmp3, tmp1 + tmp2, tmp1 - tmp2
    t0, t1, t2, t3 = s[7], s[5], s[3], s[1]
    z1, z2, z3, z4 = t0 + t3, t1 + t2, t0 + t2, t1 + t3
    z5 = (z3 + z4) * f["1175"]
    t0, t1, t2, t3 = t0 * f["0298"], t1 * f["2053"], t2 * f["3072"], t3 * f["1501"]
    z1, z2 = z1 * -f["0899"], z2 * -f["2562"]
    z3, z4 = z3 * -f["1961"] + z5, z4 * -f["0390"] + z5
    t0, t1, t2, t3 = t0 + z1 + z3, t1 + z2 + z4, t2 + z2 + z3, t3 + z1 + z4
    r = 1 << (descale - 1)
    return [(tmp10 + t3 + r) >> descale, (tmp11 + t2 + r) >> descale,
            (tmp12 + t1 + r) >> descale, (tmp13 + t0 + r) >> descale,
            (tmp13 - t0 + r) >> descale, (tmp12 - t1 + r) >> descale,
            (tmp11 - t2 + r) >> descale, (tmp10 - t3 + r) >> descale]


def _idct_py(coef: list, quant: np.ndarray) -> np.ndarray:
    """libjpeg's ``jpeg_idct_islow`` of one block (natural order)."""
    ws = [[0] * 8 for _ in range(8)]        # ws[column][row]
    for c in range(8):
        col = [coef[8 * r + c] * int(quant[8 * r + c]) for r in range(8)]
        if not any(col[1:]):
            ws[c] = [col[0] << 2] * 8
        else:
            ws[c] = _idct_1d(col, 11)
    out = np.empty((8, 8), np.uint8)
    for r in range(8):
        row = [ws[c][r] for c in range(8)]
        if not any(row[1:]):
            out[r, :] = _idct_limit((row[0] + 16) >> 5)
        else:
            out[r, :] = [_idct_limit(v) for v in _idct_1d(row, 18)]
    return out


class _Bits:
    """An entropy-coded segment's bits, 0xFF00 unstuffed, zeros past a
    marker; ``restart`` steps over an RSTn marker."""

    def __init__(self, data: bytes):
        self.data, self.pos, self.acc, self.n = data, 0, 0, 0

    def _byte(self) -> int:
        d, p = self.data, self.pos
        if p >= len(d) or (d[p] == 0xFF and p + 1 < len(d) and d[p + 1] != 0x00):
            return 0
        if d[p] == 0xFF:
            self.pos += 2
            return 0xFF if p + 1 < len(d) else 0
        self.pos += 1
        return d[p]

    def get(self, k: int) -> int:
        while self.n < k:
            self.acc = (self.acc << 8) | self._byte()
            self.n += 8
        self.n -= k
        v = (self.acc >> self.n) & ((1 << k) - 1)
        self.acc &= (1 << self.n) - 1
        return v

    def restart(self) -> None:
        self.acc = self.n = 0
        d = self.data
        while self.pos + 1 < len(d) and not (d[self.pos] == 0xFF and 0xD0 <= d[self.pos + 1] <= 0xD7):
            self.pos += 1
        self.pos = min(self.pos + 2, len(d))


def _huffman_py(bits: np.ndarray, vals: np.ndarray) -> dict:
    codes, code, k = {}, 0, 0
    for length in range(1, 17):
        for _ in range(int(bits[length])):
            codes[(length, code)] = int(vals[k])
            code += 1
            k += 1
        code <<= 1
    return codes


def _symbol(br: _Bits, codes: dict) -> int:
    code = 0
    for length in range(1, 17):
        code = (code << 1) | br.get(1)
        if (length, code) in codes:
            return codes[(length, code)]
    raise ValueError("JPEG scan holds a code no Huffman table defines")


def _extend(x: int, s: int) -> int:
    return x - (1 << s) + 1 if x < (1 << (s - 1)) else x


def _py_scan(scan, sx, sy, layout, planes):
    tables = {}
    for (tc, th), (b, v) in scan["huff"].items():
        tables[(tc, th)] = _huffman_py(b, v)
    for _, _, _, _, _, td, ta, _ in layout:
        if (0, td) not in tables or (1, ta) not in tables:
            raise ValueError("JPEG scan uses a Huffman table that is not defined")
    br = _Bits(scan["data"])
    pred = [0] * len(layout)
    restart, left = scan["restart"], scan["restart"]
    for my in range(sy):
        for mx in range(sx):
            if restart and left == 0:
                br.restart()
                pred = [0] * len(layout)
                left = restart
            for ci, (idx, h, v, bw, bh, td, ta, tq) in enumerate(layout):
                dc, ac = tables[(0, td)], tables[(1, ta)]
                for bv in range(v):
                    for bhz in range(h):
                        coef = [0] * 64
                        s = _symbol(br, dc)
                        if s:
                            pred[ci] += _extend(br.get(s), s)
                        coef[0] = pred[ci]
                        k = 1
                        while k < 64:
                            rs = _symbol(br, ac)
                            r, s = rs >> 4, rs & 15
                            if s:
                                k += r
                                coef[int(ZIGZAG[min(k, 63)])] = _extend(br.get(s), s)
                            elif r != 15:
                                break
                            else:
                                k += 15
                            k += 1
                        by, bx = my * v + bv, mx * h + bhz
                        if by < bh and bx < bw:
                            planes[idx][by * 8:by * 8 + 8, bx * 8:bx * 8 + 8] = _idct_py(
                                coef, scan["quant"][tq])
            left -= 1


def _rows(plane: np.ndarray, ds_h: int, ys: np.ndarray) -> np.ndarray:
    return plane[np.clip(ys, 0, ds_h - 1)].astype(np.int32)


def _upsample_py(plane, ds_w, ds_h, fh, fv, out_w, out_h) -> np.ndarray:
    oy = np.arange(out_h)
    iy = oy // fv
    near = _rows(plane, ds_h, iy)[:, :ds_w]
    if fv == 2 and (fh == 1 or (fh == 2 and ds_w > 2)):
        far = _rows(plane, ds_h, np.where(oy % 2 == 0, iy - 1, iy + 1))[:, :ds_w]
        colsum = near * 3 + far
        if fh == 1:
            bias = np.where(oy % 2 == 0, 1, 2)[:, None]
            return ((colsum + bias) >> 2).astype(np.uint8)[:, :out_w]
        left = np.concatenate([colsum[:, :1], colsum[:, :-1]], axis=1)
        right = np.concatenate([colsum[:, 1:], colsum[:, -1:]], axis=1)
        out = np.empty((out_h, 2 * ds_w), np.int32)
        out[:, 0::2] = (colsum * 3 + left + 8) >> 4
        out[:, 1::2] = (colsum * 3 + right + 7) >> 4
        return out.astype(np.uint8)[:, :out_w]
    if fh == 2 and fv == 1 and ds_w > 2:
        left = np.concatenate([near[:, :1], near[:, :-1]], axis=1)
        right = np.concatenate([near[:, 1:], near[:, -1:]], axis=1)
        out = np.empty((out_h, 2 * ds_w), np.int32)
        out[:, 0::2] = (near * 3 + left + 1) >> 2
        out[:, 1::2] = (near * 3 + right + 2) >> 2
        return out.astype(np.uint8)[:, :out_w]
    return np.repeat(near, fh, axis=1).astype(np.uint8)[:, :out_w]


def _ycc_py(y, cb, cr, rgb: bool) -> np.ndarray:
    x = np.arange(256, dtype=np.int64) - 128
    one_half = 1 << 15

    def fix(v):
        return int(v * 65536.0 + 0.5)

    cr_r = (fix(1.40200) * x + one_half) >> 16
    cb_b = (fix(1.77200) * x + one_half) >> 16
    cr_g = -fix(0.71414) * x
    cb_g = -fix(0.34414) * x + one_half
    yy = y.astype(np.int64)
    r = np.clip(yy + cr_r[cr], 0, 255)
    g = np.clip(yy + ((cb_g[cb] + cr_g[cr]) >> 16), 0, 255)
    b = np.clip(yy + cb_b[cb], 0, 255)
    if rgb:
        return np.stack([r, g, b], axis=-1).astype(np.uint8)
    return ((r * 19595 + g * 38470 + b * 7471 + 0x8000) >> 16).astype(np.uint8)


def decode_jpeg_py(data: bytes, rgb: bool = False) -> np.ndarray:
    """``decode_jpeg`` in Python and numpy (slow: for small images)."""
    frame = parse(bytes(data))
    hmax, vmax, mcux, mcuy, geo = _geometry(frame)
    planes = _planes(frame, geo, mcux, mcuy, _py_scan)
    return _finish(frame, planes, geo, hmax, vmax, rgb, _upsample_py, _ycc_py)
