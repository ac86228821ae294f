"""The port's baseline JPEG decoder (``doc2tex_tpu_torch/utils/jpeg.py``,
its scans, IDCT, upsampling and colour conversion in
``csrc/jpeg_decode.cpp``) against PIL, which the JAX package reads JPEGs
with: the bytes of ``Image.open(b).convert("L")`` and ``.convert("RGB")``,
exactly, on JPEGs PIL writes here:

- gray, 4:4:4, 4:2:2 and 4:2:0, at qualities 5 to 100, on odd sizes and
  sizes at and around the MCU's edges (1x1 to 65x67), on a smooth ramp and
  on noise (which drives the IDCT into its range limit);
- restart intervals (every block, every few blocks, every MCU row);
- optimised Huffman tables;
- a 1,700 x 2,200 page.

The native library equals the plain Python version
(``decode_jpeg_py``) on small files of each kind, and its upsampling
equals numpy's at every sampling ratio (h1v2 and the box-filter ratios
included, which PIL cannot write).  A JPEG in an LMDB store reads equal to
the JAX package's ``LmdbReader``; a ``.jpg`` page reads as the JAX
package's ``detection/data.py`` reads it.  Progressive and CMYK files
raise ``NotImplementedError`` naming ROADMAP A12; bytes that are not a
JPEG raise ``ValueError``.  The committed fixtures of ``chip_smoke.py``'s
JPEG phase (``tests/torch_port_jpeg/``, four small files and a 1,700 x
2,200 page) decode to their stored sha256.

    PYTHONPATH=. python tests/test_torch_port_jpeg.py --write-fixtures

writes the fixtures and their sha256 with PIL (only on purpose).
"""

from __future__ import annotations

import hashlib
import io
import json
import os
import sys

import numpy as np
import pytest
from PIL import Image

from doc2tex_tpu_torch.utils import jpeg

HERE = os.path.dirname(os.path.abspath(__file__))
FIXTURES = os.path.join(HERE, "torch_port_jpeg")
FIXTURE_SHA = os.path.join(FIXTURES, "sha256.json")
MODES = {"gray": ("L", None), "444": ("RGB", 0), "422": ("RGB", 1), "420": ("RGB", 2)}
QUALITIES = (5, 25, 50, 75, 95, 100)
SIZES = ((1, 1), (2, 3), (7, 9), (8, 8), (9, 17), (15, 16), (16, 16), (17, 31), (32, 33),
         (65, 67))
# (name, mode, quality, save options): chip_smoke.py's fixtures
FIXTURE_CASES = (("gray_q75", "gray", 75, {}), ("ycc444_q90", "444", 90, {}),
                 ("ycc422_q50_rst", "422", 50, {"restart_marker_blocks": 3}),
                 ("ycc420_q30_opt", "420", 30, {"optimize": True}))
# a scanned page's size: tiles of page_eval's synthetic pages (seed 35), 4:2:0 at quality 90
PAGE_FIXTURE = "page_2200x1700"


def image(h: int, w: int, seed: int, noise: bool) -> np.ndarray:
    """An (h, w, 3) uint8 test image: a coloured ramp, or noise."""
    rng = np.random.default_rng(seed)
    if noise:
        return rng.integers(0, 256, (h, w, 3)).astype(np.uint8)
    y, x = np.mgrid[:h, :w]
    ramp = np.stack([(7 * x + 3 * y) % 256, (x * x // 3 + y) % 256, (255 - x - 2 * y) % 256], -1)
    return np.clip(ramp + rng.integers(0, 40, (h, w, 3)), 0, 255).astype(np.uint8)


def encode(arr: np.ndarray, mode: str, quality: int, **options) -> bytes:
    pil_mode, subsampling = MODES[mode]
    img = Image.fromarray(arr[..., 0] if pil_mode == "L" else arr)
    if subsampling is not None:
        options["subsampling"] = subsampling
    buf = io.BytesIO()
    img.save(buf, "JPEG", quality=quality, **options)
    return buf.getvalue()


def pil(data: bytes, rgb: bool) -> np.ndarray:
    return np.asarray(Image.open(io.BytesIO(data)).convert("RGB" if rgb else "L"))


def assert_like_pil(data: bytes, where) -> None:
    for rgb in (False, True):
        got, want = jpeg.decode_jpeg(data, rgb=rgb), pil(data, rgb)
        assert got.dtype == np.uint8 and got.shape == want.shape, (where, rgb)
        assert np.array_equal(got, want), (where, rgb, int(np.abs(
            got.astype(int) - want).max()), int((got != want).sum()))


@pytest.mark.parametrize("quality", QUALITIES)
@pytest.mark.parametrize("mode", sorted(MODES))
def test_equals_pil(mode, quality):
    for i, (h, w) in enumerate(SIZES):
        for noise in (False, True):
            data = encode(image(h, w, 100 * quality + i, noise), mode, quality)
            assert_like_pil(data, (mode, quality, h, w, noise))


@pytest.mark.parametrize("options", [{"restart_marker_blocks": 1},
                                     {"restart_marker_blocks": 3},
                                     {"restart_marker_rows": 1},
                                     {"optimize": True},
                                     {"optimize": True, "restart_marker_blocks": 2}],
                         ids=["rst1", "rst3", "rst_row", "optimize", "optimize_rst2"])
@pytest.mark.parametrize("mode", sorted(MODES))
def test_restarts_and_optimized_tables_equal_pil(mode, options):
    for i, (h, w) in enumerate(((17, 31), (40, 72), (65, 67))):
        data = encode(image(h, w, i, noise=i == 1), mode, 60, **options)
        assert_like_pil(data, (mode, options, h, w))


def test_page_equals_pil():
    """A 1,700 x 2,200 page: text-like ink on white, 4:2:0 and gray."""
    rng = np.random.default_rng(7)
    y, x = np.mgrid[:2200, :1700]
    page = np.full((2200, 1700), 255, np.int32)
    page[(y // 20) % 7 == 0] = 0
    page[(x // 13) % 11 == 0] = 40
    page = np.clip(page - rng.integers(0, 30, page.shape), 0, 255).astype(np.uint8)
    for mode in ("gray", "420"):
        assert_like_pil(encode(np.repeat(page[..., None], 3, -1), mode, 90), mode)


@pytest.mark.parametrize("mode", sorted(MODES))
def test_native_equals_plain_version(mode):
    for i, (h, w, q, options) in enumerate(((9, 17, 30, {}), (16, 24, 95, {}),
                                            (19, 21, 60, {"restart_marker_blocks": 2}))):
        data = encode(image(h, w, i, noise=i == 1), mode, q, **options)
        for rgb in (False, True):
            np.testing.assert_array_equal(jpeg.decode_jpeg_py(data, rgb=rgb),
                                          jpeg.decode_jpeg(data, rgb=rgb))


@pytest.mark.parametrize("fh,fv", [(2, 1), (1, 2), (2, 2), (3, 1), (1, 3), (4, 2)])
def test_native_upsampling_equals_plain_version(fh, fv):
    rng = np.random.default_rng(fh * 10 + fv)
    for ds_h, ds_w in ((1, 1), (2, 2), (3, 2), (5, 3), (9, 14)):
        plane = rng.integers(0, 256, (ds_h + 3, ds_w + 5)).astype(np.uint8)
        for out_h, out_w in ((ds_h * fv, ds_w * fh), (ds_h * fv - fv + 1, ds_w * fh - fh + 1)):
            np.testing.assert_array_equal(
                jpeg._native_upsample(plane, ds_w, ds_h, fh, fv, out_w, out_h),
                jpeg._upsample_py(plane, ds_w, ds_h, fh, fv, out_w, out_h))


@pytest.mark.parametrize("rgb", [False, True])
def test_lmdb_jpeg_equals_jax_reader(tmp_path, rgb):
    from doc2tex_tpu.data import lmdb_reader as jax_lmdb
    from doc2tex_tpu_torch.data import lmdb_reader
    from doc2tex_tpu_torch.data.pylmdb import write_pylmdb

    pairs = [(b"num-samples", b"3")]
    for i, mode in enumerate(("gray", "420", "422"), 1):
        h, w = 20 + 9 * i, 50 + 7 * i
        pairs += [(b"image-%09d" % i, encode(image(h, w, i, noise=False), mode, 70)),
                  (b"label-%09d" % i, b"x"), (b"height-%09d" % i, np.int32(h).tobytes()),
                  (b"width-%09d" % i, np.int32(w).tobytes())]
    root = str(tmp_path / "db")
    write_pylmdb(root, pairs)
    port, ref = lmdb_reader.LmdbReader(root, rgb=rgb), jax_lmdb.LmdbReader(root, rgb=rgb)
    for i in (1, 2, 3):
        np.testing.assert_array_equal(port.image(i), ref.image(i))


def test_jpg_page_reads_as_jax_detection_data(tmp_path):
    """``detection/data.read_page`` against the JAX package's page read
    (``np.asarray(Image.open(path).convert("L"), np.uint8)``,
    ``doc2tex_tpu/detection/data.py``)."""
    from doc2tex_tpu_torch.detection.data import read_page

    arr = image(300, 421, 3, noise=False)
    for ext, mode in ((".jpg", "420"), (".jpeg", "gray"), (".JPG", "444")):
        path = str(tmp_path / f"page{ext}")
        with open(path, "wb") as f:
            f.write(encode(arr, mode, 85))
        np.testing.assert_array_equal(read_page(path),
                                      np.asarray(Image.open(path).convert("L"), np.uint8))


@pytest.mark.parametrize("kind", ["progressive", "cmyk"])
def test_unported_variants_raise(kind):
    buf = io.BytesIO()
    arr = image(16, 16, 0, noise=False)
    if kind == "progressive":
        Image.fromarray(arr).save(buf, "JPEG", progressive=True)
    else:
        Image.fromarray(np.concatenate([arr, arr[..., :1]], -1), "CMYK").save(buf, "JPEG")
    pil(buf.getvalue(), False)          # PIL reads it
    with pytest.raises(NotImplementedError, match="A12"):
        jpeg.decode_jpeg(buf.getvalue())


def test_not_a_jpeg_raises():
    with pytest.raises(ValueError, match="not a JPEG"):
        jpeg.decode_jpeg(b"\x89PNG\r\n\x1a\n")


@pytest.mark.parametrize("field,value", [("sampling", 0x00), ("sampling", 0x51),
                                         ("quant", 7), ("scan_tables", 0x44)])
def test_malformed_header_raises_value_error(field, value):
    """Out-of-range header fields are refused before the native decoder
    sees them (they would index past its tables)."""
    data = bytearray(encode(image(16, 16, 0, noise=False), "420", 75))
    sof, sos = data.index(b"\xff\xc0"), data.index(b"\xff\xda")
    if field == "sampling":
        data[sof + 2 + 2 + 6 + 1] = value           # the first component's h/v byte
    elif field == "quant":
        data[sof + 2 + 2 + 6 + 2] = value           # its quantisation table
    else:
        data[sos + 2 + 2 + 1 + 1] = value           # the scan's first table byte
    with pytest.raises(ValueError):
        jpeg.decode_jpeg(bytes(data))


def fixture_bytes(name: str) -> bytes:
    with open(os.path.join(FIXTURES, f"{name}.jpg"), "rb") as f:
        return f.read()


def test_fixtures_decode_to_their_sha256():
    with open(FIXTURE_SHA) as f:
        want = json.load(f)
    assert sorted(want) == sorted([name for name, *_ in FIXTURE_CASES] + [PAGE_FIXTURE])
    for name, entry in want.items():
        data = fixture_bytes(name)
        assert hashlib.sha256(data).hexdigest() == entry["file"]
        for rgb, key in ((False, "L"), (True, "RGB")):
            got = jpeg.decode_jpeg(data, rgb=rgb)
            assert hashlib.sha256(got.tobytes()).hexdigest() == entry[key], (name, key)
            assert list(got.shape) == entry[f"{key}_shape"]


def page_image() -> np.ndarray:
    """(2200, 1700, 3): six of ``page_eval``'s synthetic pages (seed 35)
    tiled and cropped to a US-letter scan at 200 dpi."""
    from doc2tex_tpu_torch.tools.page_eval import synth_labelled_page

    rng = np.random.default_rng(35)
    rows = [np.concatenate([synth_labelled_page(rng)[0] for _ in range(2)], axis=1)
            for _ in range(3)]
    return np.repeat(np.concatenate(rows, axis=0)[:2200, :1700, None], 3, axis=-1)


def write_fixtures() -> None:
    os.makedirs(FIXTURES, exist_ok=True)
    sha = {}
    cases = [(name, mode, quality, options, image(37 + 11 * i, 53 + 17 * i, 900 + i, False))
             for i, (name, mode, quality, options) in enumerate(FIXTURE_CASES)]
    cases.append((PAGE_FIXTURE, "420", 90, {}, page_image()))
    for name, mode, quality, options, arr in cases:
        data = encode(arr, mode, quality, **options)
        with open(os.path.join(FIXTURES, f"{name}.jpg"), "wb") as f:
            f.write(data)
        sha[name] = {"file": hashlib.sha256(data).hexdigest()}
        for rgb, key in ((False, "L"), (True, "RGB")):
            px = pil(data, rgb)
            sha[name][key] = hashlib.sha256(np.ascontiguousarray(px).tobytes()).hexdigest()
            sha[name][f"{key}_shape"] = list(px.shape)
    with open(FIXTURE_SHA, "w") as f:
        json.dump(sha, f, indent=1, sort_keys=True)
        f.write("\n")


if __name__ == "__main__":
    if "--write-fixtures" in sys.argv:
        write_fixtures()
