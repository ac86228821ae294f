"""The port's data chain against the JAX package's, on the CPU.

- Stores: a store written by JAX's ``write_lmdb`` (PIL's PNG bytes, the
  pure-Python MDB writer) is read by the port with every key and value
  equal; a store written by the port is read by JAX's ``LmdbReader`` with
  equal keys, labels and decoded images.  The MDB cases of
  ``tests/test_tools.py`` (multilevel tree with overflow pages, empty store,
  meta chosen by txnid, torn meta 0, both metas torn) run on the port's
  writer, read by both packages' readers.  Undecodable bytes give JAX's
  32x32 dummy; JPEG bytes (which PIL reads) raise naming ROADMAP A11.
- PNG: ``utils.png.decode_png`` equals PIL's ``convert("L")`` and
  ``convert("RGB")`` on every colour type and bit depth PNG allows, plain
  and Adam7-interlaced, over all five row filters (the test writes the
  files itself; PIL decodes them); the native row unfilter equals the
  plain Python one; ``encode_png``'s gray and RGB files, each row under
  its own filter as PIL writes them, decode in PIL to the same array.
- Loader: JAX's ``BucketLoader(LmdbDataset)`` and the port's give equal
  batches (bucket, images, text, lengths, labels, names) on one store of
  40 samples: training (seeded, augment and pad jitter on, two epochs) and
  eval, with the ``ladder`` and the ``exact`` bucket modes.
- ``api.infer`` over an LMDB ``eval_data`` gives the predictions of the
  same config over a PNG manifest of the same images.
- The ``realdata`` twin: ``package --synthetic_fallback`` + ``lmdb`` at n
  16 give a store equal in labels and decoded images to the JAX tool's;
  ``chip_smoke.py``'s realdata phase runs its (a) and (b) at a tiny size.
"""

from __future__ import annotations

import csv
import importlib.util
import io
import os
import struct
import zlib

import numpy as np
import pytest

from doc2tex_tpu_torch.data import lmdb_reader
from doc2tex_tpu_torch.data.pylmdb import PyLmdbReader, write_pylmdb
from doc2tex_tpu_torch.data.synthetic import HARD_VOCAB_PATH, synth_hard_dataset
from doc2tex_tpu_torch.utils.png import decode_png, encode_png
from torch_port_threads import one_torch_thread  # noqa: F401

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SIGNATURE = b"\x89PNG\r\n\x1a\n"
ADAM7 = ((0, 0, 8, 8), (4, 0, 8, 8), (0, 4, 4, 8), (2, 0, 4, 4), (0, 2, 2, 4), (1, 0, 2, 2),
         (0, 1, 1, 2))
CHANNELS = {0: 1, 2: 3, 3: 1, 4: 2, 6: 4}
# every (colour type, bit depth) PNG allows
PNG_TYPES = [(0, 1), (0, 2), (0, 4), (0, 8), (0, 16), (3, 1), (3, 2), (3, 4), (3, 8),
             (2, 8), (2, 16), (4, 8), (4, 16), (6, 8), (6, 16)]


def hard_samples(n, seed):
    """Small hard-benchmark crops and labels."""
    return synth_hard_dataset(n, seed=seed, min_len=3, max_len=12, max_h=96, max_w=320)


# ----------------------------------------------------------------- PNG


def _chunk(kind: bytes, body: bytes) -> bytes:
    return (struct.pack(">I", len(body)) + kind + body
            + struct.pack(">I", zlib.crc32(kind + body) & 0xFFFFFFFF))


def _pack_row(row: np.ndarray, depth: int) -> bytes:
    if depth == 16:
        return row.astype(">u2").tobytes()
    if depth == 8:
        return row.astype(np.uint8).tobytes()
    per = 8 // depth
    row = np.concatenate([row, np.zeros(-len(row) % per, row.dtype)]).reshape(-1, per)
    shifts = 8 - depth * np.arange(1, per + 1)
    return (row.astype(np.uint8) << shifts.astype(np.uint8)).sum(1, dtype=np.uint8).tobytes()


def _filtered(kind: int, line: bytes, prev: bytes, bpp: int) -> bytes:
    x = np.frombuffer(line, np.uint8).astype(np.int32)
    up = np.frombuffer(prev, np.uint8).astype(np.int32) if prev else np.zeros_like(x)
    a = np.concatenate([np.zeros(bpp, np.int32), x])[:len(x)]
    c = np.concatenate([np.zeros(bpp, np.int32), up])[:len(x)]
    p = a + up - c
    pa, pb, pc = abs(p - a), abs(p - up), abs(p - c)
    pred = [np.zeros_like(x), a, up, (a + up) >> 1,
            np.where((pa <= pb) & (pa <= pc), a, np.where(pb <= pc, up, c))][kind]
    return bytes([kind]) + ((x - pred) % 256).astype(np.uint8).tobytes()


def write_png(samples, depth, color, interlace, palette=None, trns=None) -> bytes:
    """A PNG of (h, w, channels) integer samples, every row filter in turn,
    plain or Adam7 (each pass's rows filtered on their own)."""
    h, w, ch = samples.shape
    bpp = max(ch * depth // 8, 1)
    passes = ([samples[y0::dy, x0::dx] for x0, y0, dx, dy in ADAM7] if interlace
              else [samples])
    raw, k = b"", 0
    for p in passes:
        if p.size == 0:
            continue
        prev = b""
        for row in p.reshape(p.shape[0], -1):
            line = _pack_row(row, depth)
            raw += _filtered(k % 5, line, prev, bpp)
            prev, k = line, k + 1
    out = SIGNATURE + _chunk(b"IHDR", struct.pack(">IIBBBBB", w, h, depth, color, 0, 0,
                                                  int(interlace)))
    if palette is not None:
        out += _chunk(b"PLTE", palette.astype(np.uint8).tobytes())
    if trns is not None:
        out += _chunk(b"tRNS", trns)
    return out + _chunk(b"IDAT", zlib.compress(raw)) + _chunk(b"IEND", b"")


@pytest.mark.parametrize("interlace", [False, True], ids=["plain", "adam7"])
@pytest.mark.parametrize("color,depth", PNG_TYPES, ids=[f"type{c}-{d}bit" for c, d in PNG_TYPES])
def test_decode_png_equals_pil(color, depth, interlace):
    """``decode_png`` equals PIL's ``convert("L")`` and ``convert("RGB")``,
    at sizes that leave Adam7 passes empty and rows that end mid-byte, with
    ``tRNS`` present for the types that may carry it."""
    from PIL import Image

    rng = np.random.default_rng(color * 100 + depth * 2 + interlace)
    top = 1 << depth
    for h, w in ((1, 1), (3, 5), (9, 13), (17, 10)):
        samples = rng.integers(0, top, (h, w, CHANNELS[color]))
        palette = rng.integers(0, 256, (top, 3)) if color == 3 else None
        trns = {0: struct.pack(">H", 1), 2: struct.pack(">HHH", 1, 2, 3),
                3: bytes([0, 128])}.get(color)
        data = write_png(samples, depth, color, interlace, palette, trns)
        with Image.open(io.BytesIO(data)) as im:
            want_l, want_rgb = np.asarray(im.convert("L")), np.asarray(im.convert("RGB"))
        np.testing.assert_array_equal(decode_png(data), want_l)
        np.testing.assert_array_equal(decode_png(data, rgb=True), want_rgb)


def test_encode_png_round_trips_through_pil():
    """``encode_png``'s files decode in PIL and in ``decode_png`` to the
    array; it picks a filter per row, so a formula crop's file holds mostly
    Paeth rows, as PIL's do."""
    from PIL import Image

    rng = np.random.default_rng(0)
    crop = hard_samples(1, seed=3)[0][0]
    for img in (rng.integers(0, 256, (7, 11), dtype=np.uint8),
                rng.integers(0, 256, (5, 9, 3), dtype=np.uint8), crop):
        with Image.open(io.BytesIO(encode_png(img))) as im:
            np.testing.assert_array_equal(np.asarray(im), img)
        np.testing.assert_array_equal(decode_png(encode_png(img), rgb=img.ndim == 3), img)
    data = encode_png(crop)
    raw = zlib.decompress(data[data.index(b"IDAT") + 4:])
    kinds = {raw[y * (crop.shape[1] + 1)] for y in range(crop.shape[0])}
    assert 4 in kinds and len(kinds) > 1, kinds
    with pytest.raises(ValueError):
        decode_png(b"not a png")
    with pytest.raises(ValueError):   # bit depth 16 is not allowed for palettes
        decode_png(write_png(np.zeros((2, 2, 1), int), 16, 3, False, np.zeros((2, 3))))


@pytest.mark.parametrize("bpp", [1, 2, 3, 4, 6, 8])
def test_native_unfilter_equals_plain(bpp):
    """``native.png_unfilter`` (what ``decode_png`` runs) equals the plain
    ``_unfilter_py`` on random rows under random filters, at every byte
    width a pixel may have; both refuse an unknown filter type."""
    from doc2tex_tpu_torch.utils.png import _unfilter, _unfilter_py

    rng = np.random.default_rng(bpp)
    for h, stride in ((1, bpp), (7, 3 * bpp + 1), (40, 96)):
        rows = rng.integers(0, 256, (h, stride + 1), dtype=np.uint8)
        rows[:, 0] = rng.integers(0, 5, h)
        raw = b"pad" + rows.tobytes()
        np.testing.assert_array_equal(_unfilter(raw, 3, h, stride, bpp),
                                      _unfilter_py(raw, 3, h, stride, bpp))
    rows[-1, 0] = 5
    for unfilter in (_unfilter, _unfilter_py):
        with pytest.raises(ValueError, match="unknown PNG row filter 5"):
            unfilter(rows.tobytes(), 0, h, stride, bpp)
        with pytest.raises(ValueError, match="shorter"):
            unfilter(rows.tobytes()[:-1], 0, h, stride, bpp)


# ----------------------------------------------------------------- stores


def _pairs(root):
    return list(PyLmdbReader(root).items())


def test_jax_store_reads_in_the_port(tmp_path):
    from doc2tex_tpu.data import lmdb_reader as jax_lmdb
    from doc2tex_tpu.data.pylmdb import PyLmdbReader as JaxReader

    images, labels = hard_samples(6, seed=1)
    images.append(np.stack([images[0]] * 3, -1))     # one RGB image
    labels.append(labels[0])
    root = str(tmp_path / "jax")
    jax_lmdb.write_lmdb(root, images, labels, names=[f"n{i}" for i in range(7)])
    assert _pairs(root) == list(JaxReader(root).items())
    for rgb in (False, True):
        port, jax = lmdb_reader.LmdbReader(root, rgb=rgb), jax_lmdb.LmdbReader(root, rgb=rgb)
        assert len(port) == len(jax) == 7
        for i in range(1, 8):
            assert (port.label(i), port.name(i), port.size(i)) == (jax.label(i), jax.name(i),
                                                                   jax.size(i))
            np.testing.assert_array_equal(port.image(i), jax.image(i))


def test_port_store_reads_in_jax(tmp_path):
    from doc2tex_tpu.data import lmdb_reader as jax_lmdb

    images, labels = hard_samples(6, seed=2)
    images[1] = np.stack([images[1]] * 3, -1)
    root = str(tmp_path / "port")
    lmdb_reader.write_lmdb(root, images, labels)
    jax = jax_lmdb.LmdbReader(root)
    assert len(jax) == 6
    keys = [k for k, _ in _pairs(root)]
    assert keys == sorted(keys) and len(keys) == 6 * 5 + 1
    for i, (img, label) in enumerate(zip(images, labels), 1):
        assert (jax.label(i), jax.name(i), jax.size(i)) == (label, f"sample-{i}", img.shape[:2])
        np.testing.assert_array_equal(jax_lmdb.LmdbReader(root, rgb=img.ndim == 3).image(i), img)


def _multilevel():
    rng = np.random.default_rng(0)
    pairs = []
    for i in range(2500):
        v = (rng.integers(0, 256, 9000, dtype=np.uint8).tobytes() if i % 100 == 0
             else (b"v%d" % i) * (i % 11 + 1))     # 9000 bytes spill to overflow pages
        pairs.append((b"key-%09d" % i, v))
    return pairs


def _torn(offsets):
    def tear(path):
        with open(path, "r+b") as f:
            for off in offsets:
                f.seek(off)
                f.write(b"\x00\x00\x00\x00")
    return tear


# case: (the pairs written, what is done to data.mdb after)
STORE_CASES = {
    "multilevel_tree_and_overflow": (_multilevel(), None),
    "empty_store": ([], None),
    "meta_by_txnid": ([(b"a", b"1")], None),
    "torn_meta0": ([(b"a", b"1"), (b"b", b"2")], _torn((16,))),
    "both_metas_torn": ([(b"a", b"1")], _torn((16, 4096 + 16))),
}


@pytest.mark.parametrize("case", list(STORE_CASES))
def test_store_cases(case, tmp_path):
    """``tests/test_tools.py``'s MDB cases on the port's writer, read by
    the port's reader and by JAX's: the same entries, lookups and in-order
    scan; a torn meta 0 opens through meta 1; both torn raise."""
    from doc2tex_tpu.data.pylmdb import PyLmdbReader as JaxReader

    pairs, damage = STORE_CASES[case]
    root = str(tmp_path / "db")
    write_pylmdb(root, pairs)
    if damage:
        damage(os.path.join(root, "data.mdb"))
    if case == "both_metas_torn":
        for reader in (PyLmdbReader, JaxReader):
            with pytest.raises(ValueError):
                reader(root)
        return
    lut = dict(pairs)
    for reader in (PyLmdbReader(root), JaxReader(root)):
        assert reader.entries == len(pairs)
        for k in list(lut)[:: max(len(lut) // 7, 1)] + [b"nope", b"x"]:
            assert reader.get(k) == lut.get(k)
        assert list(reader.items()) == sorted(lut.items())


def test_corrupt_image_dummy_and_jpeg_raise(tmp_path):
    """Bytes PIL cannot open give both packages' 32x32 dummy (white in
    gray, PIL's ``color=255`` red in RGB); JPEG
    bytes, which PIL opens, raise in the port naming ROADMAP A11."""
    from PIL import Image

    from doc2tex_tpu.data import lmdb_reader as jax_lmdb

    jpeg = io.BytesIO()
    Image.fromarray(np.full((8, 8), 90, np.uint8)).save(jpeg, format="JPEG")
    pairs = [(b"num-samples", b"2"), (b"image-000000001", b"\x00garbage"),
             (b"image-000000002", jpeg.getvalue())]
    for i in (1, 2):
        pairs += [(b"label-%09d" % i, b"x"), (b"height-%09d" % i, np.int32(8).tobytes()),
                  (b"width-%09d" % i, np.int32(8).tobytes())]
    root = str(tmp_path / "db")
    write_pylmdb(root, pairs)
    for rgb in (False, True):
        port, jax = lmdb_reader.LmdbReader(root, rgb=rgb), jax_lmdb.LmdbReader(root, rgb=rgb)
        np.testing.assert_array_equal(port.image(1), jax.image(1))
        assert port.image(1).shape[:2] == (32, 32) and (port.image(1)[..., 0] == 255).all()
        assert jax.image(2).shape[:2] == (8, 8)       # PIL reads the JPEG
        with pytest.raises(NotImplementedError, match="A11"):
            port.image(2)


# ----------------------------------------------------------------- loader


@pytest.fixture(scope="module")
def store(tmp_path_factory):
    """40 hard crops in a store written by the JAX package (PIL's PNGs)."""
    from doc2tex_tpu.data.lmdb_reader import write_lmdb

    images, labels = hard_samples(40, seed=5)
    root = str(tmp_path_factory.mktemp("loader") / "lmdb")
    write_lmdb(root, images, labels, names=[f"c{i:02d}" for i in range(40)])
    return root


LOADER_CASES = [(train, mode) for train in (True, False) for mode in ("ladder", "exact")]


@pytest.mark.parametrize("train,mode", LOADER_CASES,
                         ids=[f"{'train' if t else 'eval'}-{m}" for t, m in LOADER_CASES])
def test_loader_batches_equal_jax(store, train, mode):
    from doc2tex_tpu.config import make_config as jax_make_config
    from doc2tex_tpu.data.loader import BucketLoader as JaxLoader
    from doc2tex_tpu.data.loader import LmdbDataset as JaxLmdbDataset
    from doc2tex_tpu.tokenizer.converters import create_converter as jax_converter

    from doc2tex_tpu_torch.config import make_config
    from doc2tex_tpu_torch.data.loader import BucketLoader, LmdbDataset
    from doc2tex_tpu_torch.tokenizer.converters import create_converter

    over = dict(max_dimension=[96, 320], min_dimension=[32, 32], batch_size=4,
                batch_max_length=12, bucket_mode=mode, bucket_growth=1.5, augment=train,
                pad_jitter=6 if train else 0, vocab=HARD_VOCAB_PATH,
                Prediction={"name": "TFM", "params": {}})
    cj, cp = jax_make_config(over), make_config(over)
    jax = JaxLoader(JaxLmdbDataset(store), jax_converter(cj), cj, train=train, seed=3,
                    prefetch=0)
    port = BucketLoader(LmdbDataset(store), cp, converter=create_converter(cp), train=train,
                        seed=3)
    assert port.table.shapes == jax.table.shapes
    assert port.clusters == jax.clusters and port.excluded == jax.excluded
    n = 0
    for _ in range(2 if train else 1):
        for a, b in zip(jax, port, strict=True):
            assert (a.bucket, a.labels, a.names) == (b.bucket, b.labels, b.names)
            for key in ("images", "text", "lengths"):
                np.testing.assert_array_equal(getattr(a, key), getattr(b, key))
            n += 1
    assert n >= (6 if train else 3)


# ----------------------------------------------------------------- api.infer


TINY_INFER = """max_dimension: [96, 320]
min_dimension: [32, 32]
batch_max_length: 12
bucket_growth: 4.0
dtype: 'float32'
beam_size: 1
vocab: '{vocab}'
character: []
FeatureExtraction:
  name: 'None'
SequenceModeling:
  name: 'ViT'
  params:
    backbone:
      name: 'resnet'
      input_channel: 1
      output_channel: 16
    fix_embed: True
    patching_style: '2d'
    patch_size: [2, 2]
    depth: 1
    num_heads: 2
    hidden_size: 32
Prediction:
  name: 'TFM'
  params:
    d_model: 32
    nhead: 2
    num_decoder_layers: 1
    dim_feedforward: 32
"""


def test_infer_over_lmdb_equals_manifest(tmp_path):
    """``api.infer`` with ``eval_data`` naming a store gives the rows of the
    same config over a PNG manifest of the same images (random weights
    from the CLI's seed; float32, greedy)."""
    from doc2tex_tpu_torch.api import infer

    images, labels = hard_samples(6, seed=8)
    names = [f"im{i}.png" for i in range(6)]
    for img, name in zip(images, names):
        (tmp_path / name).write_bytes(encode_png(img))
    with open(tmp_path / "labels.tsv", "w") as f:
        f.writelines(f"{n}\t{lb}\n" for n, lb in zip(names, labels))
    lmdb_reader.write_lmdb(str(tmp_path / "store"), images, labels, names)
    cfg = TINY_INFER.format(vocab=HARD_VOCAB_PATH)
    (tmp_path / "csv.yaml").write_text(cfg)
    (tmp_path / "lmdb.yaml").write_text(cfg + f"eval_data: '{tmp_path / 'store'}'\n")
    rows = {}
    for kind, extra in (("csv", ["--csv_dir", str(tmp_path / "labels.tsv"),
                                 "--data_dir", str(tmp_path)]), ("lmdb", [])):
        out = tmp_path / f"out_{kind}"
        infer.main(["--config", str(tmp_path / f"{kind}.yaml"), "--log_path", str(out),
                    "--device", "cpu", *extra])
        with open(out / "predictions.csv", newline="") as f:
            rows[kind] = list(csv.reader(f))
    assert rows["lmdb"] == rows["csv"] and len(rows["csv"]) == 7


# ----------------------------------------------------------------- realdata


def jax_realdata():
    """The root ``tools/realdata.py`` (``tools/`` is not a package)."""
    spec = importlib.util.spec_from_file_location(
        "jax_realdata", os.path.join(ROOT, "tools", "realdata.py"))
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


def test_realdata_package_and_lmdb_equal_jax(tmp_path):
    from doc2tex_tpu.data.lmdb_reader import LmdbReader as JaxReader

    from doc2tex_tpu_torch.tools import realdata

    jax = jax_realdata()
    stores = {}
    for side, stages in (("jax", jax), ("port", realdata)):
        work = str(tmp_path / side)
        stages.stage_package_fallback(work, 16)
        stores[side] = stages.stage_lmdb(work)
    with open(tmp_path / "jax" / "labels.tsv") as f, open(tmp_path / "port" / "labels.tsv") as g:
        assert f.read() == g.read()
    want, got = JaxReader(stores["jax"]), lmdb_reader.LmdbReader(stores["port"])
    assert len(want) == len(got) == 16
    for i in range(1, 17):
        assert (want.label(i), want.name(i), want.size(i)) == (got.label(i), got.name(i),
                                                               got.size(i))
        np.testing.assert_array_equal(got.image(i), want.image(i))


def test_chip_smoke_realdata_phase_runs_on_cpu(tmp_path):
    """chip_smoke's realdata phase, (a) and (b), on the CPU at the least size
    that still runs its code: 16 stored samples, a validation store of 4,
    one step of ``tools.realdata``'s small config cut to a ViT 32x1 with
    the coverage head at hidden 32 and ``batch_max_length`` 20, so the
    head's teacher-forced loop stays short.  (c) and the kernel checks of
    (b) need the card."""
    import sys

    from doc2tex_tpu_torch.tools import realdata

    sys.path.insert(0, ROOT)
    import chip_smoke

    text = realdata.SMALL_CONFIG
    for old, new in (("batch_max_length: 150", "batch_max_length: 20"),
                     ("batch_size: 8", "batch_size: 4"), ("output_channel: 128", "output_channel: 16"),
                     ("depth: 2", "depth: 1"), ("num_heads: 4", "num_heads: 2"),
                     ("hidden_size: 128", "hidden_size: 32"), ("input_size: 128", "input_size: 32"),
                     ("kernel_dim: 64", "kernel_dim: 8")):
        assert old in text, old
        text = text.replace(old, new)
    config = tmp_path / "tiny.yaml"
    config.write_text(text)
    chip_smoke.realdata_phase(0.0, device="cpu", n=16, valid_n=4, steps=1, config=str(config),
                              infer_config=None)
