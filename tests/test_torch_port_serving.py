"""The port's serving layer: ``serving.RecognitionServer``, the PNG decoder
and the HTTP front (``api/serve.py``), on the CPU.

- The dispatcher cases of ``tests/test_serving.py`` (``TestDispatcher``,
  ``TestBucketAwareDispatch``, ``TestCoalescedDispatch``) against the
  port's copy, with the cases that repeat each other as parameters.
- ``utils/png.decode_png`` against PIL's ``convert("L")`` over colour types
  0, 2, 3, 4 and 6 and the five row filters, and its refusals.
- The page server cases of ``tests/test_serving.py::TestPageServer`` (round
  trip, pages sharing crop batches, the empty page, detection and crop
  errors reaching the page, submit after close) on a stub detector.
- A localhost HTTP round trip and the ``--selftest`` entry point with a
  tiny random-init recognizer on ``--device cpu``; ``POST /recognize_page``
  answers 404 without detection and regions with it.
"""

from __future__ import annotations

import io
import json
import struct
import threading
import time
import zlib
from http.client import HTTPConnection
from http.server import ThreadingHTTPServer

import numpy as np
import pytest
from PIL import Image

from doc2tex_tpu_torch.api import serve
from doc2tex_tpu_torch.config import make_config
from doc2tex_tpu_torch.data.synthetic import HARD_VOCAB_PATH, synth_sample
from doc2tex_tpu_torch.recognition import MathRecognition
from doc2tex_tpu_torch.recognition.flow import coalesce_groups
from doc2tex_tpu_torch.serving import (PageServer, RecognitionServer, ServerClosed,
                                       ServerOverloaded)
from doc2tex_tpu_torch.utils.png import decode_png, encode_png


class FakeRecognizer:
    """Batch callable that labels images by their [0, 0] pixel and records
    the batch sizes it was called with."""

    def __init__(self, delay_s: float = 0.0, gate: threading.Event = None):
        self.batches = []
        self.shapes = []
        self.delay_s = delay_s
        self.gate = gate
        self.entered = threading.Event()  # set when a batch call begins

    def __call__(self, images):
        self.entered.set()
        if self.gate is not None:
            self.gate.wait(timeout=10.0)
        if self.delay_s:
            time.sleep(self.delay_s)
        self.batches.append(len(images))
        self.shapes.append({im.shape for im in images})
        return [f"px{int(np.asarray(im)[0, 0])}" for im in images]


# ---- the dispatcher (TestDispatcher) ----------------------------------------

def test_results_map_to_requests():
    with RecognitionServer(FakeRecognizer(), batch_window_ms=20) as srv:
        out = srv.recognize_many([np.full((4, 4), v, np.uint8) for v in range(17)], timeout=10.0)
    assert out == [f"px{v}" for v in range(17)]


def test_concurrent_requests_coalesce():
    """The gate holds the dispatcher inside batch 1 while 7 more requests
    queue; releasing it gives exactly one more batch with all 7."""
    gate = threading.Event()
    recog = FakeRecognizer(gate=gate)
    srv = RecognitionServer(recog, max_batch=64, batch_window_ms=0)
    try:
        first = srv.submit(np.zeros((4, 4), np.uint8))
        assert recog.entered.wait(timeout=5.0)
        rest = [srv.submit(np.full((4, 4), v, np.uint8)) for v in range(1, 8)]
        gate.set()
        assert first.result(timeout=10.0) == "px0"
        assert [f.result(timeout=10.0) for f in rest] == [f"px{v}" for v in range(1, 8)]
    finally:
        srv.close()
    assert recog.batches[:2] == [1, 7]
    st = srv.stats()
    assert st["completed"] == 8 and st["batches"] == 2 and st["avg_batch"] == 4.0


def test_max_batch_cap():
    gate = threading.Event()
    recog = FakeRecognizer(gate=gate)
    srv = RecognitionServer(recog, max_batch=3, batch_window_ms=0)
    try:
        futures = [srv.submit(np.full((2, 2), v, np.uint8)) for v in range(10)]
        gate.set()
        assert [f.result(timeout=10.0) for f in futures] == [f"px{v}" for v in range(10)]
    finally:
        srv.close()
    assert max(recog.batches) <= 3


def test_backpressure():
    gate = threading.Event()
    recog = FakeRecognizer(gate=gate)
    srv = RecognitionServer(recog, max_queue=2, batch_window_ms=0)
    try:
        held = srv.submit(np.zeros((2, 2), np.uint8))  # occupies the dispatcher
        assert recog.entered.wait(timeout=5.0)
        srv.submit(np.zeros((2, 2), np.uint8))
        srv.submit(np.zeros((2, 2), np.uint8))
        with pytest.raises(ServerOverloaded):
            srv.submit(np.zeros((2, 2), np.uint8))
        gate.set()
        held.result(timeout=10.0)
    finally:
        srv.close()


def test_recognizer_error_propagates_and_server_survives():
    calls = {"n": 0}

    def flaky(images):
        calls["n"] += 1
        if calls["n"] == 1:
            raise ValueError("boom")
        return ["ok"] * len(images)

    with RecognitionServer(flaky, batch_window_ms=0) as srv:
        with pytest.raises(ValueError, match="boom"):
            srv.submit(np.zeros((2, 2), np.uint8)).result(timeout=10.0)
        assert srv.recognize(np.zeros((2, 2), np.uint8), timeout=10.0) == "ok"
        st = srv.stats()
        assert st["errors"] == 1 and st["completed"] == 1


def test_submit_after_close_raises():
    srv = RecognitionServer(FakeRecognizer(), batch_window_ms=0)
    srv.close()
    with pytest.raises(ServerClosed):
        srv.submit(np.zeros((2, 2), np.uint8))


def test_close_drains_queue():
    srv = RecognitionServer(FakeRecognizer(delay_s=0.01), batch_window_ms=0)
    futures = [srv.submit(np.full((2, 2), v, np.uint8)) for v in range(5)]
    srv.close(drain=True)
    assert [f.result(timeout=1.0) for f in futures] == [f"px{v}" for v in range(5)]


def test_stats_shape():
    with RecognitionServer(FakeRecognizer(), batch_window_ms=0) as srv:
        srv.recognize(np.zeros((2, 2), np.uint8), timeout=10.0)
        st = srv.stats()
    for key in ("requests", "completed", "batches", "errors", "queue_depth", "avg_batch",
                "latency_p50_ms", "latency_p95_ms", "latency_p99_ms", "throughput_rps",
                "uptime_s"):
        assert key in st, key
    assert st["latency_p50_ms"] > 0


# ---- bucket-aware and coalesced dispatch -------------------------------------

def _gated_run(shapes, max_batch=64, ratio=0.0):
    """A warm-up request holds the dispatcher while ``shapes`` queue; on
    release they dispatch keyed by shape.  Returns the recognizer."""
    gate = threading.Event()
    recog = FakeRecognizer(gate=gate)
    srv = RecognitionServer(recog, max_batch=max_batch, batch_window_ms=0,
                            bucket_key=lambda im: im.shape, coalesce_ratio=ratio)
    try:
        warm = srv.submit(np.zeros((2, 2), np.uint8))
        assert recog.entered.wait(timeout=5.0)
        futs = [srv.submit(np.full(s, v, np.uint8)) for v, s in enumerate(shapes)]
        gate.set()
        assert warm.result(timeout=10.0) == "px0"
        assert [f.result(timeout=10.0) for f in futs] == [f"px{v}" for v in range(len(shapes))]
    finally:
        srv.close()
    return recog


def _alternate(a, b, n):
    return [a if v % 2 == 0 else b for v in range(n)]


def test_batches_are_shape_pure():
    recog = _gated_run(_alternate((4, 4), (8, 8), 12))
    assert all(len(s) == 1 for s in recog.shapes)
    assert recog.batches[1:] == [6, 6]   # 12 queued crops in 2 batches, not 12


def test_oldest_bucket_goes_first_and_none_starve():
    recog = _gated_run([(16, 16)] + [(4, 4)] * 8, max_batch=4)
    assert recog.batches[1] == 1          # the rare singleton is oldest
    assert max(recog.batches) <= 4


@pytest.mark.parametrize("shapes,ratio,batches", [
    (_alternate((4, 4), (8, 8), 12), 4.0, [12]),       # area 64 == 4.0 x 16: one batch
    (_alternate((4, 4), (16, 16), 12), 4.0, [6, 6]),   # 256 > 4.0 x 16: apart
    (_alternate((4, 16), (8, 8), 8), 100.0, [4, 4]),   # incomparable: never merge
    (_alternate((4, 4), (8, 8), 12), 0.0, [6, 6]),     # ratio off: shape-pure
], ids=["merge_within_ratio", "ratio_guard", "incomparable", "ratio_off"])
def test_coalesced_dispatch(shapes, ratio, batches):
    assert sorted(_gated_run(shapes, ratio=ratio).batches[1:]) == batches


def test_coalesce_groups_unit():
    groups = {(32, 64): [0, 1], (64, 128): [2], (32, 320): [3]}
    assert coalesce_groups(groups, ratio=4.0) == {(64, 128): [2, 0, 1], (32, 320): [3]}
    assert coalesce_groups(groups, 0.0) == groups
    assert coalesce_groups({(32, 64): [0], (64, 128): [1]}, 2.0) == {(64, 128): [1],
                                                                      (32, 64): [0]}


def tiny_recognizer(**kw) -> MathRecognition:
    """A random-init recognizer at a tiny width on the CPU (greedy)."""
    cfg = make_config(dict(
        max_dimension=[64, 256], min_dimension=[32, 32], batch_max_length=8,
        dtype="float32", clahe=False, bucket_growth=1.5, vocab=HARD_VOCAB_PATH,
        FeatureExtraction={"name": "None"},
        SequenceModeling={"name": "ViT", "params": {
            "backbone": {"name": "resnet", "input_channel": 1, "output_channel": 16},
            "fix_embed": True, "patching_style": "2d", "patch_size": [2, 2],
            "depth": 1, "num_heads": 1, "hidden_size": 16}},
        Prediction={"name": "TFM", "params": {
            "d_model": 16, "nhead": 1, "num_decoder_layers": 1, "dim_feedforward": 16}},
    ))
    return MathRecognition(cfg, None, beam_size=1, device="cpu", **kw)


def test_recognizer_bucket_key_matches_internal_grouping():
    rec = tiny_recognizer()
    rng = np.random.default_rng(7)
    for _ in range(20):
        crop, _ = synth_sample(rng)
        img = rec._preprocess(crop)
        bucket = rec.table.lookup(*img.shape[:2]) or rec.table.shapes[-1]
        assert rec.bucket_key(crop) == bucket


@pytest.mark.parametrize("ratio,invocations", [(1e9, 1), (None, "per bucket")])
def test_recognizer_invocations_for_mixed_batch(ratio, invocations):
    rec = tiny_recognizer(coalesce_ratio=ratio)
    calls = []
    real = rec._decode

    def spy(batch):
        calls.append(batch.shape)
        return real(batch)

    rec._decode = spy
    rng = np.random.default_rng(3)
    crops = [(rng.random((h, w)) * 255).astype(np.uint8)
             for h, w in [(20, 30), (40, 90), (22, 60), (60, 120)]]
    keys = {rec.bucket_key(c) for c in crops}
    assert len(keys) > 1
    assert len(rec(crops)) == len(crops)
    assert len(calls) == (len(keys) if invocations == "per bucket" else invocations)


# ---- PNG ---------------------------------------------------------------------

MODES = {0: "L", 2: "RGB", 3: "P", 4: "LA", 6: "RGBA"}


def _pil_image(color: int, seed: int) -> Image.Image:
    rng = np.random.default_rng(seed)
    h, w = 7, 11
    if color == 3:
        img = Image.fromarray(rng.integers(0, 200, (h, w)).astype(np.uint8), "P")
        img.putpalette(rng.integers(0, 256, 768).astype(np.uint8).tolist())
        return img
    ch = {0: 1, 2: 3, 4: 2, 6: 4}[color]
    arr = rng.integers(0, 256, (h, w, ch)).astype(np.uint8)
    return Image.fromarray(arr[..., 0] if ch == 1 else arr, MODES[color])


def _filtered_png(pil: Image.Image, filters) -> bytes:
    """``pil`` re-encoded with the given row filter on each row (cycled),
    the palette kept: the PNG encoder's forward filters."""
    color = {v: k for k, v in MODES.items()}[pil.mode]
    raw = np.asarray(pil, np.uint8)
    raw = raw.reshape(raw.shape[0], -1)
    bpp = {0: 1, 2: 3, 3: 1, 4: 2, 6: 4}[color]
    h, stride = raw.shape
    rows, prev = [], np.zeros(stride, np.int64)
    for y in range(h):
        cur, kind = raw[y].astype(np.int64), filters[y % len(filters)]
        left = np.concatenate([np.zeros(bpp, np.int64), cur[:-bpp]])
        upleft = np.concatenate([np.zeros(bpp, np.int64), prev[:-bpp]])
        if kind == 0:
            pred = np.zeros(stride, np.int64)
        elif kind == 1:
            pred = left
        elif kind == 2:
            pred = prev
        elif kind == 3:
            pred = (left + prev) // 2
        else:
            p = left + prev - upleft
            pa, pb, pc = abs(p - left), abs(p - prev), abs(p - upleft)
            pred = np.where((pa <= pb) & (pa <= pc), left, np.where(pb <= pc, prev, upleft))
        rows.append(bytes([kind]) + ((cur - pred) % 256).astype(np.uint8).tobytes())
        prev = cur

    def chunk(kind, body):
        return struct.pack(">I", len(body)) + kind + body + struct.pack(
            ">I", zlib.crc32(kind + body) & 0xFFFFFFFF)

    w = pil.size[0]
    out = b"\x89PNG\r\n\x1a\n" + chunk(b"IHDR", struct.pack(">IIBBBBB", w, h, 8, color, 0, 0, 0))
    if color == 3:
        out += chunk(b"PLTE", bytes(pil.getpalette()[:768]))
    return out + chunk(b"IDAT", zlib.compress(b"".join(rows))) + chunk(b"IEND", b"")


@pytest.mark.parametrize("color", list(MODES))
def test_png_decoder_equals_pil(color):
    """Every colour type, rows filtered with each of the five filters (and
    as PIL's own encoder writes them): the bytes of PIL's convert("L")."""
    pil = _pil_image(color, seed=color)
    for data in (_filtered_png(pil, [0, 1, 2, 3, 4]), _filtered_png(pil, [4, 3, 1]),
                 _pil_bytes(pil)):
        want = np.asarray(Image.open(io.BytesIO(data)).convert("L"))
        got = decode_png(data)
        assert got.dtype == np.uint8 and got.shape == want.shape
        np.testing.assert_array_equal(got, want)


def _pil_bytes(pil: Image.Image) -> bytes:
    buf = io.BytesIO()
    pil.save(buf, "PNG")
    return buf.getvalue()


def test_png_decoder_refuses_what_it_does_not_cover():
    """Every PNG decodes as PIL's ``convert("L")`` (16-bit gray too, since
    the decoder covers every bit depth; tests/test_torch_port_lmdb.py holds
    all of them); what is not a PNG, a bit depth PNG does not allow and
    truncated image data raise ValueError."""
    gray = (np.arange(48).reshape(6, 8) * 5).astype(np.uint8)
    assert np.array_equal(decode_png(encode_png(gray)), gray)
    sixteen = io.BytesIO()
    Image.fromarray(gray.astype(np.uint16) * 200).save(sixteen, "PNG")
    with Image.open(io.BytesIO(sixteen.getvalue())) as im:
        assert np.array_equal(decode_png(sixteen.getvalue()), np.asarray(im.convert("L")))
    bad_depth = bytearray(encode_png(gray))
    bad_depth[24] = 3                       # IHDR's bit depth byte
    with pytest.raises(ValueError, match="bit depth 3"):
        decode_png(bytes(bad_depth))
    short = encode_png(np.zeros((6, 8), np.uint8))
    idat = short.index(b"IDAT")
    body = zlib.compress(zlib.decompress(short[idat + 4:short.index(b"IEND") - 8])[:-9])
    with pytest.raises(ValueError, match="shorter"):
        decode_png(short[:idat - 4] + struct.pack(">I", len(body)) + b"IDAT" + body
                   + struct.pack(">I", zlib.crc32(b"IDAT" + body)) + short[-12:])
    jpeg = io.BytesIO()
    Image.fromarray(gray).save(jpeg, "JPEG")
    with pytest.raises(ValueError, match="not a PNG"):
        decode_png(jpeg.getvalue())


# ---- the page server (TestPageServer) ------------------------------------------

def fake_detect_and_crop(page):
    """Deterministic stand-in for App.detect_and_crop: one crop per
    distinct value v in row 0, each crop an (8, 8) field of v."""
    values = sorted(set(int(v) for v in np.asarray(page)[0]))
    return [(v, 0, v + 8, 8) for v in values], [np.full((8, 8), v, np.uint8) for v in values]


def test_page_regions_round_trip():
    with RecognitionServer(FakeRecognizer(), batch_window_ms=5) as crop_srv:
        ps = PageServer(fake_detect_and_crop, crop_srv)
        page = np.zeros((4, 16), np.uint8)
        page[0, :8] = 3
        page[0, 8:] = 9
        out = ps.recognize_page(page, timeout=10.0)
        ps.close()
    assert out == [((3, 0, 11, 8), "px3"), ((9, 0, 17, 8), "px9")]


def test_pages_share_crop_batches():
    """The gate holds the dispatcher inside a warm-up batch while two
    pages' crops queue; on release all four decode in one batch."""
    gate = threading.Event()
    recog = FakeRecognizer(gate=gate)
    crop_srv = RecognitionServer(recog, max_batch=64, batch_window_ms=0)
    try:
        warm = crop_srv.submit(np.zeros((2, 2), np.uint8))
        assert recog.entered.wait(timeout=5.0)
        ps = PageServer(fake_detect_and_crop, crop_srv)
        pages = []
        for base in (10, 20):
            page = np.zeros((4, 16), np.uint8)
            page[0, :8] = base
            page[0, 8:] = base + 1
            pages.append(ps.submit_page(page))
        deadline = time.monotonic() + 5.0
        while crop_srv.stats()["queue_depth"] < 4:
            assert time.monotonic() < deadline
            time.sleep(0.002)
        gate.set()
        assert warm.result(timeout=10.0) == "px0"
        assert [lx for _, lx in pages[0].result(timeout=10.0)] == ["px10", "px11"]
        assert [lx for _, lx in pages[1].result(timeout=10.0)] == ["px20", "px21"]
        ps.close()
    finally:
        crop_srv.close()
    assert recog.batches == [1, 4]


def test_empty_page():
    with RecognitionServer(FakeRecognizer(), batch_window_ms=0) as crop_srv:
        ps = PageServer(lambda page: ([], []), crop_srv)
        assert ps.recognize_page(np.zeros((4, 4), np.uint8), timeout=10.0) == []
        assert ps.stats()["pages"] == 1
        ps.close()


def _boom(page):
    raise RuntimeError("detector exploded")


def _flaky(images):
    raise ValueError("decode failed")


@pytest.mark.parametrize("detect, recognizer, error, match", [
    (_boom, FakeRecognizer(), RuntimeError, "detector exploded"),
    (fake_detect_and_crop, _flaky, ValueError, "decode failed"),
])
def test_detect_and_crop_errors_reach_the_page(detect, recognizer, error, match):
    with RecognitionServer(recognizer, batch_window_ms=0) as crop_srv:
        ps = PageServer(detect, crop_srv)
        page = np.zeros((4, 8), np.uint8)
        page[0, :] = 5
        with pytest.raises(error, match=match):
            ps.recognize_page(page, timeout=10.0)
        ps.close()


def test_page_submit_after_close_raises():
    with RecognitionServer(FakeRecognizer(), batch_window_ms=0) as crop_srv:
        ps = PageServer(fake_detect_and_crop, crop_srv)
        ps.close()
        with pytest.raises(ServerClosed):
            ps.submit_page(np.zeros((2, 2), np.uint8))
        # closing the page server leaves the shared crop server running
        assert crop_srv.recognize(np.zeros((2, 2), np.uint8), timeout=10.0) == "px0"


# ---- the HTTP front and the CLI ----------------------------------------------

@pytest.fixture(scope="module")
def http_server():
    rec = tiny_recognizer()
    srv = RecognitionServer(rec, batch_window_ms=5, bucket_key=rec.bucket_key)
    httpd = ThreadingHTTPServer(("127.0.0.1", 0), serve.build_handler(
        srv, config_info={"model_version": "tiny", "beam_size": 1}))
    thread = threading.Thread(target=httpd.serve_forever, daemon=True)
    thread.start()
    yield httpd.server_address[1], rec
    httpd.shutdown()
    httpd.server_close()
    srv.close()
    thread.join(timeout=10)
    assert not thread.is_alive()


def _request(port, method, path, body=None):
    conn = HTTPConnection("127.0.0.1", port, timeout=60)
    try:
        conn.request(method, path, body=body)
        resp = conn.getresponse()
        return resp.status, resp.read()
    finally:
        conn.close()


def test_http_recognize_round_trip(http_server):
    port, rec = http_server
    crop, _ = synth_sample(np.random.default_rng(5))
    status, body = _request(port, "POST", "/recognize", encode_png(crop))
    assert status == 200
    payload = json.loads(body)
    assert payload["latex"] == rec([crop])[0] and payload["ms"] > 0
    status, body = _request(port, "GET", "/stats")
    assert status == 200 and json.loads(body)["completed"] >= 1
    assert _request(port, "GET", "/config")[1] and json.loads(
        _request(port, "GET", "/config")[1]) == {"model_version": "tiny", "beam_size": 1,
                                                 "detect": False}
    status, body = _request(port, "GET", "/")
    assert status == 200 and b"<html" in body.lower()
    assert _request(port, "POST", "/recognize", b"not an image")[0] == 400
    assert _request(port, "POST", "/recognize_page", encode_png(crop))[0] == 404


def test_http_recognize_page_with_detect():
    """``--detect``: ``build_page_server`` gives a PageServer over the
    released detector (on the CPU here) and ``POST /recognize_page`` with a
    PNG strip of a labelled page returns its regions: boxes inside the page
    and a string each."""
    _check_recognize_page(["--detect"], 400)


def test_http_recognize_page_with_detect_and_stitch():
    """``--detect --stitch``: the same request through the voting stitch, on
    a strip tall enough for 3 rows of windows (a region needs 8 votes)."""
    _check_recognize_page(["--detect", "--stitch"], 768)


def _check_recognize_page(flags, rows):
    from doc2tex_tpu_torch.tools.page_eval import synth_labelled_page

    rec = tiny_recognizer()
    srv = RecognitionServer(rec, batch_window_ms=5, bucket_key=rec.bucket_key)
    args = serve.parse_args(flags + ["--device", "cpu"])
    page_srv = serve.build_page_server(args, rec, srv)
    assert isinstance(page_srv, PageServer)
    assert serve.build_page_server(serve.parse_args(["--device", "cpu"]), rec, srv) is None
    httpd = ThreadingHTTPServer(("127.0.0.1", 0), serve.build_handler(
        srv, page_srv, config_info={"model_version": "tiny", "beam_size": 1}))
    thread = threading.Thread(target=httpd.serve_forever, daemon=True)
    thread.start()
    try:
        port = httpd.server_address[1]
        strip = synth_labelled_page(np.random.default_rng(35))[0][:rows]
        status, body = _request(port, "POST", "/recognize_page", encode_png(strip))
        assert status == 200
        payload = json.loads(body)
        assert payload["ms"] > 0 and len(payload["regions"]) >= 2
        for region in payload["regions"]:
            x1, y1, x2, y2 = region["box"]
            assert 0 <= x1 < x2 <= 1280 and 0 <= y1 < y2 <= rows
            assert isinstance(region["latex"], str)
        assert json.loads(_request(port, "GET", "/config")[1])["detect"] is True
        assert json.loads(_request(port, "GET", "/stats")[1])["pages"] == 1
        assert _request(port, "POST", "/recognize_page", b"not an image")[0] == 400
    finally:
        httpd.shutdown()
        httpd.server_close()
        page_srv.close()
        srv.close()
        thread.join(timeout=10)
    assert not thread.is_alive()


def test_cli_selftest_and_refusals(tmp_path, capsys):
    """``--selftest`` through main() with a tiny version block (no weights
    file: random init), and the flags that wait for later slices."""
    cfg = tmp_path / "recog.yaml"
    cfg.write_text(f"""common:
  vocab: '{HARD_VOCAB_PATH}'
  clahe: False
tiny:
  max_dimension: [64, 256]
  min_dimension: [32, 32]
  batch_max_length: 8
  dtype: 'float32'
  bucket_growth: 2.2
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
      num_heads: 1
      hidden_size: 16
  Prediction:
    name: 'TFM'
    params:
      d_model: 16
      nhead: 1
      num_decoder_layers: 1
      dim_feedforward: 16
  quantize: int8
""")
    base = ["--recog_config", str(cfg), "--model_version", "tiny", "--device", "cpu"]
    assert serve.main(base + ["--selftest", "6", "--beam_size", "1"]) == 0
    out = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert out["selftest"] == 6 and out["completed"] == 6 and out["errors"] == 0
    assert out["quantize"] == "int8" and out["device"] == "cpu" and out["batches"] >= 1
    with pytest.raises(NotImplementedError):
        serve.main(base + ["--platform", "cpu"])
    # --data_parallel is ported: it parses (tests/test_torch_port_smoke.py runs it)
    assert serve.parse_args(base + ["--data_parallel", "2"]).data_parallel == 2
    for flag in (["--detect_weights", "w.msgpack"], ["--stitch"]):
        with pytest.raises(SystemExit, match="needs --detect"):
            serve.main(base + flag)
