"""The port's full-page path against the JAX package, on the CPU.

- the numpy copies (priors, windows, the evaluators) equal the JAX
  package's;
- SSD512 with the released detector weights on one seeded window: loc and
  conf within 1e-4 abs + 1e-4 rel of JAX's, float32;
- decode and per-window NMS on seeded loc/conf, with exactly tied scores
  and windows where nothing passes the threshold: the same keep sets;
- ``MathDetector.detect_page`` and ``crop_regions`` on a seeded 512x768
  page (3 windows): boxes within 1e-3 px of JAX's, crops byte-equal; the
  host-window path against the device-window path;
- ``App.detect_and_crop``'s own logic (resize, boxes and crops filtered
  together, boxes scaled back) against ``demo.app.App`` with both
  detectors returning the same fixed boxes;
- ``detect_preprocess`` byte-equal to PIL's LANCZOS; the page-eval twin's
  ``synth_labelled_page`` byte-equal to ``tools/page_eval.py``'s; the
  twin's scoring on oracle boxes; the detector loader fills every leaf.

The golden pages that ``chip_smoke.py`` holds the card to are written by
the JAX package on the CPU (``PYTHONPATH=. python
tests/test_torch_port_detect.py --write-golden-pages``); the tests only
read them.
"""

from __future__ import annotations

import hashlib
import json
import os
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from doc2tex_tpu_torch import _msgpack
from doc2tex_tpu_torch.detection import boxes as tboxes
from doc2tex_tpu_torch.detection import evaluate as teval
from doc2tex_tpu_torch.detection import priors as tpriors
from doc2tex_tpu_torch.detection import windows as twindows
from doc2tex_tpu_torch.detection.flow import SHIPPED_WEIGHTS, MathDetector
from doc2tex_tpu_torch.detection.ssd import SSD512
from doc2tex_tpu_torch.transforms.preprocess import detect_preprocess
from doc2tex_tpu_torch.weights import convert_variables, load_weights

HERE = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(HERE)
GOLDEN_PAGES = os.path.join(HERE, "torch_port_golden_pages.json")
N_GOLDEN_PAGES = 3
sys.path.insert(0, os.path.join(ROOT, "tools"))


def _jax_page_eval():
    import page_eval

    return page_eval


def _test_page(seed: int = 35) -> np.ndarray:
    """A 512x768 page cut from the first labelled page of ``seed``: the
    top-left corner, which holds formulas and formula edges."""
    from doc2tex_tpu_torch.tools.page_eval import synth_labelled_page

    return np.ascontiguousarray(synth_labelled_page(np.random.default_rng(seed))[0][:512, :768])


@pytest.fixture(scope="module")
def detectors():
    """(JAX MathDetector, port MathDetector on the CPU), both with the
    released weights."""
    from doc2tex_tpu.detection.flow import MathDetector as JaxDetector

    return JaxDetector(weights_path=SHIPPED_WEIGHTS), MathDetector(SHIPPED_WEIGHTS, device="cpu")


# ---- the numpy copies ---------------------------------------------------------

def test_priors_and_windows_equal_jax():
    from doc2tex_tpu.detection import priors, windows

    p = tpriors.make_priors()
    assert p.shape == (65532, 4)
    np.testing.assert_array_equal(p, priors.make_priors())
    rng = np.random.default_rng(3)
    for shape in ((600, 700), (512, 512), (300, 1400, 3)):
        page = rng.integers(0, 256, shape).astype(np.uint8)
        for stride in ((128, 128), (512, 512)):
            a, ia = windows.rolling_windows(page, stride)
            b, ib = twindows.rolling_windows(page, stride)
            assert ia == ib and np.array_equal(a, b)
    info = [(0, 0, 512, 512), (128, 0, 300, 512), (0, 128, 512, 200)]
    bx = rng.random((3, 20, 4)).astype(np.float32)
    bx[..., 2:] = np.minimum(bx[..., :2] + rng.random((3, 20, 2)).astype(np.float32) * 0.3, 1)
    sc = (rng.random((3, 20)) * (rng.random((3, 20)) > 0.3)).astype(np.float32)
    for thresh in (0.0, 0.5):
        for a, b in zip(windows.unmap_boxes(bx, sc, info, score_thresh=thresh),
                        twindows.unmap_boxes(bx, sc, info, score_thresh=thresh)):
            np.testing.assert_array_equal(a, b)
    assert twindows.unmap_boxes(bx, sc * 0, info)[0].shape == (0, 4)
    page_boxes = windows.unmap_boxes(bx, sc, info)[0]
    for frac in (0.0, 0.05, 0.2):
        np.testing.assert_array_equal(windows.expand_boxes(page_boxes, (600, 700), frac),
                                      twindows.expand_boxes(page_boxes, (600, 700), frac))


def test_evaluators_equal_jax():
    from doc2tex_tpu.detection import evaluate

    rng = np.random.default_rng(7)
    preds, gts = [], []
    for n_pred, n_gt in ((6, 5), (0, 3), (4, 0), (9, 9), (3, 3)):
        gt = rng.random((n_gt, 2)) * 400
        gt = np.concatenate([gt, gt + 20 + rng.random((n_gt, 2)) * 100], 1).astype(np.float32)
        pb = np.concatenate([gt[: n_pred // 2] + rng.normal(0, 8, (min(n_pred // 2, n_gt), 4)),
                             rng.random((n_pred - min(n_pred // 2, n_gt), 4)) * 300], 0)
        pb[:, 2:] = np.maximum(pb[:, 2:], pb[:, :2] + 5)
        pb = pb.astype(np.float32)
        if n_pred == 3:                      # duplicate detections of one box
            pb = np.repeat(gt[:1], 3, 0)
        preds.append((pb, rng.random(len(pb)).astype(np.float32)))
        gts.append(gt)
    for (pb, ps), gb in zip(preds, gts):
        np.testing.assert_array_equal(evaluate.iou_matrix(pb, gb), teval.iou_matrix(pb, gb))
        for thr in (0.3, 0.5, 0.75):
            assert evaluate.match_detections(pb, ps, gb, thr) == teval.match_detections(
                pb, ps, gb, thr)
    assert evaluate.evaluate_detections(preds, gts) == teval.evaluate_detections(preds, gts)
    dets = [p for p, _ in preds]
    assert evaluate.crohme_detection_scores(dets, gts) == teval.crohme_detection_scores(dets, gts)


# ---- SSD512, decode and NMS -----------------------------------------------------

def test_ssd512_with_released_weights_matches_jax(detectors):
    jdet, tdet = detectors
    x = (np.random.default_rng(0).integers(0, 256, (1, 512, 512, 3)).astype(np.float32)
         - np.float32(246))
    jloc, jconf = jax.jit(jdet.model.apply)(jdet.variables, jnp.asarray(x))
    with torch.inference_mode():
        loc, conf = tdet.model(torch.from_numpy(x).permute(0, 3, 1, 2).contiguous())
    assert loc.shape == (1, 65532, 4) and conf.shape == (1, 65532, 2)
    for got, want in ((loc, jloc), (conf, jconf)):
        want = np.asarray(want)
        np.testing.assert_allclose(got.numpy(), want, atol=1e-4, rtol=1e-4)


def _seeded_loc_conf(seed: int = 5, B: int = 4, N: int = 3000):
    """loc/conf logits for B windows of N priors: window 1 has 40 exactly
    tied scores at the top, window 2 none above the threshold, window 3
    1500 tied scores above it (the top 200 taken by index)."""
    rng = np.random.default_rng(seed)
    loc = rng.normal(0, 1, (B, N, 4)).astype(np.float32)
    conf = rng.normal(0, 1.5, (B, N, 2)).astype(np.float32)
    conf[1, 100:140] = (0.0, 3.0)             # equal logit pairs: equal scores
    conf[2, :, 1] = conf[2, :, 0] - 1.0       # every score below 0.5
    conf[3, ::2] = (0.0, 2.0)
    return loc, conf


@pytest.mark.parametrize("iou", [0.1, 0.45])
def test_decode_and_batched_detect_match_jax(iou):
    from doc2tex_tpu.detection import boxes as jboxes

    loc, conf = _seeded_loc_conf()
    priors = np.random.default_rng(1).random((loc.shape[1], 4)).astype(np.float32) * 0.5
    priors[:, :2] += 0.25
    jdec = np.asarray(jboxes.decode_boxes(jnp.asarray(loc), jnp.asarray(priors)))
    tdec = tboxes.decode_boxes(torch.from_numpy(loc), torch.from_numpy(priors)).numpy()
    np.testing.assert_allclose(tdec, jdec, atol=1e-6, rtol=1e-6)
    jb, js = jboxes.batched_detect(jnp.asarray(loc), jnp.asarray(conf), jnp.asarray(priors),
                                   iou_thresh=iou)
    tb, ts = tboxes.batched_detect(torch.from_numpy(loc), torch.from_numpy(conf),
                                   torch.from_numpy(priors), iou_thresh=iou)
    jb, js, tb, ts = map(np.asarray, (jb, js, tb, ts))
    assert ts.shape == (4, 200) and tb.shape == (4, 200, 4)
    assert np.array_equal(ts > 0, js > 0)                  # the same keep sets, in order
    np.testing.assert_allclose(ts, js, atol=1e-6, rtol=0)
    np.testing.assert_allclose(tb, jb, atol=1e-6, rtol=1e-6)
    assert (ts[2] == 0).all() and (ts[1] > 0).sum() >= 1   # nothing passes in window 2


def test_nms_ties_and_zero_scores():
    """Equal scores keep the lower index first (``lax.top_k``'s order); a
    box scored 0 suppresses nothing; ``nms_fixed`` equals JAX's on them."""
    from doc2tex_tpu.detection.boxes import nms_fixed as jax_nms

    boxes = np.array([[0, 0, 10, 10], [1, 1, 11, 11], [20, 20, 30, 30], [21, 21, 31, 31],
                      [0, 0, 10, 10], [40, 40, 50, 50]], np.float32) / 64
    scores = np.array([0.7, 0.7, 0.0, 0.6, 0.9, 0.0], np.float32)
    kb, ks = tboxes.nms_fixed(torch.from_numpy(boxes)[None], torch.from_numpy(scores)[None],
                              0.1, 4)
    jb, js = jax_nms(jnp.asarray(boxes), jnp.asarray(scores), 0.1, 4)
    np.testing.assert_array_equal(ks[0].numpy(), np.asarray(js))
    np.testing.assert_array_equal(kb[0].numpy(), np.asarray(jb))
    # order: 0.9 (index 4), then index 0 before index 1 (tied), then 0.6
    np.testing.assert_array_equal(ks[0].numpy(), np.array([0.9, 0, 0, 0.6], np.float32))


# ---- the detector on a page, and App ---------------------------------------------

def test_detect_page_and_crops_match_jax(detectors):
    jdet, tdet = detectors
    page = _test_page()
    assert len(tdet.page_windows(page)[1]) == 3
    jb, js = jdet.detect_page(page)
    tb, ts = tdet.detect_page(page)
    assert len(tb) >= 1 and tb.shape == jb.shape
    np.testing.assert_allclose(tb, jb, atol=1e-3, rtol=0)
    np.testing.assert_allclose(ts, js, atol=1e-5, rtol=0)
    for a, b in zip(tdet.crop_regions(page, tb), jdet.crop_regions(page, jb)):
        assert a.shape == b.shape and np.array_equal(a, b)


def test_detect_page_off_the_ladder_matches_jax(detectors):
    """A 400x700 page (white-padded to 512x768 on the device, 3 windows)
    cut through formulas at its bottom and right edges: some windows' boxes
    reach into the pad and are clipped back to the page; the candidates,
    the final boxes and the crops equal JAX's."""
    from doc2tex_tpu_torch.tools.page_eval import synth_labelled_page

    jdet, tdet = detectors
    full = synth_labelled_page(np.random.default_rng(35))[0]
    page = np.ascontiguousarray(full[420:820, 250:950])
    windows, info = tdet.page_windows(page)
    assert windows.shape == (3, 512, 512, 1)
    boxes, scores, _ = tdet._window_detections(page)
    unclipped, _ = twindows.unmap_boxes(boxes, scores, info, 512, score_thresh=0.0)
    assert (unclipped[:, 2] > 700).any() and (unclipped[:, 3] > 400).any()
    cb, cs = tdet.page_candidates(page)
    jcb, jcs = jdet.detect_page(page, raw=True)
    assert cb.shape == jcb.shape
    np.testing.assert_allclose(cb, jcb, atol=1e-3, rtol=0)
    np.testing.assert_allclose(cs, jcs, atol=1e-5, rtol=0)
    jb, js = jdet.detect_page(page)
    tb, ts = tdet.detect_page(page)
    assert tb.shape == jb.shape and (tb[:, 2] == 700).any() and (tb[:, 3] == 400).any()
    np.testing.assert_allclose(tb, jb, atol=1e-3, rtol=0)
    np.testing.assert_allclose(ts, js, atol=1e-5, rtol=0)
    for a, b in zip(tdet.crop_regions(page, tb), jdet.crop_regions(page, jb)):
        assert a.shape == b.shape and np.array_equal(a, b)


@pytest.mark.parametrize("hw,channels,stride", [
    ((400, 700), 0, (128, 128)), ((1024, 1280), 0, (128, 128)), ((300, 520), 3, (128, 128)),
    ((600, 900), 0, (100, 100)), ((512, 768), 3, (96, 128))])
def test_page_windows_are_rolling_windows_of_the_padded_page(hw, channels, stride):
    """The device path's windows (cut by ``unfold`` where the stride tiles
    the ladder, else ``rolling_windows``'s center-padded ones) and grid are
    those JAX cuts from the page padded to the 256 ladder."""
    rng = np.random.default_rng(sum(hw))
    page = rng.integers(0, 256, hw + ((channels,) if channels else ())).astype(np.uint8)
    det = MathDetector(stride=stride, device="cpu")
    windows, info = det.page_windows(page)
    want, want_info = twindows.rolling_windows(MathDetector._snap_page(page), stride, 512)
    assert info == want_info and windows.dtype == torch.uint8
    np.testing.assert_array_equal(windows.numpy(), want)


def test_detector_turns_tf32_off_for_its_forward(monkeypatch):
    """SSD512 runs with cuDNN's TF32 off whatever the process sets (torch's
    default is on), and the process's setting is back after the call."""
    seen = []

    class Stub(torch.nn.Module):
        def forward(self, x):
            seen.append(torch.backends.cudnn.allow_tf32)
            B = x.shape[0]
            return torch.zeros(B, 65532, 4), torch.zeros(B, 65532, 2)

    det = MathDetector(device="cpu")
    monkeypatch.setattr(det, "model", Stub())
    page = np.full((512, 768), 255, np.uint8)
    prev = torch.backends.cudnn.allow_tf32
    try:
        for flag in (True, False):
            torch.backends.cudnn.allow_tf32 = flag
            det.detect_page(page)
            windows, _ = det.page_windows(page)
            det.ssd(det.model_input(windows))
            assert torch.backends.cudnn.allow_tf32 == flag
    finally:
        torch.backends.cudnn.allow_tf32 = prev
    assert seen == [False] * 4


def test_host_windows_equal_device_windows(monkeypatch):
    """With a stand-in for SSD512 (so no full forward runs), the host path
    (``rolling_windows`` in chunks padded with white windows) and the
    device path give the same boxes on a ladder-aligned page."""
    class Stub(torch.nn.Module):
        def forward(self, x):            # a score per prior from the window's ink
            B = x.shape[0]
            ink = (x.mean(1) < -100).float()                           # (B, 512, 512)
            pooled = torch.nn.functional.avg_pool2d(ink[:, None], 8)[:, 0]   # (B, 64, 64)
            logit = (pooled.reshape(B, -1, 1).expand(-1, -1, 12).reshape(B, -1) * 8 - 2)
            conf = torch.zeros(B, 65532, 2)
            conf[:, : logit.shape[1], 1] = logit
            return torch.zeros(B, 65532, 4), conf

    page = np.full((512, 1024), 255, np.uint8)
    page[100:160, 50:400] = 0
    page[300:340, 600:900] = 0
    results = []
    for device_windows in (True, False):
        det = MathDetector(device_windows=device_windows, batch_size=2, device="cpu")
        monkeypatch.setattr(det, "model", Stub())
        results.append(det.detect_page(page))
    assert len(results[0][0]) >= 2
    for a, b in zip(*results):
        np.testing.assert_array_equal(a, b)


def test_app_detect_and_crop_matches_demo_app(detectors, monkeypatch):
    """Resize to width 1280, the crops, boxes and crops filtered together
    (an empty crop drops its box), boxes scaled back to the page: the same
    as ``demo.app.App`` when both detectors return the same boxes."""
    import demo.app as demo_app

    from doc2tex_tpu_torch.app import App

    jdet, tdet = detectors
    rng = np.random.default_rng(11)
    page = rng.integers(0, 256, (700, 900)).astype(np.uint8)
    fixed = np.array([[10.4, 20.7, 300.2, 80.9], [500.0, 600.5, 500.9, 650.0],
                      [1000.6, 900.1, 1280.0, 995.0], [0.0, 0.0, 1.5, 1.2]], np.float32)
    scores = np.array([0.9, 0.8, 0.7, 0.6], np.float32)

    jax_app = demo_app.App(use_detect=True, recognizer=lambda crops: ["x"] * len(crops),
                           detect_weights=jdet.variables)
    port_app = App(use_detect=True, recognizer=lambda crops: ["x"] * len(crops), device="cpu")
    for app in (jax_app, port_app):
        monkeypatch.setattr(app.detector, "detect_page", lambda p: (fixed.copy(), scores))
    jboxes, jcrops = jax_app.detect_and_crop(page)
    tboxes_, tcrops = port_app.detect_and_crop(page)
    assert tboxes_ == jboxes and len(tboxes_) == 3          # the empty crop went with its box
    assert all(np.array_equal(a, b) for a, b in zip(tcrops, jcrops))
    assert port_app(page) == jax_app(page)
    no_detect = App(use_detect=False, recognizer=lambda crop: "y", device="cpu")
    assert no_detect.detect_and_crop(page)[0] == [(0, 0, 900, 700)]
    assert no_detect(page) == [((0, 0, 900, 700), "y")]
    # the voting stitch is ported (tests/test_torch_port_stitch.py holds it);
    # bf16 detection still raises
    stitching = App(stitch=True, recognizer=lambda c: c, device="cpu")
    assert stitching.stitch and stitching.stitch_votes == 8
    with pytest.raises(NotImplementedError, match="A7"):
        App(detect_quantize="bf16", recognizer=lambda c: c, device="cpu")


def test_app_cli_reads_a_png_page(tmp_path, capsys):
    """``python -m doc2tex_tpu_torch.app page.png`` with a tiny version
    block (random init) and ``--no_detect``: one region, the whole page."""
    from doc2tex_tpu_torch.app import _cli
    from doc2tex_tpu_torch.data.synthetic import HARD_VOCAB_PATH
    from doc2tex_tpu_torch.utils.png import encode_png

    cfg = tmp_path / "recog.yaml"
    cfg.write_text(f"""common:
  vocab: '{HARD_VOCAB_PATH}'
  clahe: False
tiny:
  max_dimension: [64, 256]
  min_dimension: [32, 32]
  batch_max_length: 4
  dtype: 'float32'
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
""")
    page = tmp_path / "page.png"
    page.write_bytes(encode_png(np.full((40, 120), 255, np.uint8)))
    base = [str(page), "--recog_config", str(cfg), "--model_version", "tiny", "--device", "cpu"]
    _cli(base + ["--no_detect"])
    box, latex = capsys.readouterr().out.rstrip("\n").split("\t")
    assert box == "(0, 0, 120, 40)" and isinstance(latex, str)
    _cli(base + ["--stitch"])                      # a white page: no region to stitch
    assert capsys.readouterr().out == ""


@pytest.mark.parametrize("hw", [(900, 1280), (1650, 1275), (700, 640), (400, 2000),
                                (1024, 1300), (500, 1281), (3000, 1279), (40, 9),
                                (300, 700, 3)])
def test_detect_preprocess_equals_pil(hw):
    import demo.app as demo_app

    page = np.random.default_rng(hw[0] * 7 + hw[1]).integers(0, 256, hw).astype(np.uint8)
    want, want_scale = demo_app.detect_preprocess(page)
    got, scale = detect_preprocess(page)
    assert scale == want_scale and got.dtype == np.uint8
    assert got.shape == want.shape and np.array_equal(got, want)
    if hw[1] == 1280:
        assert got is page


def test_synth_labelled_page_equals_reference():
    from doc2tex_tpu_torch.tools.page_eval import synth_labelled_page

    jax_rng, rng = np.random.default_rng(35), np.random.default_rng(35)
    for _ in range(2):
        jpage, jboxes, jlabels = _jax_page_eval().synth_labelled_page(jax_rng)
        page, boxes, labels = synth_labelled_page(rng)
        assert np.array_equal(page, jpage) and boxes == jboxes and labels == jlabels


def test_page_eval_twin_scores_oracle_boxes():
    """The twin's matching and metrics on 2 pages with the ground-truth
    boxes as detections (no detector forward) and a tiny recognizer that
    reads nothing: every region detected, none transcribed."""
    from doc2tex_tpu_torch.tools.page_eval import evaluate, result_key

    class Reader:
        beam_size, coalesce_ratio, config = 1, 0.0, {"quantize": None}

        def __call__(self, crops):
            return ["?"] * len(crops)

    row = evaluate(pages=2, oracle_boxes=True, device="cpu", recognizer=Reader())
    assert row["gt_regions"] >= 10 and row["det_precision"] == row["det_recall"] == 1.0
    assert row["end_to_end_acc"] == 0.0 and row["em_matched_ci"][0] == 0.0
    assert result_key("synthetic_tfm_big", 40) == "synthetic_tfm_big_p40"
    assert result_key("synthetic_tfm_big", 40, 8.0) == "synthetic_tfm_big_co8_p40"


def test_detector_loader_consumes_every_leaf():
    variables = _msgpack.load(SHIPPED_WEIGHTS)
    assert len(convert_variables(variables)) == 79     # 39 convs x (kernel, bias) + L2Norm
    model = SSD512()
    assert load_weights(model, SHIPPED_WEIGHTS) == 79
    kernel = variables["params"]["Conv_13"]["kernel"]  # the dilated conv6, HWIO float16
    assert torch.equal(model.Conv_13.kernel,
                       torch.from_numpy(kernel.astype(np.float32).transpose(3, 2, 0, 1)))
    assert model.L2Norm_0.weight.dtype == torch.float32
    with pytest.raises(NotImplementedError, match="A7"):
        MathDetector(quantize="int8", device="cpu")


def test_golden_pages_regenerate():
    """The golden file's pages are the first pages of seed 35, and its
    regions line up with its boxes."""
    from doc2tex_tpu_torch.tools.page_eval import synth_labelled_page

    with open(GOLDEN_PAGES) as f:
        golden = json.load(f)
    rng = np.random.default_rng(golden["seed"])
    assert len(golden["pages"]) == N_GOLDEN_PAGES
    for g in golden["pages"]:
        page, gt_boxes, _ = synth_labelled_page(rng)
        assert hashlib.sha256(page.tobytes()).hexdigest() == g["sha256"]
        assert [list(b) for b in gt_boxes] == g["gt_boxes"]
        assert len(g["boxes"]) == len(g["scores"]) >= len(g["regions"]) >= 1


def write_golden_pages(n_pages: int = N_GOLDEN_PAGES) -> None:
    """Run ``demo.app.App`` (the released detector in float32, page NMS; the
    float32 ``synthetic_tfm_big`` recognizer, beam 10) on the first pages
    of seed 35 on the CPU and write its detections and strings.

    The detector goes through its host-window path, 5 windows a batch, to
    bound the CPU's memory: on a 1024x1280 page every window lies inside
    the page, so the windows are those of the default device path."""
    jax.config.update("jax_platforms", "cpu")
    jax.config.update("jax_default_matmul_precision", "float32")
    import demo.app as demo_app
    from doc2tex_tpu.recognition.flow import MathRecognition as JaxRecognition
    from doc2tex_tpu.recognition.flow import load_recog_config as jax_load

    cfg, weights = jax_load(version="synthetic_tfm_big")
    cfg["dtype"], cfg["quantize"] = "float32", None
    recog = JaxRecognition(cfg, weights, beam_size=10)
    app = demo_app.App(use_detect=True, recognizer=recog)
    app.detector.device_windows, app.detector.batch_size = False, 5
    rng = np.random.default_rng(_jax_page_eval().EVAL_SEED)
    pages = []
    for _ in range(n_pages):
        page, gt_boxes, labels = _jax_page_eval().synth_labelled_page(rng)
        resized, scale = demo_app.detect_preprocess(page)
        assert scale == 1.0 and np.array_equal(resized, page)
        seen = []
        detect_page = app.detector.detect_page
        app.detector.detect_page = lambda p: seen.append(detect_page(p)) or seen[-1]
        regions = app(page)
        app.detector.detect_page = detect_page
        boxes, scores = seen[0]
        pages.append({
            "sha256": hashlib.sha256(page.tobytes()).hexdigest(),
            "gt_boxes": [list(b) for b in gt_boxes], "labels": labels,
            "boxes": boxes.tolist(), "scores": scores.tolist(),
            "regions": [{"box": list(map(int, b)), "latex": t} for b, t in regions],
        })
        print(f"page {len(pages)}: {len(boxes)} boxes, {len(regions)} regions", flush=True)
    golden = {
        "seed": _jax_page_eval().EVAL_SEED, "page_hw": list(page.shape),
        "detector": "saved_models/math_detect/best_weights.msgpack", "detector_dtype": "float32",
        "conf_thresh": 0.5, "nms_iou": 0.1, "expand_frac": 0.05,
        "recognizer": {"version": "synthetic_tfm_big", "dtype": "float32", "quantize": None,
                       "beam": 10, "coalesce_ratio": recog.coalesce_ratio},
        "pages": pages,
    }
    with open(GOLDEN_PAGES, "w") as f:
        json.dump(golden, f, indent=1, ensure_ascii=False)
        f.write("\n")


if __name__ == "__main__":
    if sys.argv[1:] != ["--write-golden-pages"]:
        sys.exit("usage: PYTHONPATH=. python tests/test_torch_port_detect.py --write-golden-pages")
    write_golden_pages()
