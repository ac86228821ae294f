"""The port's detector training against the JAX package's, on the CPU.

- the structured generator: the sha256 of crops and labels and the
  generator state after the call, for 3 seeds, at ``detection_soak``'s
  (3, 20, 120, 400), ``page_eval``'s (4, 30, 160, 520) and the default
  kwargs; ``synth_labelled_page(style="structured")`` byte-equal to
  ``tools/page_eval.py``'s; the loader's ``structured`` batches equal to
  JAX's; the structured soak arm's config equal to
  ``tools/structured_soak.build``'s, and the arm's run at a tiny width;
- ``multibox_loss`` and ``focal_loss``: values and gradients with respect
  to loc and conf against ``jax.value_and_grad`` at the real prior count
  (65,532), on random loc/conf and crafted ground truth (a shared best
  prior, padding rows, a box whose best prior is 0 before padding rows, a
  box with no prior at IoU >= 0.5, a window without a box, tied losses at
  the mining threshold): values within 1e-5 relative, every gradient
  entry within 1e-5 of the gradient's largest magnitude;
- ``read_pmath``, ``window_targets`` and ``GTDBDetectionDataset`` on a
  temporary directory of PNG pages (grey and RGB, written by PIL): equal
  samples and batch order; JPEG pages raise naming ROADMAP A11;
- one float32 train step at batch 1 from the shipped detector against
  JAX's ``make_detection_train_step`` with ``optax.adam(1e-4)``, at the
  gates of ``chip_smoke.py``'s detect_train phase (a): the loss within
  1e-5 relative, every gradient leaf within 1e-3 of its norm or
  ``SPREAD_FACTOR`` times the port's own spread under a 1e-7 weight
  perturbation, at most 5 % of the weights further than 1e-6 apart after
  the step (the gradients are read back from Adam's first moment, which
  is 0.1 g after one step, on both sides);
- the soak twin's pool builder and held-out set against the JAX tool's
  functions; a port ``--save`` loads in JAX's ``MathDetector`` with the
  same boxes on a window, and a JAX checkpoint in the port's.

The golden file ``chip_smoke.py`` holds the card to is written by the JAX
package on the CPU (``PYTHONPATH=. python tests/test_torch_port_detect_train.py
--write-golden``, ~2 min); the tests only read it.
"""

from __future__ import annotations

import hashlib
import importlib.util
import json
import os
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from doc2tex_tpu_torch.data import synthetic as tsynth
from doc2tex_tpu_torch.detection import data as tdata
from doc2tex_tpu_torch.detection import loss as tloss
from doc2tex_tpu_torch.detection.flow import SHIPPED_WEIGHTS, MathDetector
from doc2tex_tpu_torch.detection.priors import make_priors
from torch_port_threads import one_torch_thread  # noqa: F401

HERE = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(HERE)
GOLDEN = os.path.join(HERE, "torch_port_golden_detect_soak.json")
GOLDEN_BATCH = 8
GOLDEN_STEPS = 3          # Adam steps of the golden, on the pool's windows in order
WEIGHT_NOISE = 1e-7
SPREAD_FACTOR = 4.0
TOL = {"loss_rtol": 1e-5, "grad_rtol": 1e-3, "grad_floor": 1e-5, "param_far_share": 0.05}


def _jax_tool(name: str):
    """A module of the repository's ``tools/`` (its own imports resolved)."""
    sys.path.insert(0, os.path.join(ROOT, "tools"))
    spec = importlib.util.spec_from_file_location(f"jax_{name}",
                                                  os.path.join(ROOT, "tools", f"{name}.py"))
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


# ---- the structured generator ---------------------------------------------------

STRUCT_KW = {"detection_soak": dict(min_len=3, max_len=20, max_h=120, max_w=400),
             "page_eval": dict(min_len=4, max_len=30, max_h=160, max_w=520),
             "defaults": {}}


def _digest(sample_fn, rng, n=6):
    h = hashlib.sha256()
    for _ in range(n):
        img, label = sample_fn(rng)
        h.update(np.asarray(img.shape, np.int64).tobytes() + img.tobytes() + label.encode())
    return h.hexdigest(), json.dumps(rng.bit_generator.state, sort_keys=True)


@pytest.mark.parametrize("kw", list(STRUCT_KW), ids=list(STRUCT_KW))
def test_structured_sample_equals_jax(kw):
    from doc2tex_tpu.data import synthetic as jsynth

    for seed in (0, 7, 31):
        want = _digest(lambda r: jsynth.synth_structured_sample(r, **STRUCT_KW[kw]),
                       np.random.default_rng(seed))
        got = _digest(lambda r: tsynth.synth_structured_sample(r, **STRUCT_KW[kw]),
                      np.random.default_rng(seed))
        assert got == want
    ji, jl = jsynth.synth_structured_dataset(5, seed=3, **STRUCT_KW[kw])
    ti, tl = tsynth.synth_structured_dataset(5, seed=3, **STRUCT_KW[kw])
    assert tl == jl and all(np.array_equal(a, b) for a, b in zip(ti, ji))


def test_structured_labelled_page_equals_jax():
    from doc2tex_tpu_torch.tools.page_eval import synth_labelled_page

    jpe = _jax_tool("page_eval")
    for style, n in (("structured", 6), ("hard", 3)):
        a, b = np.random.default_rng(35), np.random.default_rng(35)
        for _ in range(2):
            page, boxes, labels = synth_labelled_page(a, n_regions=n, style=style)
            jpage, jboxes, jlabels = jpe.synth_labelled_page(b, n_regions=n, style=style)
            assert np.array_equal(page, jpage) and boxes == jboxes and labels == jlabels
        assert a.bit_generator.state == b.bit_generator.state


def test_structured_loader_batches_equal_jax():
    from doc2tex_tpu.config import make_config as jax_make_config
    from doc2tex_tpu.data.loader import build_loader as jax_build_loader
    from doc2tex_tpu.tokenizer.converters import AttnLabelConverter as JaxAttn
    from doc2tex_tpu_torch.config import make_config
    from doc2tex_tpu_torch.data.loader import build_loader
    from doc2tex_tpu_torch.tokenizer.converters import AttnLabelConverter

    cfg = dict(max_dimension=[160, 448], min_dimension=[32, 32], batch_max_length=48,
               batch_size=4, keep_smaller_batches=True, bucket_growth=2.2, augment=False,
               synthetic_data=24, synthetic_style="structured",
               synthetic_kwargs=dict(min_len=4, max_len=20, max_h=156, max_w=440))
    vocab = list(tsynth.SYNTH_VOCAB)
    jtrain, jvalid = jax_build_loader(jax_make_config(cfg), JaxAttn(vocab), seed=4)
    ttrain, tvalid = build_loader(make_config(cfg), AttnLabelConverter(vocab), seed=4)
    for tl, jl in ((ttrain, jtrain), (tvalid, jvalid)):
        n = 0
        for g, w in zip(tl, jl):
            assert g.bucket == w.bucket and g.labels == w.labels
            assert np.array_equal(g.images, w.images) and np.array_equal(g.text, w.text)
            n += 1
        assert n >= 1


def test_structured_soak_arm_matches_jax(monkeypatch):
    """The soak twin's default arm: ``structured_soak.build``'s config, its
    own tag, and the structured data at the JAX tool's kwargs."""
    from doc2tex_tpu_torch.tools import structured_soak

    monkeypatch.setattr(jax.config, "update", lambda *a, **k: None)
    jsoak = _jax_tool("structured_soak")
    args = structured_soak.parse_args(["--steps", "1000", "--n_train", "6", "--n_eval", "3"])
    assert structured_soak.arm_config(args) == dict(jsoak.build(1000))
    assert structured_soak.run_tag(args) == "structured"
    tr_i, tr_l, ev_i, ev_l = structured_soak.soak_data(args)
    from doc2tex_tpu.data.synthetic import synth_structured_dataset

    ji, jl = synth_structured_dataset(6, seed=31, min_len=4, max_len=44, max_h=156, max_w=440)
    assert tr_l == jl and all(np.array_equal(a, b) for a, b in zip(tr_i, ji))
    assert len(ev_i) == len(ev_l) == 3


def test_structured_soak_arm_runs_on_cpu(tmp_path, monkeypatch):
    """The structured arm end to end at a tiny width (its ``build`` swapped
    for a tiny coverage-LSTM recipe, samples cut): device pools of
    structured crops, 2 steps, a beam-5 validation on the flat vocabulary,
    its checkpoint and curve."""
    from doc2tex_tpu_torch.config import make_config
    from doc2tex_tpu_torch.tools import structured_soak

    tiny = dict(max_dimension=[64, 256], min_dimension=[32, 32], batch_max_length=12,
                batch_size=4, keep_smaller_batches=False, bucket_growth=2.2, augment=False,
                beam_size=5, FeatureExtraction={"name": "None"},
                SequenceModeling={"name": "ViT", "params": {
                    "backbone": {"name": "resnet", "input_channel": 1, "output_channel": 16,
                                 "gcb": False},
                    "fix_embed": True, "input_channel": 1, "patching_style": "2d",
                    "patch_size": [2, 2], "depth": 1, "num_heads": 2, "hidden_size": 16}},
                Prediction={"name": "Attnv2", "params": {
                    "seqmodel": "TFM", "input_size": 16, "hidden_size": 16, "kernel_size": 2,
                    "kernel_dim": 8, "embed_target": True, "enc_init": True,
                    "attn_type": "coverage", "droprate": 0.1}},
                optimizer={"opt": "adamw", "lr": 1e-3, "weight_decay": 2e-6},
                valInterval=500, warmup_epochs=1, min_lr=1e-4)
    monkeypatch.setattr(structured_soak, "build",
                        lambda steps, **kw: make_config(dict(tiny, num_iter=steps)))
    monkeypatch.setattr(structured_soak, "STRUCTURED_KW",
                        {"min_len": 3, "max_len": 8, "max_h": 60, "max_w": 250})
    out = structured_soak.run(structured_soak.parse_args(
        ["--steps", "2", "--n_train", "32", "--n_eval", "8", "--eval_every", "2",
         "--ckpt_dir", str(tmp_path), "--device", "cpu"]))
    assert out["pools"] and len(out["curve"]) == 1 and out["curve"][0]["step"] == 2
    assert os.path.exists(tmp_path / "last.msgpack")
    assert os.path.exists(tmp_path / "structured_curve.jsonl")


# ---- the losses -----------------------------------------------------------------

def _loss_inputs(seed: int = 0, B: int = 5, M: int = 6):
    """Random loc/conf at the real prior count, with ties in conf, and the
    crafted ground truth of the module docstring."""
    priors = make_priors()
    N = priors.shape[0]
    rng = np.random.default_rng(seed)
    loc = rng.normal(0, 1, (B, N, 4)).astype(np.float32)
    conf = (np.round(rng.normal(0, 2, (B, N, 2)) * 2) / 2).astype(np.float32)   # ties
    gt = np.zeros((B, M, 4), np.float32)
    valid = np.zeros((B, M), bool)
    # 0: two copies of one box (a shared best prior) and a third box, padding after
    gt[0, :3] = [[0.2, 0.3, 0.45, 0.36], [0.2, 0.3, 0.45, 0.36], [0.6, 0.1, 0.9, 0.2]]
    valid[0, :3] = True
    # 1: a tiny box in the corner (best prior 0, IoU < 0.5) before padding rows
    p0 = priors[0]
    gt[1, 0] = [0.0, 0.0, p0[2] * 0.3, p0[3] * 0.3]
    gt[1, 1] = [0.5, 0.5, 0.7, 0.6]
    valid[1, :2] = True
    # 2: a thin long box, no prior at IoU >= 0.5 (only its forced prior); padding between
    gt[2, 0] = [0.05, 0.5, 0.95, 0.503]
    gt[2, 2] = [0.3, 0.7, 0.5, 0.8]
    valid[2, [0, 2]] = True
    # 3: a window without a box
    # 4: every slot used, random boxes
    xy = rng.uniform(0, 0.8, (M, 2))
    gt[4] = np.concatenate([xy, xy + rng.uniform(0.02, 0.2, (M, 2))], 1)
    valid[4] = True
    return priors, loc, conf, gt, valid


@pytest.mark.parametrize("which", ["multibox", "focal"])
def test_losses_and_gradients_equal_jax(which):
    from doc2tex_tpu.detection import loss as jloss

    priors, loc, conf, gt, valid = _loss_inputs()
    jfn = getattr(jloss, f"{which}_loss")
    tfn = getattr(tloss, f"{which}_loss")

    def jtotal(lp, cp):
        ll, lc = jfn(lp, cp, jnp.asarray(gt), jnp.asarray(valid), jnp.asarray(priors))
        return ll + lc, (ll, lc)

    (jv, (jll, jlc)), (jgl, jgc) = jax.jit(jax.value_and_grad(jtotal, argnums=(0, 1),
                                                              has_aux=True))(loc, conf)
    lp = torch.from_numpy(loc).requires_grad_()
    cp = torch.from_numpy(conf).requires_grad_()
    ll, lc = tfn(lp, cp, torch.from_numpy(gt), torch.from_numpy(valid), torch.from_numpy(priors))
    (ll + lc).backward()
    for got, want in ((ll, jll), (lc, jlc), (ll + lc, jv)):
        assert abs(got.item() - float(want)) <= 1e-5 * abs(float(want)), (got.item(), want)
    for got, want in ((lp.grad, jgl), (cp.grad, jgc)):
        want = np.asarray(want)
        np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=1e-5 * np.abs(want).max())
    # the crafted cases take the paths they were made for, in both packages
    _, tpos = tloss.match_priors(torch.from_numpy(gt), torch.from_numpy(valid),
                                 torch.from_numpy(priors))
    jpos = np.stack([np.asarray(jloss.match_priors(jnp.asarray(g), jnp.asarray(v),
                                                   jnp.asarray(priors))[1])
                     for g, v in zip(gt, valid)])
    np.testing.assert_array_equal(tpos.numpy(), jpos)
    assert not jpos[3].any() and jpos[2].sum() >= 2 and not jpos[1, 0]


def test_match_priors_targets_equal_jax():
    from doc2tex_tpu.detection import loss as jloss

    priors, _, _, gt, valid = _loss_inputs(seed=1)
    tloc, _ = tloss.match_priors(torch.from_numpy(gt), torch.from_numpy(valid),
                                 torch.from_numpy(priors))
    for i in range(len(gt)):
        jloc, _ = jloss.match_priors(jnp.asarray(gt[i]), jnp.asarray(valid[i]),
                                     jnp.asarray(priors))
        np.testing.assert_allclose(tloc[i].numpy(), np.asarray(jloc), rtol=1e-6, atol=1e-5)


# ---- the data -------------------------------------------------------------------

def test_gtdb_dataset_equals_jax(tmp_path):
    from PIL import Image

    from doc2tex_tpu.detection import data as jdata

    from doc2tex_tpu_torch.tools.page_eval import synth_labelled_page

    rng = np.random.default_rng(4)
    img_dir, anno_dir = tmp_path / "images", tmp_path / "annotations"
    img_dir.mkdir()
    anno_dir.mkdir()
    for i, mode in enumerate(("L", "RGB", "L")):
        page, boxes, _ = synth_labelled_page(rng, n_regions=4, style="structured")
        page = page[: 700 + 100 * i, : 900 + 64 * i]
        if mode == "RGB":
            tint = rng.integers(0, 40, (1, 1, 3))
            arr = np.clip(np.repeat(page[..., None], 3, -1).astype(int) - tint, 0, 255)
            Image.fromarray(arr.astype(np.uint8), "RGB").save(img_dir / f"p{i}.png")
        else:
            Image.fromarray(page).save(img_dir / f"p{i}.png")
        with open(anno_dir / f"p{i}.pmath", "w") as f:
            for b in boxes:
                f.write(",".join(str(v) for v in b) + "\n")
            f.write("1 2\n")                               # a short line is skipped
    (img_dir / "p9.png").write_bytes(b"")                   # no annotation: not read
    for name in ("p0.pmath", "p1.pmath"):
        np.testing.assert_array_equal(tdata.read_pmath(str(anno_dir / name)),
                                      jdata.read_pmath(str(anno_dir / name)))
    rgb = tdata.read_page(str(img_dir / "p1.png"))
    assert np.array_equal(rgb, np.asarray(Image.open(img_dir / "p1.png").convert("L")))
    for positive_only in (True, False):
        want = jdata.GTDBDetectionDataset(str(img_dir), str(anno_dir), positive_only=positive_only)
        got = tdata.GTDBDetectionDataset(str(img_dir), str(anno_dir), positive_only=positive_only)
        assert len(got) == len(want) >= 10
        for a, b in zip(got.samples, want.samples):
            assert all(np.array_equal(x, y) for x, y in zip(a, b))
        for (ti, tg, tv), (wi, wg, wv) in zip(got.batches(4, seed=3), want.batches(4, seed=3)):
            assert np.array_equal(ti, wi) and np.array_equal(tg, wg) and np.array_equal(tv, wv)
    info = [(0, 0, 512, 512), (384, 128, 512, 512), (0, 0, 300, 200)]
    boxes = jdata.read_pmath(str(anno_dir / "p0.pmath"))
    for kw in ({}, {"min_overlap": 0.6, "max_boxes": 2}):
        for a, b in zip(tdata.window_targets(boxes, info, **kw),
                        jdata.window_targets(boxes, info, **kw)):
            np.testing.assert_array_equal(a, b)
    Image.fromarray(np.full((600, 600), 255, np.uint8)).save(img_dir / "p5.jpg")
    (anno_dir / "p5.pmath").write_text("1,2,30,40\n")
    with pytest.raises(NotImplementedError, match="A11"):
        tdata.GTDBDetectionDataset(str(img_dir), str(anno_dir))


# ---- the train step -------------------------------------------------------------

def _grads_from_mu(mu: dict) -> dict:
    """Adam's first moment after one step is (1 - b1) g = 0.1 g."""
    return {k: np.asarray(v, np.float32) / np.float32(0.1) for k, v in mu.items()}


def _flat(tree, prefix=()):
    for k, v in tree.items():
        if isinstance(v, dict):
            yield from _flat(v, prefix + (k,))
        else:
            yield ".".join(prefix + (k,)), v


def _hwio(k, arr):
    arr = np.asarray(arr, np.float32)
    return arr.transpose(3, 2, 0, 1) if k.endswith("kernel") and arr.ndim == 4 else arr


def test_train_step_equals_jax():
    """One float32 Adam step at batch 1 from the shipped detector (module
    docstring's gates), on a uint8 window as a GTDB dataset gives it; then
    a second step on another window (Adam's moments and count carried):
    its loss within 1e-4 relative of JAX's."""
    import optax
    from doc2tex_tpu.detection.data import make_detection_train_step as jax_step
    from doc2tex_tpu.detection.flow import MathDetector as JaxDetector

    from doc2tex_tpu_torch.tools.detection_soak import window_sample
    from doc2tex_tpu_torch.train.optim import adam
    from doc2tex_tpu_torch.train.trainer import named_params

    wins, gts, valids = window_sample(np.random.default_rng(0))
    k, k2 = np.flatnonzero(valids.any(1))[:2]
    images, gt, valid = wins[k:k + 1, ..., None], gts[k:k + 1], valids[k:k + 1]
    second = (wins[k2:k2 + 1, ..., None], gts[k2:k2 + 1], valids[k2:k2 + 1])
    priors = make_priors()

    jdet = JaxDetector(weights_path=SHIPPED_WEIGHTS)
    tx = optax.adam(1e-4)
    params = jdet.variables["params"]
    step = jax_step(jdet.model, priors, tx)
    jparams, jopt, jm = step(params, tx.init(params), jnp.asarray(images), jnp.asarray(gt),
                             jnp.asarray(valid))
    jgrads = _grads_from_mu({k: _hwio(k, v) for k, v in _flat(jax.device_get(jopt[0].mu))})
    jafter = {k: _hwio(k, v) for k, v in _flat(jax.device_get(jparams))}
    jm2 = step(jparams, jopt, *(jnp.asarray(a) for a in second))[2]

    model = MathDetector(SHIPPED_WEIGHTS, device="cpu").model.train()
    start = {k: v.clone() for k, v in model.state_dict().items()}
    # the port's own spread: its gradient at weights scaled by (1 + 1e-7 N(0, 1))
    noisy = MathDetector(SHIPPED_WEIGHTS, device="cpu").model.train()
    gen = torch.Generator().manual_seed(17)
    with torch.no_grad():
        for p in noisy.parameters():
            p.mul_(1 + WEIGHT_NOISE * torch.randn(p.shape, generator=gen))
    spreads = {}
    for m in (noisy, model):
        ttx = adam(1e-4)
        tp = named_params(m)
        tp, topt, tm = tdata.make_detection_train_step(m, priors, ttx)(
            tp, ttx.init(tp), images, gt, valid)
        spreads[m is model] = (_grads_from_mu(topt[0].mu), tm)
    tgrads, tm = spreads[True]
    ngrads, _ = spreads[False]
    loss_err = abs(float(tm["loss"]) - float(jm["loss"])) / abs(float(jm["loss"]))
    assert loss_err <= TOL["loss_rtol"], (float(tm["loss"]), float(jm["loss"]))
    for key in ("loss_loc", "loss_conf"):
        assert abs(float(tm[key]) - float(jm[key])) <= 1e-5 * abs(float(jm[key])) + 1e-7
    norm = float(np.sqrt(sum((g.astype(np.float64) ** 2).sum() for g in jgrads.values())))

    def worst(a, b):
        return max(np.abs(a[k] - b[k]).max() / (np.linalg.norm(b[k]) + TOL["grad_floor"] * norm)
                   for k in b)

    own = worst(ngrads, tgrads)
    tol = max(TOL["grad_rtol"], SPREAD_FACTOR * own)
    got = worst(tgrads, jgrads)
    assert set(tgrads) == set(jgrads) and got <= tol, (got, tol, own)
    after = model.state_dict()
    diffs = np.concatenate([np.abs(after[k].numpy() - jafter[k]).ravel() for k in jafter])
    assert (diffs > 1e-6).mean() <= TOL["param_far_share"]
    moved = np.concatenate([(after[k] - start[k]).abs().numpy().ravel() for k in start])
    assert (moved > 5e-5).mean() > 0.5                    # Adam's first step moves ~lr per weight
    tm2 = tdata.make_detection_train_step(model, priors, ttx)(tp, topt, *second)[2]
    assert abs(float(tm2["loss"]) - float(jm2["loss"])) <= 1e-4 * abs(float(jm2["loss"]))


# ---- the soak twin and the checkpoints ------------------------------------------

def test_soak_pool_and_eval_set_equal_jax_tool():
    """``build_pool`` and ``eval_set`` against the JAX tool's samplers and
    its pool loop (copied here: it sits inside the tool's ``main``), at a
    pool of 16."""
    from doc2tex_tpu_torch.tools import detection_soak as tsoak

    jsoak = _jax_tool("detection_soak")
    mean_px = np.asarray([246, 246, 246], np.float32)
    for style in ("windows", "mixed", "bars"):
        n_pool, maxb = 16, 8 if style == "windows" else 4
        rng = np.random.default_rng(0)
        imgs = np.empty((n_pool, 512, 512, 3), np.float32)
        gts = np.zeros((n_pool, maxb, 4), np.float32)
        valid = np.zeros((n_pool, maxb), bool)
        if style == "windows":
            n_neg_target = int(round(0.18 * n_pool))
            n_pos = n_neg = i = 0
            while i < n_pool:
                wins, wgt, wvalid = jsoak.window_sample(rng)
                for w, g, v in zip(wins, wgt, wvalid):
                    if i >= n_pool:
                        break
                    if v.any():
                        if n_pos >= n_pool - n_neg_target:
                            continue
                        n_pos += 1
                    else:
                        if n_neg >= n_neg_target:
                            continue
                        n_neg += 1
                    imgs[i] = np.repeat(w[..., None], 3, -1).astype(np.float32) - mean_px
                    gts[i], valid[i] = g, v
                    i += 1
        else:
            for i in range(n_pool):
                img, boxes = jsoak.synth_page(rng, style=style)
                imgs[i] = np.repeat(img[..., None], 3, -1).astype(np.float32) - mean_px
                k = min(len(boxes), maxb)
                gts[i, :k], valid[i, :k] = boxes[:k], True
        pool = tsoak.build_pool(style, 0.18, n_pool)
        assert np.array_equal(pool["images"], imgs) and np.array_equal(pool["gt"], gts)
        assert np.array_equal(pool["valid"], valid)
    got = tsoak.eval_set("windows", 3)
    rng, n = np.random.default_rng(99), 0
    wins, wgt, wvalid = jsoak.window_sample(rng)
    for (w, truth), jw, g, v in zip(got, wins, wgt, wvalid):
        assert np.array_equal(w, jw) and np.array_equal(truth, g[v].reshape(-1, 4) * 512)
        n += 1
    assert n == 3


def test_soak_checkpoint_loads_in_jax_and_back(tmp_path, monkeypatch):
    """The twin at 1 step (batch 1, a pool of 2 bars pages, from the
    shipped weights) saves a checkpoint that JAX's ``MathDetector`` loads
    with the port's boxes on a window; a JAX checkpoint loads in the
    port's ``MathDetector`` and in ``--init_from``."""
    from types import SimpleNamespace

    from doc2tex_tpu.detection.flow import MathDetector as JaxDetector
    from doc2tex_tpu.train.checkpoint import save_checkpoint as jax_save

    from doc2tex_tpu_torch.tools import detection_soak as tsoak

    monkeypatch.setattr(tsoak, "N_POOL", 2)
    path = str(tmp_path / "soak" / "last.msgpack")
    out = tsoak.run(tsoak.parse_args(["--steps", "1", "--batch", "1", "--n_eval", "1",
                                      "--init_from", SHIPPED_WEIGHTS, "--save", path,
                                      "--device", "cpu"]))
    assert len(out["losses"]) == 1 and np.isfinite(out["losses"][0])
    with open(path + ".json") as f:
        meta = json.load(f)
    assert meta["iter"] == 1 and set(out["scores"]) <= set(meta)
    window = tsoak.window_sample(np.random.default_rng(2))[0][:1, ..., None]
    tdet = MathDetector(path, conf_thresh=0.3, device="cpu")
    tdet.model = out["model"].eval()                          # the in-memory model
    jdet = JaxDetector(weights_path=path, conf_thresh=0.3)
    tb, ts = tdet.detect_windows(torch.from_numpy(window))
    jb, js = jdet._detect(jdet.variables, jnp.asarray(window))
    np.testing.assert_allclose(ts.numpy(), np.asarray(js), atol=1e-4)
    np.testing.assert_allclose(tb.numpy(), np.asarray(jb), atol=1e-4)
    loaded = MathDetector(path, conf_thresh=0.3, device="cpu")
    for a, b in zip(loaded.detect_windows(torch.from_numpy(window)), (tb, ts)):
        assert torch.equal(a, b)

    jpath = str(tmp_path / "jax.msgpack")
    jparams = jax.tree_util.tree_map(lambda p: p * 0.98, jdet.variables["params"])
    jax_save(jpath, SimpleNamespace(step=3, params=jparams, batch_stats={}, opt_state={}),
             {"iter": 3})
    jdet2 = JaxDetector(weights_path=jpath, conf_thresh=0.3)
    jb2, js2 = jdet2._detect(jdet2.variables, jnp.asarray(window))
    tdet2 = MathDetector(jpath, conf_thresh=0.3, device="cpu")
    tb2, ts2 = tdet2.detect_windows(torch.from_numpy(window))
    np.testing.assert_allclose(ts2.numpy(), np.asarray(js2), atol=1e-4)
    np.testing.assert_allclose(tb2.numpy(), np.asarray(jb2), atol=1e-4)


def test_golden_file_lines_up():
    """The golden's pool windows are the port's pool's first windows and its
    held-out windows the port's eval set (no model run)."""
    from doc2tex_tpu_torch.tools import detection_soak as tsoak

    with open(GOLDEN) as f:
        golden = json.load(f)
    assert golden["style"] == "windows" and golden["batch"] == GOLDEN_BATCH
    pool = tsoak.build_pool("windows", golden["neg_frac"], tsoak.N_POOL, first=golden["batch"])
    first = pool["images"][:GOLDEN_BATCH]
    assert hashlib.sha256(first.tobytes()).hexdigest() == golden["pool_sha256"]
    np.testing.assert_array_equal(pool["gt"][:GOLDEN_BATCH], np.asarray(golden["gt"], np.float32))
    assert len(golden["eval"]) == golden["n_eval"] == len(tsoak.eval_set("windows", 8))
    assert set(golden["first_step"]) == {"loss", "loss_loc", "loss_conf"}
    assert len(golden["step_losses"]) == GOLDEN_STEPS
    assert abs(golden["step_losses"][0] / golden["first_step"]["loss"] - 1) <= 1e-6
    steps = tsoak.build_pool("windows", golden["neg_frac"], tsoak.N_POOL,
                             first=GOLDEN_BATCH * GOLDEN_STEPS)["images"]
    assert hashlib.sha256(steps.tobytes()).hexdigest() == golden["pool_sha256_steps"]


def write_golden() -> None:
    """JAX on the CPU: the ``windows`` pool's first 24 windows (the JAX
    tool's samplers and pool loop, seed 0); the losses of 3 Adam steps
    (``optax.adam(1e-4)``, JAX's ``make_detection_train_step``) from the
    shipped weights on windows 0-7, 8-15 and 16-23, as the JAX tool's step
    sees the pool (windows with the mean off, minus the mean again); the
    shipped weights' held-out evaluation (seed 99, 8 windows, conf 0.3, NMS
    IoU 0.3): each window's boxes and scores and the CROHME scores."""
    jax.config.update("jax_platforms", "cpu")
    jax.config.update("jax_default_matmul_precision", "float32")
    from doc2tex_tpu.detection import batched_detect
    from doc2tex_tpu.detection.evaluate import crohme_detection_scores
    from doc2tex_tpu.detection.flow import MathDetector as JaxDetector
    from doc2tex_tpu.detection.loss import multibox_loss

    jsoak = _jax_tool("detection_soak")
    mean_px = np.asarray([246, 246, 246], np.float32)
    n_pool, neg_frac = 256, 0.18
    rng = np.random.default_rng(0)
    imgs, gts, valid = [], [], []
    n_neg_target = int(round(neg_frac * n_pool))
    n_pos = n_neg = 0
    n_first = GOLDEN_BATCH * GOLDEN_STEPS
    while len(imgs) < n_first:
        wins, wgt, wvalid = jsoak.window_sample(rng)
        for w, g, v in zip(wins, wgt, wvalid):
            if len(imgs) >= n_first:
                break
            if v.any():
                if n_pos >= n_pool - n_neg_target:
                    continue
                n_pos += 1
            else:
                if n_neg >= n_neg_target:
                    continue
                n_neg += 1
            imgs.append(np.repeat(w[..., None], 3, -1).astype(np.float32) - mean_px)
            gts.append(g)
            valid.append(v)
    imgs, gts, valid = np.stack(imgs), np.stack(gts), np.stack(valid)

    det = JaxDetector(weights_path=SHIPPED_WEIGHTS)
    priors = jnp.asarray(make_priors())

    @jax.jit
    def losses(variables, x, g, v):
        loc, conf = det.model.apply(variables, x - jnp.asarray(mean_px))
        ll, lc = multibox_loss(loc, conf, g, v, priors)
        return ll + lc, ll, lc

    b = slice(0, GOLDEN_BATCH)
    loss, ll, lc = losses(det.variables, jnp.asarray(imgs[b]), jnp.asarray(gts[b]),
                          jnp.asarray(valid[b]))
    print(f"first step: loss {float(loss):.6f} (loc {float(ll):.6f}, conf {float(lc):.6f})",
          flush=True)
    import optax
    from doc2tex_tpu.detection.data import make_detection_train_step

    tx = optax.adam(1e-4)
    step = make_detection_train_step(det.model, make_priors(), tx)
    params = jax.tree_util.tree_map(jnp.array, det.variables["params"])
    opt_state, step_losses = tx.init(params), []
    for i in range(GOLDEN_STEPS):
        b = slice(i * GOLDEN_BATCH, (i + 1) * GOLDEN_BATCH)
        params, opt_state, m = step(params, opt_state, jnp.asarray(imgs[b]), jnp.asarray(gts[b]),
                                    jnp.asarray(valid[b]))
        step_losses.append(float(m["loss"]))
        print(f"step {i + 1}: loss {step_losses[-1]:.6f}", flush=True)

    detect = jax.jit(lambda v, x: batched_detect(*det.model.apply(v, x)[:2], priors,
                                                 conf_thresh=0.3, iou_thresh=0.3))
    eval_rng = np.random.default_rng(99)
    evals, preds, truths = [], [], []
    while len(evals) < 8:
        wins, wgt, wvalid = jsoak.window_sample(eval_rng)
        for w, g, v in zip(wins, wgt, wvalid):
            if len(evals) >= 8:
                break
            x = jnp.asarray((np.repeat(w[..., None], 3, -1).astype(np.float32) - mean_px)[None])
            db, ds = detect(det.variables, x)
            db, ds = np.asarray(db[0]) * 512, np.asarray(ds[0])
            keep = ds > 0.3
            truth = np.asarray(g[v], np.float32).reshape(-1, 4) * 512
            preds.append(db[keep].reshape(-1, 4))
            truths.append(truth)
            evals.append({"sha256": hashlib.sha256(w.tobytes()).hexdigest(),
                          "boxes": db[keep].tolist(), "scores": ds[keep].tolist(),
                          "truth": truth.tolist()})
    scores = crohme_detection_scores(preds, truths)
    print("CROHME scores:", scores, flush=True)
    golden = {
        "detector": "saved_models/math_detect/best_weights.msgpack", "dtype": "float32",
        "style": "windows", "pool_seed": 0, "neg_frac": neg_frac, "batch": GOLDEN_BATCH,
        "pool_sha256": hashlib.sha256(imgs[:GOLDEN_BATCH].tobytes()).hexdigest(),
        "pool_sha256_steps": hashlib.sha256(imgs.tobytes()).hexdigest(),
        "gt": gts[:GOLDEN_BATCH].tolist(), "valid": valid[:GOLDEN_BATCH].tolist(),
        "first_step": {"loss": float(loss), "loss_loc": float(ll), "loss_conf": float(lc)},
        "step_losses": step_losses,
        "eval_seed": 99, "n_eval": 8, "conf_thresh": 0.3, "iou_thresh": 0.3,
        "eval": evals, "scores": scores,
        "command": "PYTHONPATH=. python tests/test_torch_port_detect_train.py --write-golden",
    }
    with open(GOLDEN, "w") as f:
        json.dump(golden, f, indent=1)
        f.write("\n")


if __name__ == "__main__":
    if sys.argv[1:] != ["--write-golden"]:
        sys.exit("usage: PYTHONPATH=. python tests/test_torch_port_detect_train.py "
                 "--write-golden")
    write_golden()
