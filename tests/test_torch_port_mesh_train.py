"""Data-parallel training over the port's mesh on the CPU (gloo ranks
spawned as in ``tests/test_torch_port_mesh.py``: ``file://`` rendezvous in
``tmp_path``, one torch thread each, never importing jax, every group joined
under ``GROUP_LIMIT_S`` and killed on expiry), held against the port's own
single process:

- a float32 train step at a global batch of 5, padded to 6 (a white,
  GO-led, loss-masked row), with augmentation and dropout off, and again
  with both on: loss within 1e-5 relative, BatchNorm running statistics
  within 1e-5; gradient leaves as ``tests/test_torch_port_train.py``
  splits them (ROADMAP C's watch-list): the head and the ViT within 1e-4
  of each leaf's norm, the whole ResNet's float32 leaves within 5e-2, the
  whole ResNet in float64 within 1e-4 and one BasicBlock in float32 within
  1e-4 (output, input gradient, every leaf; statistics within 1e-5); the
  parameters after the step within 1e-6 + 1e-3 lr wherever both sides'
  gradients bound Adam's move that tightly (``_params_close``: most
  elements of the ResNet and of the rest), and equal on both ranks;
- a 2 x 2 mesh's step (the model axis replicates) against the 2 x 1
  mesh's: loss and grad_norm within 1e-5 relative, every gradient leaf at
  the tolerances above, statistics within 1e-5, parameters as above;
- a sharded train loader: the data ranks' rows of each batch, read and
  decoded by each rank alone, make up the unsharded loader's batch padded
  as ``pad_batch`` pads it, exactly;
- the cross-mesh resume of ``test_cross_mesh_checkpoint_restore`` through
  ``engine.training.train`` ({data 2} -> {data 1, model 2} -> {data 2});
  its checkpoint loads in the JAX package's ``load_checkpoint``;
- ``api.infer.run_infer`` over 2 ranks gives the one-rank predictions;
- ``tools/dryrun_multichip.py 4`` (the LSTM head over a 2 x 2 mesh)
  descends and restores.
"""

from __future__ import annotations

import os
import re

import numpy as np
import pytest
import torch

import torch_port_mesh_ranks as ranks
from doc2tex_tpu_torch.parallel import mesh as meshlib
from test_torch_port_mesh import GROUP_LIMIT_S, _crops, _int8_crop, spawn
from torch_port_threads import one_torch_thread  # noqa: F401

LOSS_RTOL, STATS_TOL, GRAD_TOL, GRAD_FLOOR = 1e-5, 1e-5, 1e-4, 1e-7
RESNET_GRAD_RTOL = 5e-2        # float32 ReLU flips (tests/test_torch_port_train.py)
PARAM_TOL = 1e-6              # the parameters' float32 rounding (|p| < 8)
ADAM_EPS = 1e-8               # train.optim.scale_by_adam's
V = ranks.TRAIN_VOCAB


# ---- data-parallel training ----------------------------------------------

def _train_cfg(**kw) -> dict:
    from test_torch_port_train import train_config

    cfg = train_config(warmup_epochs=0.0)
    cfg.update(kw)
    return cfg


def _global_batch(n=5, seed=0):
    """A global batch of ``n``, padded to the data axis of 2 as the engine
    pads it."""
    from doc2tex_tpu_torch.train.trainer import pad_batch

    rng = np.random.default_rng(seed)
    images = rng.integers(0, 256, (n, 32, 64, 1)).astype(np.uint8)
    images[:, :, :20] = 255
    text = np.zeros((n, 14), np.int32)
    text[:, 0] = 1
    for i, k in enumerate(rng.integers(3, 12, n)):
        text[i, 1:1 + k] = rng.integers(4, V, k)
        text[i, 1 + k] = 2
    return pad_batch(images, text, 2, 1)


def _variables(cfg, seed=1):
    return ranks.variables_for(cfg, seed, num_class=V)


def _resnet_args():
    """(float64 trunk variables, block variables, x64, w64, xb, wb): NCHW
    inputs of 6 rows (a batch of 5 padded with a white row for the trunk)."""
    from doc2tex_tpu_torch.models.resnet import BasicBlock, FANResNet
    from doc2tex_tpu_torch.weights import random_variables, to_variables

    rng = np.random.default_rng(6)
    images, _ = _global_batch()
    x64 = ((images.astype(np.float64) / 255.0 - 0.5) / 0.5).transpose(0, 3, 1, 2).copy()
    trunk = random_variables(to_variables(FANResNet(1, 64)), rng)
    w64 = rng.normal(size=(6, 64, 1, 64 // 4 + 1))
    block = random_variables(to_variables(BasicBlock(6, 8, torch.float32)), rng)
    xb = rng.normal(size=(6, 6, 9, 11)).astype(np.float32)
    wb = rng.normal(size=(6, 8, 9, 11)).astype(np.float32)
    return trunk, block, x64, w64, xb, wb


def _train_cases():
    plain = _train_cfg()
    rand = _train_cfg(augment=True, Prediction=dict(plain["Prediction"], params=dict(
        plain["Prediction"]["params"], dropout=0.1)))
    images, text = _global_batch()
    return {"plain": (plain, _variables(plain), images, text),
            "augment_dropout": (rand, _variables(rand), images, text)}


@pytest.fixture(scope="module")
def training(tmp_path_factory):
    """(both ranks' results, the one-process results, the cases)."""
    cases, resnet = _train_cases(), _resnet_args()
    out = spawn(ranks.train_rank, 2, (cases, resnet), tmp_path_factory.mktemp("train"), "train")
    single = {name: ranks.train_step_case(*args) for name, args in cases.items()}
    single["resnet"] = ranks.resnet_case(*resnet)
    return out, single, cases


def _leaf_close(got, want, rtol, what):
    err = np.abs(got - want).max()
    assert err <= rtol * np.linalg.norm(want) + GRAD_FLOOR, (what, err, np.linalg.norm(want))


def _grads_close(got, want):
    """Every leaf at its split's tolerance (the ResNet's float32 leaves at
    RESNET_GRAD_RTOL)."""
    resnet = [k for k in want if "FeatureExtractor" in k or "ResNet" in k]
    assert len(resnet) > 50 and set(got) == set(want)
    for k, v in want.items():
        _leaf_close(got[k], v, RESNET_GRAD_RTOL if k in resnet else GRAD_TOL, k)


def _params_close(got, want, lr, clip):
    """The parameters after one Adam step.  Adam moves an element by
    lr * g' / (|g'| + eps) (plus the decay, equal on both sides), g' the
    clipped gradient: where both sides' gradients have one sign and a
    magnitude of at least ADAM_EPS / (clip scale * 1e-3), the moves differ
    by at most 1e-3 lr.  There the parameters must agree within PARAM_TOL
    + 1e-3 lr; that holds for most elements of the ResNet and of the rest
    (a flipped or near-zero gradient may move an element by up to 2 lr)."""
    scale = min(1.0, clip / want["grad_norm"])
    floor = ADAM_EPS / (scale * 1e-3)
    share = {}
    for k, v in want["params"].items():
        g1, g2 = got["grads"][k], want["grads"][k]
        mask = (np.sign(g1) == np.sign(g2)) & (np.minimum(np.abs(g1), np.abs(g2)) > floor)
        err = np.abs(got["params"][k] - v)[mask]
        assert not err.size or err.max() <= PARAM_TOL + 1e-3 * lr, (k, err.max())
        group = "resnet" if ("FeatureExtractor" in k or "ResNet" in k) else "rest"
        n, m = share.get(group, (0, 0))
        share[group] = (n + mask.sum(), m + mask.size)
    assert all(n > m / 2 for n, m in share.values()), share


@pytest.mark.parametrize("case", ["plain", "augment_dropout"])
def test_dp_train_step_equals_one_process(training, case):
    out, single, cases = training
    want = single[case]
    lr = cases[case][0]["optimizer"]["lr"]
    for got in (out[0][case], out[1][case]):
        assert abs(got["loss"] - want["loss"]) <= LOSS_RTOL * abs(want["loss"])
        assert abs(got["grad_loss"] - want["grad_loss"]) <= LOSS_RTOL * abs(want["grad_loss"])
        assert abs(got["grad_norm"] - want["grad_norm"]) <= 1e-4 * want["grad_norm"]
        assert got["token_acc"] == want["token_acc"]
        for k, v in want["stats"].items():
            np.testing.assert_allclose(got["stats"][k], v, atol=STATS_TOL, rtol=STATS_TOL,
                                       err_msg=k)
        _grads_close(got["grads"], want["grads"])
        _params_close(got, want, lr, cases[case][0]["grad_clip"])
    # the ranks hold one model
    for k, v in out[0][case]["params"].items():
        np.testing.assert_array_equal(out[1][case]["params"][k], v)


def test_dp_resnet_float64_and_block_float32(training):
    out, single, _ = training
    for tag in ("resnet64", "block32"):
        want = single["resnet"][tag]
        y = np.concatenate([out[r]["resnet"][tag]["y"] for r in (0, 1)])
        gx = np.concatenate([out[r]["resnet"][tag]["gx"] for r in (0, 1)])
        _leaf_close(y, want["y"], GRAD_TOL, (tag, "output"))
        _leaf_close(gx, want["gx"], GRAD_TOL, (tag, "input gradient"))
        for r in (0, 1):
            got = out[r]["resnet"][tag]
            assert set(got["grads"]) == set(want["grads"])
            for k, v in want["grads"].items():
                _leaf_close(got["grads"][k], v, GRAD_TOL, (tag, k))
            for k, v in want["stats"].items():
                np.testing.assert_allclose(got["stats"][k], v, atol=STATS_TOL, rtol=STATS_TOL,
                                           err_msg=f"{tag} {k}")


def test_2x2_mesh_step_equals_2x1(training, tmp_path):
    """Over {data 2, model 2} (the model axis replicates) the step equals
    the data-only mesh's (the ``training`` group's plain case, {data 2}):
    loss, grad_norm, every gradient leaf, statistics and parameters; the
    four ranks hold one model."""
    cfg, variables, images, text = training[2]["plain"]
    lr = cfg["optimizer"]["lr"]
    want = training[0][0]["plain"]
    tp = spawn(ranks.mesh_loss_rank, 4, ({"data": 2, "model": 2}, cfg, variables, images, text),
               tmp_path, "tp")
    assert [got["shape"] for got in tp] == [{"data": 2, "model": 2}] * 4
    for got in tp:
        assert abs(got["loss"] - want["loss"]) <= LOSS_RTOL * abs(want["loss"])
        assert abs(got["grad_norm"] - want["grad_norm"]) <= LOSS_RTOL * want["grad_norm"]
        for k, v in want["stats"].items():
            np.testing.assert_allclose(got["stats"][k], v, atol=STATS_TOL, rtol=STATS_TOL)
        _grads_close(got["grads"], want["grads"])
        _params_close(got, want, lr, cfg["grad_clip"])
        for k, v in tp[0]["params"].items():
            np.testing.assert_array_equal(got["params"][k], v)


def test_sharded_loader_rows_make_the_padded_batch():
    """``BucketLoader(shard=(nd, i))``: for nd 2 and 3, augmentation and pad
    jitter on, each rank's batch is its rows of the unsharded batch padded
    by ``pad_batch`` (images, text, lengths of the real rows), and
    ``rows_of`` is the padded size; the ranks read only their rows."""
    from doc2tex_tpu_torch.config import make_config
    from doc2tex_tpu_torch.data.loader import ArrayDataset, BucketLoader
    from doc2tex_tpu_torch.data.synthetic import synth_hard_dataset
    from doc2tex_tpu_torch.tokenizer.converters import TFMLabelConverter
    from doc2tex_tpu_torch.train.trainer import pad_batch
    from test_torch_port_train import hard_vocab

    images, labels = synth_hard_dataset(23, seed=5, min_len=3, max_len=20, max_h=90,
                                        max_w=250, scale_range=(2, 3))
    cfg = make_config(dict(max_dimension=[96, 256], min_dimension=[32, 32],
                           batch_max_length=20, batch_size=5, keep_smaller_batches=True,
                           bucket_growth=1.5, augment=True, pad_jitter=8))
    conv = TFMLabelConverter(hard_vocab())

    class Counted(ArrayDataset):
        def image(self, i):
            self.read.append(i)
            return super().image(i)

    def loader(shard=None):
        data = Counted(images, labels)
        data.read = []
        return BucketLoader(data, cfg, converter=conv, train=True, seed=7, shard=shard)

    whole = loader()
    it = whole.infinite()
    want = [next(it) for _ in range(8)]
    assert any(len(b.labels) % 2 for b in want) and any(len(b.labels) % 3 for b in want)
    for nd in (2, 3):
        parts = [loader((nd, i)) for i in range(nd)]
        iters = [p.infinite() for p in parts]
        for batch in want:
            got = [next(it) for it in iters]
            pimages, ptext = pad_batch(batch.images, batch.text, nd, conv.GO)
            n = pimages.shape[0]
            assert [g.rows_of for g in got] == [n] * nd
            np.testing.assert_array_equal(np.concatenate([g.images for g in got]), pimages)
            np.testing.assert_array_equal(np.concatenate([g.text for g in got]), ptext)
            lengths = np.concatenate([g.lengths for g in got])
            np.testing.assert_array_equal(lengths[:len(batch.labels)], batch.lengths)
            assert [lb for g in got for lb in g.labels][:len(batch.labels)] == batch.labels
        reads = [p.dataset.read for p in parts]
        assert sorted(i for r in reads for i in r) == sorted(whole.dataset.read)
        assert all(0 < len(r) < len(whole.dataset.read) for r in reads)


def test_cross_mesh_resume_through_the_engine(tmp_path):
    """{data 2} 6 steps -> {data 1, model 2} to 12 -> {data 2} to 18, each
    resuming the last checkpoint; rank 0 writes, and JAX's
    ``load_checkpoint`` restores the last one."""
    from doc2tex_tpu.train import checkpoint as jax_checkpoint
    from test_loader_engine import small_config

    def run(tag, mesh_shape, num_iter, resume=None):
        cfg = dict(small_config(batch_size=8, num_iter=num_iter, valInterval=6, logInterval=6,
                                mesh_shape=mesh_shape, tp_min_size=2**10))
        if resume:
            cfg["resume_path"] = resume
        out = spawn(ranks.engine_rank, 2, (cfg, str(tmp_path / tag)), tmp_path, tag)
        keys = ("loss", "accuracy", "bleu", "ED", "word_ED", "n_samples")
        assert [out[0][k] for k in keys] == [out[1][k] for k in keys]
        assert not os.path.exists(tmp_path / tag / "rank1")
        return out[0], str(tmp_path / tag / "last_checkpoint.msgpack")

    m_a, ckpt_a = run("a", {"data": 2, "model": 1}, 6)
    m_b, ckpt_b = run("b", {"data": 1, "model": 2}, 12, ckpt_a)
    assert np.isfinite(m_b["loss"]) and m_b["loss"] <= m_a["loss"] * 1.3 + 1e-3
    m_c, ckpt_c = run("c", {"data": 2, "model": 1}, 18, ckpt_b)
    assert np.isfinite(m_c["loss"]) and m_c["loss"] <= m_b["loss"] * 1.3 + 1e-3
    payload, meta = jax_checkpoint.load_checkpoint(ckpt_c)
    assert int(np.asarray(payload["step"])) == 18 and meta["iter"] == 18
    with open(tmp_path / "a" / "log_train.txt") as f:
        assert "sharded training over 2x1" in f.read()
    with open(tmp_path / "b" / "log_train.txt") as f:
        placement = re.search(r"sharded training over 1x2 .*model axis replicated: JAX's rule "
                              r"\(tp_min_size 1024\) would shard (\d+) leaves", f.read())
    assert placement and int(placement[1]) > 0


def test_api_infer_over_two_ranks(tmp_path):
    from doc2tex_tpu_torch import _msgpack
    from test_recognition_extras import tiny_recog_config

    cfg = dict(tiny_recog_config(), beam_size=2, batch_size=3)
    weights = str(tmp_path / "w.msgpack")
    _msgpack.save(weights, ranks.variables_for(cfg, 2))
    cfg["saved_model"] = weights
    crops = _crops() + [_int8_crop(), _crops()[0][:, :50]]
    labels = ["a", "b", "c", "d", "e"]
    one, two = (meshlib.spawn(ranks.infer_run, ["cpu"], (cfg, crops, labels, n),
                              time_limit=GROUP_LIMIT_S, threads=1)[0]
                for n in (1, 2))
    assert one["n_samples"] == two["n_samples"] == 5
    assert one == two


def test_dryrun_multichip_twin_on_4_cpu_ranks():
    """``tools/dryrun_multichip.py 4 --device cpu`` on 4 CPU ranks: the
    {data 2, model 2} mesh; 6 steps descend and a checkpoint round trip
    takes the same step (``check``), and every rank logged the same
    losses.  Without a card and without ``--device cpu`` it stops: the CPU
    is only taken when asked for."""
    from doc2tex_tpu_torch.tools import dryrun_multichip

    results = dryrun_multichip.dryrun_multichip(4, "cpu", time_limit=GROUP_LIMIT_S)
    assert [r["mesh"] for r in results] == [{"data": 2, "model": 2}] * 4
    assert {r["backend"] for r in results} == {"gloo"}
    assert all(r["iter"] == dryrun_multichip.STEPS for r in results)
    assert dryrun_multichip.devices_for(3, "cpu") == ["cpu"] * 3
    if not torch.cuda.is_available():
        with pytest.raises(SystemExit, match="--device cpu"):
            dryrun_multichip.devices_for(4)
        with pytest.raises(SystemExit, match="--device cpu"):
            dryrun_multichip.main(["2"])
