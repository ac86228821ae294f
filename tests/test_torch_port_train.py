"""The port's training path against the JAX package, on the CPU, at a tiny
size: ViT 64x2 over a 64-channel ResNet, a 2-layer TFM head (d 64),
float32, dropout 0, augment off unless stated.  The JAX model's variables
are numpy draws (every parameter and BatchNorm statistic random), carried
into the port by ``weights.py``; the inputs are numpy draws too.

- one train step (adamw, clip 5, warmup cosine) against JAX's
  ``make_train_step``: loss within 1e-5 relative, token accuracy equal;
  every gradient leaf of the ViT, the patch conv and the head within 1e-4
  of its norm (+1e-7 for the attention key biases, whose gradient is 0 up
  to float noise); the BatchNorm statistics after the step within 1e-5
  (+1e-5 relative); one ResNet block in training mode (batch statistics)
  with its gradients within 1e-4 of their norms.
- The whole ResNet (max-pools, stage wiring, conv4's padding) in training
  mode, in float64 on both sides, with the white third of the images
  (exact max-pool ties): output, input gradient and every gradient leaf
  within 1e-4 of their norms (2.7e-8 measured), the statistics within 1e-5.
- In float32 the whole ResNet's gradient is not smooth at these random
  weights: the two packages' convolutions sum in other orders, the
  forward drifts apart by up to 1.2e-4 by conv4_1's output, and a ReLU
  input that close to 0 flips (one of 9,216 there), which moves every
  upstream leaf by up to ~1 %.  Measured (worst ResNet leaf against its
  norm, port against JAX / JAX against itself with its weights scaled by
  (1 + 1e-7 N(0, 1))): 2.9e-2 / 1.5e-2 with the white third, 3.2e-2 /
  1.7e-2 with uniform noise everywhere, 1.3e-2 / 1.6e-5 with the third
  near-white noise (250-255): the ties are not the cause.  So in the
  float32 step the ResNet's leaves are held within 5 % of their norms,
  grad_norm within 1e-5 relative plus twice JAX's own spread, and the
  parameters after 3 steps (Adam turns each gradient element into about
  +-lr, so every flip moves a weight by up to 2 lr, and after step 1 every
  layer sees the others' flips): every element within
  2 * (lr_0 + lr_1 + lr_2) + 1e-6, and the L2 distance from JAX's, over
  the ResNet and over the rest, within 4 times the largest distance of
  JAX's own perturbed runs;
- a bfloat16 forward loss (BatchNorm batch statistics) within 1e-2
  relative of JAX's bfloat16 loss;
- checkpoints both ways: JAX saves after 2 steps, the port restores it and
  takes step 3, which equals JAX's step 3 (the 3-step tolerance); the port
  saves after 2 steps and JAX's ``load_checkpoint(path, template)``
  restores every leaf exactly;
- ``train_augment``'s pure part against JAX's ``train_augment`` on the
  same draws (within 1e-6), and the draws' statistics (rates within 4
  sigma); dropout and drop-path (identity at rate 0 or outside training,
  kept share within 4 sigma, survivors scaled by 1/keep);
- ``BucketLoader(train=True)``: the first 6 batches equal JAX's for seed 7,
  with the geometric augment, over-padding and pad jitter on;
- ``convert_variables(to_variables(m))`` equals ``m.state_dict()`` bit for
  bit; the best-checkpoint keeper's files and sidecars; a sanity run of
  ``engine.training.train`` and of the train CLI on the CPU, whose
  checkpoint loads into a model equal to the trained one.
"""

from __future__ import annotations

import copy
import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from doc2tex_tpu.config import make_config as jax_make_config
from doc2tex_tpu.data.loader import ArrayDataset as JaxArrayDataset
from doc2tex_tpu.data.loader import BucketLoader as JaxBucketLoader
from doc2tex_tpu.data.synthetic import hard_vocab, synth_hard_dataset
from doc2tex_tpu.models import build_model as jax_build_model
from doc2tex_tpu.tokenizer.converters import TFMLabelConverter as JaxTFMConverter
from doc2tex_tpu.train import checkpoint as jax_checkpoint
from doc2tex_tpu.train.optim import optimizer_from_config as jax_optimizer_from_config
from doc2tex_tpu.train.trainer import TrainState as JaxTrainState
from doc2tex_tpu.train.trainer import criterion_from_config as jax_criterion_from_config
from doc2tex_tpu.train.trainer import make_train_step as jax_make_train_step
from doc2tex_tpu.transforms import augment as jax_augment
from doc2tex_tpu_torch.config import make_config
from doc2tex_tpu_torch.data.loader import ArrayDataset, BucketLoader
from doc2tex_tpu_torch.models import build_model
from doc2tex_tpu_torch.models.layers import drop_path, dropout
from doc2tex_tpu_torch.tokenizer.converters import TFMLabelConverter
from doc2tex_tpu_torch.train import checkpoint
from doc2tex_tpu_torch.train.optim import state_to_flax
from doc2tex_tpu_torch.train.trainer import (create_train_state, criterion_from_config,
                                             loss_and_grads, make_train_step)
from doc2tex_tpu_torch.transforms.augment import augment, draw_augment, normalize
from doc2tex_tpu_torch.weights import (convert_variables, load_variables, to_variables,
                                       tree_to_flax)
from tests.test_torch_port_model import _random_variables, tiny_config

V = 24
B, BUCKET, MAX_LEN = 4, (32, 64), 12
LOSS_RTOL, GRAD_TOL, GRAD_FLOOR, STATS_TOL = 1e-5, 1e-4, 1e-7, 1e-5
RESNET_GRAD_RTOL = 5e-2      # float32 ReLU flips move leaves by up to ~3 % (see above)
SPREAD_FACTOR = 4.0          # the 3-step distance against JAX's perturbed runs
BF16_LOSS_RTOL = 1e-2
WEIGHT_NOISE = 1e-7          # JAX's own spread: weights scaled by (1 + 1e-7 N(0, 1))
RESNET = "seqmodeler/HybridEmbed_0/ResNetFeatureExtractor_0/"


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    """One torch thread for this file: its tensors are tiny, and the
    suite's xdist workers (each with a thread pool as large as the
    machine) otherwise oversubscribe the cores many times over."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def train_config(**overrides) -> dict:
    cfg = dict(tiny_config(), batch_max_length=MAX_LEN, grad_clip=5.0, valInterval=4,
               num_iter=16, warmup_epochs=0.5, min_lr=1e-4,
               optimizer={"opt": "adamw", "lr": 1e-3, "weight_decay": 0.05})
    cfg.update(overrides)
    return cfg


def _batches(n, seed=0):
    rng = np.random.default_rng(seed)
    out = []
    for _ in range(n):
        images = rng.integers(0, 256, (B, *BUCKET, 1)).astype(np.uint8)
        images[:, :, : BUCKET[1] // 3] = 255
        text = np.zeros((B, MAX_LEN + 2), np.int32)
        text[:, 0] = 1                                          # [GO]
        for i, n_tok in enumerate(rng.integers(3, MAX_LEN, B)):
            text[i, 1: 1 + n_tok] = rng.integers(4, V, n_tok)
            text[i, 1 + n_tok] = 2                              # [s]
        out.append((images, text))
    return out


def _leaves(tree):
    return {"/".join(str(getattr(k, "key", k)) for k in path): np.asarray(v)
            for path, v in jax.tree_util.tree_flatten_with_path(tree)[0]}


def _assert_tree_close(got, want, atol, what, rtol=0.0):
    got, want = _leaves(got), _leaves(want)
    assert set(got) == set(want), what
    for k in want:
        np.testing.assert_allclose(got[k], want[k], atol=atol, rtol=rtol, err_msg=f"{what} {k}")


def _scaled(tree, seed):
    rng = np.random.default_rng(seed)
    return jax.tree_util.tree_map(
        lambda p: jnp.asarray(p * (1 + WEIGHT_NOISE * rng.normal(size=p.shape)).astype(np.float32)),
        tree)


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """Three JAX train steps and three port steps from the same variables
    on the same batches; JAX's state after 2 steps and the port's are
    saved as checkpoints."""
    tmp = tmp_path_factory.mktemp("ckpt")
    cfg = train_config()
    jcfg = jax_make_config(cfg)
    jmodel = jax_build_model(jcfg, V)
    shapes = jax.eval_shape(lambda: jmodel.init(
        jax.random.PRNGKey(0), jnp.zeros((1, *BUCKET, 1)), jnp.zeros((1, MAX_LEN + 1), jnp.int32),
        train=False))
    variables = _random_variables(dict(shapes), np.random.default_rng(0))
    port = build_model(make_config(cfg), V)
    load_variables(port, variables)
    params = jax.tree_util.tree_map(jnp.asarray, variables["params"])
    stats = jax.tree_util.tree_map(jnp.asarray, variables["batch_stats"])
    jtx = jax_optimizer_from_config(jcfg, params)
    jcrit = jax_criterion_from_config(jcfg)
    jstate = JaxTrainState(jnp.int32(0), params, stats, jtx.init(params))
    jstep = jax_make_train_step(jmodel, jcrit, jtx, jcfg)
    batches = _batches(3)

    def jloss(p, s, x, text):
        logits, _ = jmodel.apply({"params": p, "batch_stats": s}, x, text[:, :-1], train=True,
                                 mutable=["batch_stats"])
        return jcrit(logits, text[:, 1:])

    x0 = (jnp.asarray(batches[0][0], jnp.float32) / 255.0 - 0.5) / 0.5
    t0 = jnp.asarray(batches[0][1])
    jgrads = jax.jit(jax.grad(jloss))(params, stats, x0, t0)
    seeds = (1, 2, 3, 4)
    crit = criterion_from_config(make_config(cfg))
    xt = normalize(torch.from_numpy(batches[0][0]))
    _, _, pgrads = loss_and_grads(copy.deepcopy(port), crit, xt,
                                  torch.from_numpy(batches[0][1]).long())

    def jax_steps(state):
        out = []
        for images, text in batches:
            state, m = jstep(state, jnp.asarray(images), jnp.asarray(text), jax.random.PRNGKey(1))
            out.append((jax.tree_util.tree_map(np.asarray, state),
                        jax.tree_util.tree_map(np.asarray, m)))
        return out

    # the step donates its state, so each run gets its own arrays
    scaled_runs = [jax_steps(JaxTrainState(
        jnp.int32(0), _scaled(variables["params"], s),
        jax.tree_util.tree_map(jnp.asarray, variables["batch_stats"]), jtx.init(params)))
        for s in seeds]
    pstate, ptx = create_train_state(port, make_config(cfg))
    pstep = make_train_step(port, crit, ptx, make_config(cfg))
    gen = torch.Generator().manual_seed(0)
    jmetrics, pmetrics, jstates, pvars = [], [], [], []
    for i, (images, text) in enumerate(batches):
        jstate, m = jstep(jstate, jnp.asarray(images), jnp.asarray(text), jax.random.PRNGKey(1))
        jmetrics.append(jax.tree_util.tree_map(np.asarray, m))
        jstates.append(jax.tree_util.tree_map(np.asarray, jstate))
        pmetrics.append({k: v.numpy() for k, v in pstep(pstate, images, text, gen).items()})
        pvars.append(to_variables(port))
        if i == 1:
            jax_checkpoint.save_checkpoint(str(tmp / "jax_2.msgpack"), jstate, {"iter": 2})
            checkpoint.save_checkpoint(str(tmp / "port_2.msgpack"), pstate, {"iter": 2})
            popt_2 = state_to_flax(pstate.opt_state)
    return dict(cfg=cfg, jmodel=jmodel, jtx=jtx, variables=variables, batches=batches,
                jgrads=jgrads, pgrads=pgrads, jmetrics=jmetrics, pmetrics=pmetrics,
                jstates=jstates, pvars=pvars, tmp=tmp, popt_2=popt_2,
                norm_spread=max(abs(float(r[0][1]["grad_norm"] - jmetrics[0]["grad_norm"]))
                                for r in scaled_runs),
                scaled_params=[r[2][0].params for r in scaled_runs])


def test_train_step_matches_jax(runs):
    jm, pm = runs["jmetrics"][0], runs["pmetrics"][0]
    assert float(pm["loss"]) == pytest.approx(float(jm["loss"]), rel=LOSS_RTOL)
    assert abs(float(pm["grad_norm"]) - float(jm["grad_norm"])) <= (
        LOSS_RTOL * float(jm["grad_norm"]) + 2 * runs["norm_spread"])
    assert float(pm["token_acc"]) == float(jm["token_acc"])
    want = _leaves(runs["jgrads"])
    got = _leaves(tree_to_flax(runs["pgrads"]))
    assert set(got) == set(want) and len(want) > 50
    smooth = 0
    for k, w in want.items():
        err = np.abs(got[k] - w).max()
        rtol = RESNET_GRAD_RTOL if k.startswith(RESNET) else GRAD_TOL
        smooth += not k.startswith(RESNET)
        assert err <= rtol * np.linalg.norm(w) + GRAD_FLOOR, (k, err, np.linalg.norm(w))
    assert smooth > 40
    _assert_tree_close(runs["pvars"][0]["batch_stats"], runs["jstates"][0].batch_stats,
                       STATS_TOL, "batch_stats after step 1", rtol=STATS_TOL)
    _assert_params_close(runs["pvars"][2]["params"], runs, 3)


def _assert_params_close(got, runs, steps):
    """Parameters after ``steps`` (the port's) against JAX's after 3."""
    cfg = jax_make_config(runs["cfg"])
    from doc2tex_tpu.train.schedule import schedule_from_config
    lrs = [float(schedule_from_config(cfg)(jnp.int32(k))) for k in range(3)]
    bound = 2 * sum(lrs[3 - steps:]) + 1e-6
    got, want = _leaves(got), _leaves(runs["jstates"][2].params)
    assert set(got) == set(want)
    for k in want:
        assert np.abs(got[k] - want[k]).max() <= bound, k
    for resnet in (True, False):
        keys = [k for k in want if k.startswith(RESNET) == resnet]

        def dist(tree):
            return np.sqrt(sum(float(np.sum((tree[k] - want[k]) ** 2)) for k in keys))

        own = max(dist(_leaves(p)) for p in runs["scaled_params"])
        assert 0 < dist(got) <= SPREAD_FACTOR * own, (resnet, dist(got), own)


def test_resnet_block_train_mode_matches_flax():
    """One BasicBlock with a downsample shortcut, batch statistics, float32:
    output, updated running statistics and every gradient within 1e-4 of
    their norms (a smooth regime: one block, no max-pool)."""
    from doc2tex_tpu.models.resnet import BasicBlock as JaxBasicBlock
    from doc2tex_tpu_torch.models.resnet import BasicBlock

    rng = np.random.default_rng(5)
    x = rng.normal(size=(3, 9, 11, 6)).astype(np.float32)
    w = rng.normal(size=(3, 9, 11, 8)).astype(np.float32)
    jblock = JaxBasicBlock(8, use_downsample=True, dtype=jnp.float32)
    shapes = jax.eval_shape(lambda: jblock.init(jax.random.PRNGKey(0), jnp.asarray(x)))
    variables = _random_variables(dict(shapes), rng)

    def f(p, x):
        y, new = jblock.apply({"params": p, "batch_stats": variables["batch_stats"]}, x,
                              train=True, mutable=["batch_stats"])
        return jnp.sum(y * w), (y, new["batch_stats"])

    (_, (y, stats)), (gp, gx) = jax.jit(jax.value_and_grad(f, argnums=(0, 1), has_aux=True))(
        variables["params"], jnp.asarray(x))
    block = BasicBlock(6, 8, torch.float32)
    load_variables(block, variables)
    xt = torch.from_numpy(x).permute(0, 3, 1, 2).requires_grad_()
    yt = block(xt, True)
    (yt * torch.from_numpy(w).permute(0, 3, 1, 2)).sum().backward()

    def close(got, want):
        want = np.asarray(want)
        assert np.abs(got - want).max() <= GRAD_TOL * np.linalg.norm(want) + GRAD_FLOOR

    close(yt.detach().permute(0, 2, 3, 1).numpy(), y)
    close(xt.grad.permute(0, 2, 3, 1).numpy(), gx)
    got_grads = _leaves(tree_to_flax({k: p.grad for k, p in block.named_parameters()}))
    for k, v in _leaves(gp).items():
        close(got_grads[k], v)
    _assert_tree_close(to_variables(block)["batch_stats"], stats, STATS_TOL, "block stats",
                       rtol=STATS_TOL)


def test_resnet_train_mode_matches_flax_in_float64():
    """The whole FANResNet of the tiny config in training mode, float64 on
    both sides (where no ReLU or max-pool choice sits within rounding of
    its boundary): output, input gradient and every gradient leaf within
    1e-4 of their norms, the running statistics within 1e-5."""
    from doc2tex_tpu.models.resnet import FANResNet as JaxFANResNet
    from doc2tex_tpu_torch.models.resnet import FANResNet

    images, _ = _batches(1)[0]
    x = (images.astype(np.float64) / 255.0 - 0.5) / 0.5
    w = np.random.default_rng(6).normal(size=(B, 1, BUCKET[1] // 4 + 1, 64))
    with jax.enable_x64(True):
        jnet = JaxFANResNet(output_channel=64, dtype=jnp.float64)
        shapes = jax.eval_shape(lambda: jnet.init(jax.random.PRNGKey(0),
                                                  jnp.zeros((1, *BUCKET, 1), jnp.float64)))
        variables = _random_variables(dict(shapes), np.random.default_rng(0))
        v64 = jax.tree_util.tree_map(lambda a: jnp.asarray(a, jnp.float64), variables)

        def f(p, x):
            y, new = jnet.apply({"params": p, "batch_stats": v64["batch_stats"]}, x,
                                train=True, mutable=["batch_stats"])
            return jnp.sum(y * w), (y, new["batch_stats"])

        (_, (y, stats)), (gp, gx) = jax.jit(jax.value_and_grad(f, argnums=(0, 1), has_aux=True))(
            v64["params"], jnp.asarray(x))
        y, stats, gp, gx = jax.tree_util.tree_map(np.asarray, (y, stats, gp, gx))
    net = FANResNet(1, 64, dtype=torch.float64)
    load_variables(net, variables)
    net = net.double()
    xt = torch.from_numpy(x).permute(0, 3, 1, 2).requires_grad_()
    yt = net(xt, True)
    (yt * torch.from_numpy(w).permute(0, 3, 1, 2)).sum().backward()

    def close(got, want, what):
        err = np.abs(got - want).max()
        assert err <= GRAD_TOL * np.linalg.norm(want) + GRAD_FLOOR, (what, err)

    close(yt.detach().permute(0, 2, 3, 1).numpy(), y, "output")
    close(xt.grad.permute(0, 2, 3, 1).numpy(), gx, "input gradient")
    got = _leaves(tree_to_flax({k: p.grad for k, p in net.named_parameters()}))
    want = _leaves(gp)
    assert set(got) == set(want) and len(want) > 80
    for k, v in want.items():
        close(got[k], v, k)
    _assert_tree_close(to_variables(net)["batch_stats"], stats, STATS_TOL, "trunk stats",
                       rtol=STATS_TOL)


def test_bf16_forward_loss_matches_jax(runs):
    cfg = dict(runs["cfg"], dtype="bfloat16")
    jmodel = jax_build_model(jax_make_config(cfg), V)
    port = build_model(make_config(cfg), V)
    load_variables(port, runs["variables"])
    images, text = runs["batches"][0]
    x = (images.astype(np.float32) / 255.0 - 0.5) / 0.5
    jcrit = jax_criterion_from_config(jax_make_config(cfg))

    @jax.jit
    def jloss(v, x, text):
        logits, _ = jmodel.apply(v, x, text[:, :-1], train=True, mutable=["batch_stats"])
        return jcrit(logits, text[:, 1:])

    want = float(jloss(jax.tree_util.tree_map(jnp.asarray, runs["variables"]),
                       jnp.asarray(x), jnp.asarray(text)))
    with torch.no_grad():
        logits = port(torch.from_numpy(x), torch.from_numpy(text[:, :-1]).long(), train=True)
    got = float(criterion_from_config(make_config(cfg))(logits, torch.from_numpy(text[:, 1:])))
    assert np.isfinite(got) and got == pytest.approx(want, rel=BF16_LOSS_RTOL)


def test_checkpoints_both_ways(runs):
    cfg, tmp = runs["cfg"], runs["tmp"]
    # JAX's step-2 checkpoint -> the port -> step 3 equals JAX's step 3
    port = build_model(make_config(cfg), V)
    template, ptx = create_train_state(port, make_config(cfg))
    state, meta = checkpoint.load_checkpoint(str(tmp / "jax_2.msgpack"), template)
    assert state.step == 2 and meta == {"iter": 2}
    step = make_train_step(port, criterion_from_config(make_config(cfg)), ptx, make_config(cfg))
    step(state, *runs["batches"][2], torch.Generator().manual_seed(0))
    assert state.step == 3
    _assert_params_close(to_variables(port)["params"], runs, 1)
    # the port's step-2 checkpoint -> JAX's load_checkpoint restores every leaf exactly
    jstate = runs["jstates"][0]
    restored, meta = jax_checkpoint.load_checkpoint(str(tmp / "port_2.msgpack"), jstate)
    assert int(restored.step) == 2 and meta == {"iter": 2}
    want_vars = runs["pvars"][1]
    for got, want in ((restored.params, want_vars["params"]),
                      (restored.batch_stats, want_vars["batch_stats"])):
        _assert_tree_close(got, want, 0.0, "restored by JAX")
    jax_opt = jax.tree_util.tree_map(
        np.asarray, jax_checkpoint.serialization.to_state_dict(restored.opt_state))
    assert jax.tree_util.tree_structure(jax_opt) == jax.tree_util.tree_structure(runs["popt_2"])
    _assert_tree_close(jax_opt, runs["popt_2"], 0.0, "opt_state restored by JAX")


def test_train_augment_matches_jax(monkeypatch):
    rng = np.random.default_rng(4)
    images = rng.integers(0, 256, (6, 20, 24, 1)).astype(np.uint8)
    draws = [np.array([True, False, True, True, False, True]),
             rng.uniform(0.0, 0.5, 6).astype(np.float32),
             np.array([False, True, True, False, False, True]),
             rng.uniform(-0.1, 0.1, 6).astype(np.float32)]
    queue = [jnp.asarray(d) for d in draws]
    monkeypatch.setattr(jax.random, "bernoulli", lambda *a, **k: queue.pop(0))
    monkeypatch.setattr(jax.random, "uniform", lambda *a, **k: queue.pop(0))
    want = np.asarray(jax_augment.train_augment(jax.random.PRNGKey(0), jnp.asarray(images)))
    got = augment(torch.from_numpy(images), *(torch.from_numpy(d) for d in draws)).numpy()
    np.testing.assert_allclose(got, want, atol=1e-6, rtol=0)
    n, p = 20000, 0.5
    sharp, factor, bright, delta = draw_augment(torch.Generator().manual_seed(1), n, "cpu")
    sigma = (p * (1 - p) / n) ** 0.5
    for applied in (sharp, bright):
        assert abs(applied.float().mean().item() - p) < 4 * sigma
    assert 0.0 <= factor.min() and factor.max() < 0.5 and -0.1 <= delta.min() < delta.max() < 0.1
    assert abs(factor.mean().item() - 0.25) < 4 * 0.5 / (12 * n) ** 0.5


def test_dropout_and_drop_path():
    g = torch.Generator().manual_seed(2)
    x = torch.rand(200, 500) + 0.5
    for fn in (dropout, drop_path):
        assert fn(x, 0.0, True, g) is x and fn(x, 0.3, False, g) is x
    keep, n = 0.7, x.numel()
    y = dropout(x, 0.3, True, g)
    kept = y != 0
    assert abs(kept.float().mean().item() - keep) < 4 * (keep * (1 - keep) / n) ** 0.5
    torch.testing.assert_close(y[kept], x[kept] / keep, rtol=0, atol=0)
    z = drop_path(x, 0.3, True, g)
    rows = (z != 0).all(dim=1)
    assert torch.equal(rows, (z != 0).any(dim=1))          # one draw per sample
    assert abs(rows.float().mean().item() - keep) < 4 * (keep * (1 - keep) / x.shape[0]) ** 0.5
    torch.testing.assert_close(z[rows], x[rows] / keep, rtol=0, atol=0)


def test_train_loader_equals_jax():
    vocab = hard_vocab()
    images, labels = synth_hard_dataset(40, seed=5, min_len=3, max_len=20, max_h=90, max_w=250,
                                        scale_range=(2, 3))
    cfg = dict(max_dimension=[96, 256], min_dimension=[32, 32], batch_max_length=20,
               batch_size=4, keep_smaller_batches=True, bucket_growth=1.5, augment=True,
               overpad_prob=0.5, overpad_ratio=4.0, pad_jitter=8)
    jl = JaxBucketLoader(JaxArrayDataset(images, labels), JaxTFMConverter(vocab),
                         jax_make_config(cfg), train=True, seed=7, prefetch=0)
    pl = BucketLoader(ArrayDataset(images, labels), make_config(cfg),
                      converter=TFMLabelConverter(vocab), train=True, seed=7)
    buckets = set()
    for (g, w), _ in zip(zip(pl.infinite(), jl.infinite()), range(6)):
        assert g.bucket == w.bucket and g.labels == w.labels and g.names == w.names
        assert g.images.dtype == np.uint8 and np.array_equal(g.images, w.images)
        assert np.array_equal(g.text, w.text) and np.array_equal(g.lengths, w.lengths)
        buckets.add(g.bucket)
    assert len(buckets) > 1


def test_to_variables_round_trip():
    port = build_model(make_config(train_config()), V)
    sd = port.state_dict()
    back = convert_variables(to_variables(port))
    assert set(back) == set(sd)
    for k, v in sd.items():
        assert torch.equal(back[k], v), k
    # the LSTM head's teacher-forced pass runs too (it raised, naming ROADMAP
    # A9, until the port trained that head; tests/test_torch_port_train_lstm.py
    # holds it against JAX's)
    logits = build_model(make_config(dict(train_config(), Prediction={
        "name": "Attnv2", "params": {"hidden_size": 64}})), V)(
        torch.zeros(1, 32, 64, 1), torch.zeros(1, 3, dtype=torch.long), train=True)
    assert logits.shape == (1, 3, V) and torch.isfinite(logits).all()


def test_pretrained_partial_restore_and_pos_embed_resize(tmp_path):
    """``load_pretrained_params`` takes the parameters only and
    ``load_pretrained_variables`` the statistics too, from a checkpoint of
    another model; ``resize_pos_embed`` equals JAX's within 4e-6 absolute,
    about two float32 ulps of the table's largest entries (~3): the
    weighted sums cancel, and their order differs."""
    cfg = make_config(train_config())
    src, dst = build_model(cfg, V), build_model(cfg, V)
    with torch.no_grad():
        for t in list(src.parameters()) + [b for b in src.buffers() if b.dim() == 1]:
            t.add_(torch.rand(t.shape, generator=torch.Generator().manual_seed(3)))
    checkpoint.save_checkpoint(str(tmp_path / "src.msgpack"), create_train_state(src, cfg)[0])
    stats_before = {k: v.clone() for k, v in dst.state_dict().items()
                    if k.endswith((".mean", ".var"))}
    info = checkpoint.load_pretrained_params(str(tmp_path / "src.msgpack"), dst)
    assert info == {"loaded": len(list(dst.parameters())), "skipped": 0, "resized": 0}
    for k, v in dst.state_dict().items():
        want = stats_before[k] if k in stats_before else src.state_dict()[k]
        assert torch.equal(v, want), k
    info = checkpoint.load_pretrained_variables(str(tmp_path / "src.msgpack"), dst)
    assert info["stats_loaded"] == len(stats_before)
    for k, v in dst.state_dict().items():
        assert torch.equal(v, src.state_dict()[k]), k
    table = np.random.default_rng(6).normal(size=(41, 8)).astype(np.float32)
    for n in (21, 41, 97):
        np.testing.assert_allclose(checkpoint.resize_pos_embed(table, n),
                                   jax_checkpoint.resize_pos_embed(table, n), atol=4e-6,
                                   rtol=0)


def _tiny_run_config(tmp_path, **overrides) -> str:
    from doc2tex_tpu_torch.config import load_yaml

    text = """max_dimension: [64, 128]
min_dimension: [32, 32]
batch_max_length: 12
batch_size: 4
dtype: float32
synthetic_data: 40
synthetic_style: flat
synthetic_kwargs:
  min_len: 2
  max_len: 8
  max_h: 60
valInterval: 2
num_iter: 2
logInterval: 1
sanity_check: True
FeatureExtraction:
  name: 'None'
SequenceModeling:
  name: 'ViT'
  params:
    backbone:
      name: 'resnet'
      input_channel: 1
      output_channel: 32
    fix_embed: True
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
    dim_feedforward: 64
    dropout: 0.1
optimizer:
  opt: 'adamw'
  lr: 0.001
  weight_decay: 0.00001
warmup_epochs: 0.5
"""
    path = tmp_path / "tiny.yaml"
    path.write_text(text)
    assert load_yaml(str(path))["Prediction"]["params"]["dropout"] == 0.1
    return str(path)


def test_keeper_and_sanity_run(tmp_path):
    from doc2tex_tpu_torch.api.train import main
    from doc2tex_tpu_torch.config import load_config
    from doc2tex_tpu_torch.engine.training import init_training, train
    from doc2tex_tpu_torch.weights import load_weights

    path = _tiny_run_config(tmp_path)
    cfg = load_config(path)
    bundle = init_training(cfg, device="cpu")
    metrics = train(cfg, str(tmp_path / "run"), device="cpu", bundle=bundle)
    assert bundle.state.step == 1 and metrics["n_samples"] >= 1 and np.isfinite(metrics["loss"])
    files = set(os.listdir(tmp_path / "run"))
    for name in ("best_bleu", "best_accuracy", "last_checkpoint"):
        assert {f"{name}.msgpack", f"{name}.msgpack.json"} <= files
        meta = json.loads((tmp_path / "run" / f"{name}.msgpack.json").read_text())
        # best_bleu is saved before the accuracy gate moves, as in the JAX keeper
        assert meta["iter"] == 1 and meta["best_bleu"] == metrics["bleu"]
        assert meta["best_acc"] == (-1.0 if name == "best_bleu" else metrics["accuracy"])
    assert {"config.txt", "summary.csv", "log_train.txt"} <= files
    fresh = build_model(cfg, cfg["num_class"])
    load_weights(fresh, str(tmp_path / "run" / "best_accuracy.msgpack"))
    for k, v in bundle.model.state_dict().items():
        assert torch.equal(fresh.state_dict()[k], v), k
    # the keeper: a worse validation writes only the last file; seed_best holds gates
    keeper = checkpoint.BestCheckpointKeeper(str(tmp_path / "keep"))
    keeper.seed_best({"best_bleu": 0.5, "best_acc": 0.9})
    assert keeper.update(bundle.state, 7, {"bleu": 0.4, "accuracy": 0.95}) == [
        "best_accuracy.msgpack", "last_checkpoint.msgpack"]
    # the CLI on the CPU
    main(["--config", path, "--device", "cpu", "--log_dir", str(tmp_path / "cli")])
    assert {"config.txt", "summary.csv", "best_bleu.msgpack", "best_accuracy.msgpack",
            "last_checkpoint.msgpack", "last_checkpoint.msgpack.json"} <= set(
        os.listdir(tmp_path / "cli"))


def test_chip_smoke_train_phase_runs_on_cpu(tmp_path):
    """chip_smoke's train phase at a tiny size on the CPU (random weights,
    hard data, the flat ladder of a 64x256 bucket): every sub-step's
    control flow, gates (a), (b), (d), (e) included."""
    import sys

    sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
    import chip_smoke
    from doc2tex_tpu_torch.config import load_config
    from doc2tex_tpu_torch.data.synthetic import HARD_VOCAB_PATH

    cfg = load_config(_tiny_run_config(tmp_path), sanity_check=False, synthetic_style="hard",
                      synthetic_data=80, vocab=HARD_VOCAB_PATH, max_dimension=[64, 256],
                      batch_max_length=20, num_iter=4, valInterval=4,
                      synthetic_kwargs={"min_len": 3, "max_len": 12, "max_h": 60,
                                        "max_w": 250, "scale_range": [2, 3]})
    recog = dict(cfg, clahe=False, bucket_growth=1.5)
    crops = [synth_hard_dataset(1, seed=s, min_len=3, max_len=10, max_h=60, max_w=250,
                                scale_range=(2, 3))[0][0] for s in range(3)]
    chip_smoke.train_phase(0.0, cfg=cfg, weights=None, recog=recog, crops=crops, device="cpu",
                           fixed=(4, (64, 256)), parity_batch=(2, (64, 128)))
