"""Training the coverage-LSTM head in the port, against the JAX package on
the CPU, at a tiny size: ViT 16x1 over a 16-channel ResNet, an ``Attnv2``
head at D = H = 16 with 8 location features, batch 3 at 32x64 (S 9),
``batch_max_length`` 6 (T 7), float32 unless stated.  The JAX model's
variables are numpy draws, carried into the port by ``weights.py``; the
inputs are numpy draws too.

- B2's backward, written out (``coverage_attention_step_backward_reference``,
  and ``content_attention_step_backward_reference`` for bahdanau), against
  ``torch.autograd.grad`` of the plain steps in float64 over a 3-step
  sequence, where each step's alpha feeds the next step's memory (the
  coverage, or the last alignment for ``loc_aware``) and the loss, so both
  cotangents (context and alpha) reach every step; S in {3, 7, 12} (below
  the 5 taps, and the conv's edges on both sides), a masked ``valid_len``,
  and D = H or D != H (enc 24 wide, H 16): every gradient within 1e-10 of
  its largest magnitude.
- Teacher-forced logits (``forward(train=False)``) against JAX's
  ``__call__(train=False)``, coverage and loc_aware: within 1e-5.
- One float32 train step (adamw, clip 5, no warmup) against JAX's
  ``make_train_step``: loss within 1e-5 relative, token accuracy equal;
  every gradient leaf of the head and the ViT within 1e-4 of its norm
  (+1e-7), the ResNet's within 5e-2 (float32 ReLU flips, as
  ``test_torch_port_train.py`` states them); the weights after the step
  within 2 lr + 1e-6.  ``b_score``: JAX's gradient is ``sum_s g_e``, zero
  but for float noise, and AdamW turns that noise into a move of about lr;
  the port gives no gradient (the kernel never sees the score bias), so
  ``b_score`` is held by its effect: JAX's logits after the step with the
  port's ``b_score`` in place of JAX's are within 1e-6 of JAX's own.
- bfloat16: the train-mode loss within 1e-2 relative of JAX's (both round
  the attention memory and the ViT to bf16 at other points); the worst
  gradient leaf against JAX's is printed, not gated (JAX adds the memory's
  per-step cotangents in bf16, autograd too, in other orders).
- The device pools (``data.device_pool``) against JAX's: buckets, sizes,
  pixels and labels equal, and ``pool_schedule`` the same sequence.
- The soak twin's configs against ``tools/structured_soak.build`` for
  every ``--hard`` arm.
- A port checkpoint of the tiny LSTM model that JAX's ``load_checkpoint``
  restores leaf for leaf.
- ``python -m doc2tex_tpu_torch.api.train --config config/train_synth.yaml
  --device cpu`` cut to 2 steps; chip_smoke's train_lstm phase rehearsed at
  a tiny size.
"""

from __future__ import annotations

import copy
import importlib.util
import os
import re

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from doc2tex_tpu.config import make_config as jax_make_config
from doc2tex_tpu.data import device_pool as jax_device_pool
from doc2tex_tpu.data.loader import ArrayDataset as JaxArrayDataset
from doc2tex_tpu.data.loader import BucketLoader as JaxBucketLoader
from doc2tex_tpu.models import build_model as jax_build_model
from doc2tex_tpu.tokenizer.converters import AttnLabelConverter as JaxAttnConverter
from doc2tex_tpu.train import checkpoint as jax_checkpoint
from doc2tex_tpu.train.optim import optimizer_from_config as jax_optimizer_from_config
from doc2tex_tpu.train.trainer import TrainState as JaxTrainState
from doc2tex_tpu.train.trainer import criterion_from_config as jax_criterion_from_config
from doc2tex_tpu.train.trainer import make_train_step as jax_make_train_step
from doc2tex_tpu_torch.config import load_config, make_config
from doc2tex_tpu_torch.data import device_pool
from doc2tex_tpu_torch.data.loader import ArrayDataset, BucketLoader
from doc2tex_tpu_torch.data.synthetic import hard_vocab, synth_hard_dataset
from doc2tex_tpu_torch.models import build_model
from doc2tex_tpu_torch.ops.attention_step import (
    content_attention_step_backward, content_attention_step_backward_reference,
    content_attention_step_reference, coverage_attention_step, coverage_attention_step_backward,
    coverage_attention_step_backward_reference, coverage_attention_step_reference)
from doc2tex_tpu_torch.tokenizer.converters import AttnLabelConverter
from doc2tex_tpu_torch.train import checkpoint
from doc2tex_tpu_torch.train.trainer import (create_train_state, criterion_from_config,
                                             loss_and_grads, make_train_step)
from doc2tex_tpu_torch.transforms.augment import normalize
from doc2tex_tpu_torch.weights import load_variables, to_variables, tree_to_flax
from tests.test_torch_port_model import _random_variables
from torch_port_threads import one_torch_thread  # noqa: F401

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
V = 20                                  # Attn family: [GO]=0, [s]=1, [UNK]=2, 17 tokens
B, BUCKET, MAX_LEN = 3, (32, 64), 6     # S 9, T 7
BWD_TOL = 1e-10                         # float64: the two orders of the same sums
LOGITS_TOL = 1e-5
LOSS_RTOL, GRAD_TOL, GRAD_FLOOR = 1e-5, 1e-4, 1e-7
RESNET_GRAD_RTOL = 5e-2                 # float32 ReLU flips (tests/test_torch_port_train.py)
BF16_LOSS_RTOL = 1e-2
B_SCORE_LOGITS_TOL = 1e-6
RESNET = "seqmodeler/HybridEmbed_0/ResNetFeatureExtractor_0/"
HARD_ARMS = ({}, {"attn": "loc_aware"}, {"big": True}, {"family": "tfm"},
             {"family": "tfm", "big": True}, {"family": "tfm", "big": True, "long": True})


def tiny_config(attn="coverage", dtype="float32", **overrides) -> dict:
    cfg = dict(
        max_dimension=[32, 96], min_dimension=[32, 32], batch_max_length=MAX_LEN, dtype=dtype,
        FeatureExtraction={"name": "None"},
        SequenceModeling={"name": "ViT", "params": {
            "backbone": {"name": "resnet", "input_channel": 1, "output_channel": 16,
                         "gcb": False},
            "fix_embed": True, "input_channel": 1, "patching_style": "2d",
            "patch_size": [2, 2], "depth": 1, "num_heads": 2, "hidden_size": 16}},
        Prediction={"name": "Attnv2", "params": {
            "seqmodel": "TFM", "input_size": 16, "hidden_size": 16, "kernel_size": 2,
            "kernel_dim": 8, "embed_target": True, "enc_init": True, "attn_type": attn,
            "droprate": 0.0}},
        grad_clip=5.0, valInterval=4, num_iter=16, warmup_epochs=0, min_lr=1e-4,
        optimizer={"opt": "adamw", "lr": 1e-3, "weight_decay": 0.05})
    cfg.update(overrides)
    return cfg


def _batch(seed=0, n=B, bucket=BUCKET):
    rng = np.random.default_rng(seed)
    images = rng.integers(0, 256, (n, *bucket, 1)).astype(np.uint8)
    text = np.zeros((n, MAX_LEN + 2), np.int32)       # [GO] = pad = 0
    for i, n_tok in enumerate(rng.integers(2, MAX_LEN + 1, n)):
        text[i, 1: 1 + n_tok] = rng.integers(3, V, n_tok)
        text[i, 1 + n_tok] = 1                          # [s]
    return images, text


def _leaves(tree):
    return {"/".join(str(getattr(k, "key", k)) for k in path): np.asarray(v)
            for path, v in jax.tree_util.tree_flatten_with_path(tree)[0]}


@pytest.fixture(scope="module")
def pairs():
    """attn type -> (JAX model, its variables, the port's model), the
    same numpy draws in both."""
    out = {}
    for attn in ("coverage", "loc_aware"):
        cfg = tiny_config(attn)
        jmodel = jax_build_model(jax_make_config(cfg), V)
        shapes = jax.eval_shape(lambda: jmodel.init(  # noqa: B023
            jax.random.PRNGKey(0), jnp.zeros((1, *BUCKET, 1)),
            jnp.zeros((1, MAX_LEN + 1), jnp.int32), train=False))
        variables = _random_variables(dict(shapes), np.random.default_rng(3))
        port = build_model(make_config(cfg), V)
        load_variables(port, variables)
        out[attn] = (jmodel, variables, port)
    return out


# ---- B2's backward, written out ---------------------------------------------

@pytest.mark.parametrize("S", [3, 7, 12])
@pytest.mark.parametrize("attn", ["coverage", "loc_aware", "bahdanau", "coverage_d_not_h",
                                  "bahdanau_d_not_h"])
def test_backward_reference_matches_autograd_over_a_sequence(attn, S):
    """Three steps; the loss reads every step's context and the last
    memory (bahdanau: the sum of the alignments), so each step's alpha gets
    a cotangent from the next step's location term and from the loss.  The
    written-out backward (the coverage form's, or the content form's for
    bahdanau; ``_d_not_h``: enc 24 wide, H 16), chained by hand in reverse,
    against autograd of the whole sequence."""
    rng = np.random.default_rng(S)
    kind = attn.removesuffix("_d_not_h")
    Bt, H, Kl, T = 2, 16, 8, 3
    D = 24 if attn.endswith("_d_not_h") else H
    valid = S - 1 if S == 12 else None

    def draw(*shape, scale=1.0):
        return torch.from_numpy(rng.normal(size=shape) * scale)

    w = dict(enc=draw(Bt, S, D), enc_proj=draw(Bt, S, H), loc_conv_w=draw(5, 1, Kl, scale=0.5),
             loc_conv_b=draw(Kl, scale=0.1), w_loc=draw(Kl, H, scale=0.35),
             b_loc=draw(H, scale=0.2), w_score=draw(H, 1, scale=0.4))
    if kind == "bahdanau":
        w = {k: w[k] for k in ("enc", "enc_proj", "w_score")}
    qs, g_ctx = [draw(Bt, H) for _ in range(T)], [draw(Bt, D) for _ in range(T)]
    g_last = draw(Bt, S)
    leaves = {k: v.clone().requires_grad_() for k, v in w.items()}
    q_leaves = [q.clone().requires_grad_() for q in qs]
    cum = prev = torch.zeros(Bt, S, dtype=torch.float64)
    loss, saved = 0.0, []
    for t in range(T):
        mem = cum if kind == "coverage" else prev
        if kind == "bahdanau":
            ctx, alpha = content_attention_step_reference(
                leaves["enc"], leaves["enc_proj"], q_leaves[t], leaves["w_score"],
                valid_len=valid)
        else:
            ctx, alpha = coverage_attention_step_reference(
                leaves["enc"], leaves["enc_proj"], q_leaves[t], mem, leaves["loc_conv_w"],
                leaves["loc_conv_b"], leaves["w_loc"], leaves["b_loc"], leaves["w_score"],
                valid_len=valid)
        saved.append((mem.detach(), alpha.detach()))
        loss = loss + (ctx * g_ctx[t]).sum()
        cum, prev = cum + alpha, alpha
    loss = loss + ((prev if kind == "loc_aware" else cum) * g_last).sum()
    names = list(leaves)
    grads = torch.autograd.grad(loss, [leaves[k] for k in names] + q_leaves)
    want = dict(zip(names + [f"q{t}" for t in range(T)], grads))

    got = {k: torch.zeros_like(v) for k, v in w.items()}
    g_mem = g_last.clone()         # the cotangent of the memory the next step reads
    for t in reversed(range(T)):
        mem, alpha = saved[t]
        if kind == "bahdanau":     # alpha feeds only the loss's sum
            d_enc, d_ep, d_q, d_ws = content_attention_step_backward_reference(
                w["enc"], w["enc_proj"], qs[t], w["w_score"], alpha, g_ctx[t], g_last)
            parts = (("enc", d_enc), ("enc_proj", d_ep), ("w_score", d_ws.reshape(-1, 1)))
        else:
            d_enc, d_ep, d_q, d_mem, d_cw, d_cb, d_wl, d_bl, d_ws = \
                coverage_attention_step_backward_reference(
                    w["enc"], w["enc_proj"], qs[t], mem, w["loc_conv_w"], w["loc_conv_b"],
                    w["w_loc"], w["w_score"], w["b_loc"], alpha, g_ctx[t], g_mem)
            parts = (("enc", d_enc), ("enc_proj", d_ep), ("loc_conv_w", d_cw),
                     ("loc_conv_b", d_cb), ("w_loc", d_wl), ("b_loc", d_bl),
                     ("w_score", d_ws.reshape(-1, 1)))
            # coverage: cum_t = cum_{t-1} + alpha_t; loc_aware: the memory is alpha_{t-1}
            g_mem = g_mem + d_mem if kind == "coverage" else d_mem
        for k, v in parts:
            got[k] += v
        got[f"q{t}"] = d_q
    assert set(got) == set(want)
    for k, v in want.items():
        err = (got[k] - v).abs().max().item()
        assert err <= BWD_TOL * max(v.abs().max().item(), 1.0), (k, err)
    if valid is not None:
        assert want["enc_proj"][:, valid:].abs().max().item() == 0.0


def test_backward_wrapper_on_the_cpu_is_the_plain_version():
    """On CPU tensors the wrapper returns the plain version and launches
    nothing; a K > 1 call is refused, as the kernel takes K = 1."""
    rng = np.random.default_rng(0)
    f32 = lambda *s: torch.from_numpy(rng.normal(size=s).astype(np.float32))  # noqa: E731
    args = [f32(2, 7, 16), f32(2, 7, 16), f32(2, 16), f32(2, 7).abs(), f32(5, 1, 8), f32(8),
            f32(8, 16), f32(16, 1), f32(16)]
    _, alpha = coverage_attention_step_reference(*args[:7], args[8], args[7])
    args += [alpha, f32(2, 16), f32(2, 7)]
    before = coverage_attention_step_backward.launches
    got = coverage_attention_step_backward(*args)
    want = coverage_attention_step_backward_reference(*args)
    assert coverage_attention_step_backward.launches == before
    assert all(torch.equal(a, b) for a, b in zip(got, want))
    with pytest.raises(ValueError, match="K = 1"):
        coverage_attention_step_backward_reference(args[0], args[1], torch.cat([args[2]] * 2),
                                                   *args[3:])
    content = [args[0], args[1], args[2], args[7], args[9], args[10], args[11]]
    before = content_attention_step_backward.launches
    got = content_attention_step_backward(*content)
    assert content_attention_step_backward.launches == before
    assert all(torch.equal(a, b) for a, b in
               zip(got, content_attention_step_backward_reference(*content)))


# ---- the teacher-forced pass -------------------------------------------------

@pytest.mark.parametrize("attn", ["coverage", "loc_aware"])
def test_teacher_forced_logits_match_jax(pairs, attn):
    jmodel, variables, port = pairs[attn]
    images, text = _batch(1)
    x = ((images.astype(np.float32) / 255.0 - 0.5) / 0.5)
    want = np.asarray(jax.jit(lambda v, x, t: jmodel.apply(v, x, t, train=False))(
        variables, jnp.asarray(x), jnp.asarray(text[:, :-1])))
    before = coverage_attention_step.launches
    with torch.no_grad():
        got = port(torch.from_numpy(x), torch.from_numpy(text[:, :-1]).long(), train=False)
    assert coverage_attention_step.launches == before    # the CPU runs the plain version
    assert got.shape == (B, MAX_LEN + 1, V) and got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), want, atol=LOGITS_TOL, rtol=0)


def test_logit_dropout_draws_from_the_generator():
    """With ``train`` the stacked logits take one dropout at ``droprate``
    from the generator: the same seed, the same mask; none at train=False."""
    cfg = tiny_config(Prediction={"name": "Attnv2", "params": dict(
        tiny_config()["Prediction"]["params"], droprate=0.5)})
    torch.manual_seed(0)
    model = build_model(make_config(cfg), V)
    images, text = _batch(2)
    x = normalize(torch.from_numpy(images))
    t = torch.from_numpy(text[:, :-1]).long()
    with torch.no_grad():
        plain = model.predicter(model.encode(x), t, train=False)
        a = model.predicter(model.encode(x), t, True, torch.Generator().manual_seed(4))
        b = model.predicter(model.encode(x), t, True, torch.Generator().manual_seed(4))
    assert torch.equal(a, b)
    kept = a != 0
    assert 0.3 < kept.float().mean().item() < 0.7
    torch.testing.assert_close(a[kept], plain[kept] / 0.5)


# ---- one train step against JAX's ---------------------------------------------

@pytest.fixture(scope="module")
def step_runs(pairs):
    """One JAX step and one port step from the same variables on the same
    batch (coverage), JAX's gradient, and the port's."""
    jmodel, variables, port = pairs["coverage"]
    port = copy.deepcopy(port)
    cfg = tiny_config()
    jcfg = jax_make_config(cfg)
    params = jax.tree_util.tree_map(jnp.asarray, variables["params"])
    stats = jax.tree_util.tree_map(jnp.asarray, variables["batch_stats"])
    jtx = jax_optimizer_from_config(jcfg, params)
    jcrit = jax_criterion_from_config(jcfg)
    images, text = _batch(5)

    def jloss(p, x, t):
        logits, _ = jmodel.apply({"params": p, "batch_stats": stats}, x, t[:, :-1], train=True,
                                 mutable=["batch_stats"])
        return jcrit(logits, t[:, 1:])

    x = (jnp.asarray(images, jnp.float32) / 255.0 - 0.5) / 0.5
    jgrads = jax.jit(jax.grad(jloss))(params, x, jnp.asarray(text))
    jstep = jax_make_train_step(jmodel, jcrit, jtx, jcfg)
    jstate, jm = jstep(JaxTrainState(jnp.int32(0), params, stats, jtx.init(params)),
                       jnp.asarray(images), jnp.asarray(text), jax.random.PRNGKey(1))
    crit = criterion_from_config(make_config(cfg))
    _, _, pgrads = loss_and_grads(copy.deepcopy(port), crit, normalize(torch.from_numpy(images)),
                                  torch.from_numpy(text).long())
    pstate, ptx = create_train_state(port, make_config(cfg))
    pm = make_train_step(port, crit, ptx, make_config(cfg))(pstate, images, text,
                                                            torch.Generator().manual_seed(0))
    return dict(jmodel=jmodel, jgrads=jgrads, jstate=jax.tree_util.tree_map(np.asarray, jstate),
                jm=jax.tree_util.tree_map(np.asarray, jm), pgrads=pgrads,
                pm={k: v.numpy() for k, v in pm.items()}, pvars=to_variables(port),
                images=images, text=text, lr=float(cfg["optimizer"]["lr"]), pstate=pstate,
                cfg=cfg)


def test_train_step_matches_jax(step_runs):
    r = step_runs
    assert float(r["pm"]["loss"]) == pytest.approx(float(r["jm"]["loss"]), rel=LOSS_RTOL)
    assert float(r["pm"]["token_acc"]) == float(r["jm"]["token_acc"])
    want = _leaves(r["jgrads"])
    got = _leaves(tree_to_flax(r["pgrads"]))
    assert set(got) == set(want)
    b_score = next(k for k in want if k.endswith("/b_score"))
    assert np.all(got[b_score] == 0.0)                     # the port: no gradient
    total = np.sqrt(sum(float(np.sum(v ** 2)) for v in want.values()))
    assert np.abs(want[b_score]).max() <= 1e-6 * total     # JAX: float noise
    head = 0
    for k, w in want.items():
        if k == b_score:
            continue
        rtol = RESNET_GRAD_RTOL if k.startswith(RESNET) else GRAD_TOL
        head += k.startswith("predicter/")
        err = np.abs(got[k] - w).max()
        assert err <= rtol * np.linalg.norm(w) + GRAD_FLOOR, (k, err, np.linalg.norm(w))
    assert head == 20                                     # the head but b_score
    # the weights after the step: Adam's first update is about -lr * sign(g)
    got_p, want_p = _leaves(r["pvars"]["params"]), _leaves(r["jstate"].params)
    for k in want_p:
        assert np.abs(got_p[k] - want_p[k]).max() <= 2 * r["lr"] + 1e-6, k


def test_b_score_moves_no_logit(step_runs):
    """JAX's b_score after the step against the port's, by their effect:
    JAX's logits with the port's b_score in its place."""
    r = step_runs
    params = jax.tree_util.tree_map(jnp.asarray, r["jstate"].params)
    swapped = jax.tree_util.tree_map(lambda a: a, params)
    pb = r["pvars"]["params"]["predicter"]["b_score"]
    assert not np.array_equal(np.asarray(params["predicter"]["b_score"]), pb)
    swapped["predicter"]["b_score"] = jnp.asarray(pb)
    x = (jnp.asarray(r["images"], jnp.float32) / 255.0 - 0.5) / 0.5

    @jax.jit
    def logits(p):
        return r["jmodel"].apply({"params": p, "batch_stats": r["jstate"].batch_stats}, x,
                                 jnp.asarray(r["text"][:, :-1]), train=False)

    np.testing.assert_allclose(np.asarray(logits(swapped)), np.asarray(logits(params)),
                               atol=B_SCORE_LOGITS_TOL, rtol=0)


def test_bf16_train_loss_matches_jax(pairs):
    _, variables, _ = pairs["coverage"]
    cfg = tiny_config(dtype="bfloat16")
    jmodel = jax_build_model(jax_make_config(cfg), V)
    port = build_model(make_config(cfg), V)
    load_variables(port, variables)
    images, text = _batch(6)
    x = (jnp.asarray(images, jnp.float32) / 255.0 - 0.5) / 0.5
    jcrit = jax_criterion_from_config(jax_make_config(cfg))

    def jloss(p):
        logits, _ = jmodel.apply({"params": p, "batch_stats": variables["batch_stats"]}, x,
                                 jnp.asarray(text[:, :-1]), train=True, mutable=["batch_stats"])
        return jcrit(logits, jnp.asarray(text[:, 1:]))

    want, jgrads = jax.jit(jax.value_and_grad(jloss))(variables["params"])
    loss, _, grads = loss_and_grads(port, criterion_from_config(make_config(cfg)),
                                    normalize(torch.from_numpy(images)),
                                    torch.from_numpy(text).long())
    assert float(loss) == pytest.approx(float(want), rel=BF16_LOSS_RTOL)
    got, want_g = _leaves(tree_to_flax(grads)), _leaves(jgrads)
    worst = max((np.abs(got[k] - w).max() / (np.linalg.norm(w) + GRAD_FLOOR), k)
                for k, w in want_g.items() if not k.endswith("b_score"))
    print(f"bf16: loss {float(loss):.6f} / JAX {float(want):.6f}; worst gradient leaf "
          f"{worst[0]:.3e} of its norm ({worst[1]})")


def test_lstm_checkpoint_restores_in_jax(step_runs, tmp_path):
    r = step_runs
    path = str(tmp_path / "lstm.msgpack")
    checkpoint.save_checkpoint(path, r["pstate"], {"iter": 1})
    restored, meta = jax_checkpoint.load_checkpoint(path, jax.tree_util.tree_map(
        jnp.asarray, r["jstate"]))
    assert int(restored.step) == 1 and meta == {"iter": 1}
    assert "predicter/loc_conv_w" in _leaves(restored.params)
    for got, want in ((restored.params, r["pvars"]["params"]),
                      (restored.batch_stats, r["pvars"]["batch_stats"])):
        got, want = _leaves(got), _leaves(want)
        assert set(got) == set(want)
        for k in want:
            assert np.array_equal(got[k], want[k]), k


# ---- device pools and the soak twin -------------------------------------------

def test_device_pools_match_jax():
    cfg = dict(tiny_config(), max_dimension=[64, 256], batch_size=4, bucket_growth=2.2,
               keep_smaller_batches=False, batch_max_length=12)
    images, labels = synth_hard_dataset(40, seed=31, min_len=3, max_len=10, max_h=60,
                                        max_w=250, scale_range=(2, 3))
    vocab = hard_vocab()
    jloader = JaxBucketLoader(JaxArrayDataset(images, labels), JaxAttnConverter(vocab),
                              jax_make_config(cfg), train=True, prefetch=0)
    jpools = jax_device_pool.build_device_pools(jloader, JaxAttnConverter(vocab), cfg)
    conv = AttnLabelConverter(vocab)
    loader = BucketLoader(ArrayDataset(images, labels), make_config(cfg), converter=conv,
                          train=True)
    pools = device_pool.build_device_pools(loader, conv, cfg, device="cpu")
    assert len(pools) == len(jpools) >= 2
    for p, jp in zip(pools, jpools):
        assert p.bucket == jp.bucket and p.n == jp.n
        assert p.images.dtype == torch.uint8 and p.text.dtype == torch.int32
        np.testing.assert_array_equal(p.images.numpy(), np.asarray(jp.images))
        np.testing.assert_array_equal(p.text.numpy(), np.asarray(jp.text))
    got = device_pool.pool_schedule(pools, 4, np.random.default_rng(5))
    want = jax_device_pool.pool_schedule(jpools, 4, np.random.default_rng(5))
    assert [int(next(got)) for _ in range(50)] == [int(next(want)) for _ in range(50)]
    # a pool step draws its batch on the pools' device and trains on it
    seen = []
    step = device_pool.make_pool_step(lambda s, im, t, g: seen.append((im, t)) or {"loss": 0},
                                      4)
    step(None, torch.Generator().manual_seed(7), pools[0].images, pools[0].text)
    im, t = seen[0]
    assert im.shape == (4, *pools[0].bucket, 1) and t.shape == (4, 14)


def _jax_soak():
    spec = importlib.util.spec_from_file_location(
        "jax_structured_soak", os.path.join(ROOT, "tools", "structured_soak.py"))
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


@pytest.mark.parametrize("arm", HARD_ARMS, ids=lambda a: "-".join(f"{k}={v}" for k, v in a.items())
                         or "attn")
def test_soak_configs_match_jax(arm, monkeypatch):
    from doc2tex_tpu_torch.tools import structured_soak

    # JAX's build sets a compilation cache directory; keep it out of this process
    monkeypatch.setattr(jax.config, "update", lambda *a, **k: None)
    want = dict(_jax_soak().build(1000, hard=True, **arm))
    assert structured_soak.build(1000, hard=True, **arm) == want
    argv = ["--hard", "--steps", "1000"] + [x for k, v in arm.items() for x in (
        [f"--{k}"] if v is True else [f"--{k}", v])]
    args = structured_soak.parse_args(argv)
    assert structured_soak.arm_config(args) == want
    tag = structured_soak.run_tag(args)
    assert tag.startswith("hard") and (("tfm" in tag) == (arm.get("family") == "tfm"))
    # the default arm trains on the structured generator (its own tag);
    # --gcb (the GlobalContext backbone) gets JAX's tag suffix
    assert structured_soak.run_tag(structured_soak.parse_args(["--steps", "10"])) == "structured"
    assert structured_soak.run_tag(structured_soak.parse_args(
        ["--hard", "--gcb", "--family", "tfm", "--big"])) == "hard_tfm_gcb_big"


# ---- the CLI and chip_smoke's phase on the CPU --------------------------------

def test_api_train_synth_config_on_cpu(tmp_path):
    """``api.train --config config/train_synth.yaml --device cpu``, the
    config cut to 2 steps, 24 samples (validation 4) at its widths."""
    from doc2tex_tpu_torch.api.train import main

    text = open(os.path.join(ROOT, "config", "train_synth.yaml")).read()
    for key, value in (("synthetic_data", 24), ("num_iter", 2), ("valInterval", 2),
                       ("logInterval", 1)):
        text, n = re.subn(rf"(?m)^{key}:.*$", f"{key}: {value}", text)
        assert n == 1, key
    path = tmp_path / "train_synth_cut.yaml"
    path.write_text(text)
    cfg = load_config(str(path))
    assert cfg["Prediction"]["name"] == "Attnv2" and cfg["vocab"] == ""
    main(["--config", str(path), "--device", "cpu", "--log_dir", str(tmp_path / "run")])
    files = set(os.listdir(tmp_path / "run"))
    assert {"config.txt", "summary.csv", "best_bleu.msgpack", "last_checkpoint.msgpack",
            "last_checkpoint.msgpack.json"} <= files
    payload, meta = jax_checkpoint.load_checkpoint(str(tmp_path / "run" /
                                                       "last_checkpoint.msgpack"))
    assert int(np.asarray(payload["step"])) == 2 and meta["iter"] == 2
    assert "loc_conv_w" in payload["params"]["predicter"]


def test_chip_smoke_train_lstm_phase_runs_on_cpu(tmp_path, monkeypatch):
    """chip_smoke's train_lstm phase at a tiny size on the CPU (random
    weights, the soak's build swapped for a tiny recipe, a tiny
    train_synth-like run): every sub-step's control flow and the gates of
    (a)-(d); (e) needs the card."""
    import sys

    sys.path.insert(0, ROOT)
    import chip_smoke
    from doc2tex_tpu_torch.tools import structured_soak

    tiny = dict(tiny_config(), max_dimension=[64, 256], batch_size=4, batch_max_length=12,
                keep_smaller_batches=False, bucket_growth=2.2, beam_size=5, augment=False)
    tiny["Prediction"]["params"]["droprate"] = 0.1
    monkeypatch.setattr(structured_soak, "build",
                        lambda steps, **kw: make_config(dict(copy.deepcopy(tiny), num_iter=steps,
                                                             valInterval=500,
                                                             warmup_epochs=0.4)))
    monkeypatch.setattr(structured_soak, "HARD_KW", {"min_len": 3, "max_len": 10, "max_h": 60,
                                                     "max_w": 250, "scale_range": (2, 3)})
    recipe = chip_smoke.lstm_recipe_config()
    assert recipe["batch_size"] == 4 and len(recipe["character"]) > 600
    run_cfg = make_config(dict(copy.deepcopy(tiny), synthetic_data=40, synthetic_style="flat",
                               synthetic_kwargs={"min_len": 2, "max_len": 8, "max_h": 60},
                               num_iter=2, valInterval=2, logInterval=1,
                               keep_smaller_batches=True, vocab=""))
    out = chip_smoke.train_lstm_phase(
        0.0, recipe=recipe, run_cfg=run_cfg, weights=None, device="cpu", fixed=(4, (64, 256)),
        soak_argv=("--hard", "--steps", "2", "--n_train", "48", "--n_eval", "24",
                   "--eval_every", "2", "--eval_first", "--lr", "1e-4"))
    assert out is None
