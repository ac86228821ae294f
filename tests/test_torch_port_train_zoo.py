"""Training the zoo's heads in the port, against the JAX package on the CPU,
at tiny widths (``torch_port_zoo_cases.cnn_config``: 64 channels, batch 3 at
32x64, ``batch_max_length`` 8): one float32 train step (adamw, clip 5, no
warmup, dropout 0) of

- ``vgg_bahdanau_d_not_h``: the bahdanau head (B2's content form) on a VGG
  map, D 64 != H 32;
- ``vgg_coverage_d_not_h``: the coverage head on the same map, D 64 != H 32;
- ``luong_concat``: the luong head (``concat``) over ResNet + BiLSTM;
- ``gcb_bilstm_coverage``: the coverage head over the GCB ResNet and the
  BiLSTM stage with its GatedSum blend;

against JAX's ``make_train_step`` from the same numpy-drawn variables on
the same numpy batch: the loss within 1e-5 relative and the token accuracy
equal; every gradient leaf of the head and the BiLSTM within 1e-4 of its
norm (+1e-7), the ResNet's and the VGG's within 5e-2 (float32 ReLU flips,
as ``test_torch_port_train.py`` states them); the weights after the step
within 2 lr + 1e-6.  ``b_score``: the port gives it no gradient (the
attention step never sees the score bias, which moves no alpha) and JAX's
is float noise, so it is left out (``test_torch_port_train_lstm.py`` holds
it by its effect).  On the CPU the heads run the plain steps under
autograd; ``tests/test_torch_port_cuda.py`` and ``chip_smoke.py`` hold the
card's kernels to those.
"""

from __future__ import annotations

import copy

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from doc2tex_tpu.config import make_config as jax_make_config
from doc2tex_tpu.models import build_model as jax_build_model
from doc2tex_tpu.train.optim import optimizer_from_config as jax_optimizer_from_config
from doc2tex_tpu.train.trainer import TrainState as JaxTrainState
from doc2tex_tpu.train.trainer import criterion_from_config as jax_criterion_from_config
from doc2tex_tpu.train.trainer import make_train_step as jax_make_train_step
from doc2tex_tpu_torch.config import make_config
from doc2tex_tpu_torch.models import build_model
from doc2tex_tpu_torch.train.trainer import (create_train_state, criterion_from_config,
                                             loss_and_grads, make_train_step)
from doc2tex_tpu_torch.transforms.augment import normalize
from doc2tex_tpu_torch.weights import load_variables, random_variables, to_variables, tree_to_flax
from torch_port_threads import one_torch_thread  # noqa: F401
from torch_port_zoo_cases import BUCKET, V, cnn_config

B, MAX_LEN = 3, 8
LOSS_RTOL, GRAD_TOL, GRAD_FLOOR = 1e-5, 1e-4, 1e-7
CNN_GRAD_RTOL = 5e-2        # float32 ReLU flips (tests/test_torch_port_train.py)
CNN = ("featextractor/", "FeatureExtraction/")

TRAIN = dict(grad_clip=5.0, valInterval=4, num_iter=16, warmup_epochs=0, min_lr=1e-4,
             optimizer={"opt": "adamw", "lr": 1e-3, "weight_decay": 0.05})
CASES = {
    "vgg_bahdanau_d_not_h": cnn_config("VGG", "None", "Attn", "bahdanau",
                                       pred_params={"hidden_size": 32, "enc_init": True}),
    "vgg_coverage_d_not_h": cnn_config("VGG", "None", "Attn", "coverage",
                                       pred_params={"hidden_size": 32, "enc_init": True}),
    "luong_concat": cnn_config("ResNet", "BiLSTM", "Attn", "luong", "concat"),
    "gcb_bilstm_coverage": cnn_config("ResNet", "BiLSTM", "Attn", "coverage",
                                      feat_params={"gcb": True},
                                      seq_params={"pos_enc": True}),
}


def _batch(seed):
    rng = np.random.default_rng(seed)
    images = rng.integers(0, 256, (B, *BUCKET, 1)).astype(np.uint8)
    text = np.zeros((B, MAX_LEN + 2), np.int32)        # [GO] = pad = 0
    for i, n_tok in enumerate(rng.integers(2, MAX_LEN + 1, B)):
        text[i, 1: 1 + n_tok] = rng.integers(3, V, n_tok)
        text[i, 1 + n_tok] = 1                          # [s]
    return images, text


def _leaves(tree):
    return {"/".join(str(getattr(k, "key", k)) for k in path): np.asarray(v)
            for path, v in jax.tree_util.tree_flatten_with_path(tree)[0]}


@pytest.mark.parametrize("case", sorted(CASES))
def test_zoo_train_step_matches_jax(case):
    cfg = dict(CASES[case], batch_max_length=MAX_LEN, **TRAIN)
    jcfg = jax_make_config(cfg)
    jmodel = jax_build_model(jcfg, V)
    shapes = jax.eval_shape(lambda: jmodel.init(
        jax.random.PRNGKey(0), jnp.zeros((1, *BUCKET, 1)), jnp.zeros((1, MAX_LEN + 1), jnp.int32),
        train=False))
    variables = random_variables(shapes, np.random.default_rng(0))
    port = build_model(make_config(cfg), V)
    assert load_variables(port, variables) == len(jax.tree_util.tree_leaves(variables))
    params = jax.tree_util.tree_map(jnp.asarray, variables["params"])
    stats = jax.tree_util.tree_map(jnp.asarray, variables.get("batch_stats", {}))
    jtx = jax_optimizer_from_config(jcfg, params)
    jcrit = jax_criterion_from_config(jcfg)
    images, text = _batch(7)
    x = (jnp.asarray(images, jnp.float32) / 255.0 - 0.5) / 0.5

    def jloss(p):
        logits, _ = jmodel.apply({"params": p, "batch_stats": stats}, x,
                                 jnp.asarray(text[:, :-1]), train=True, mutable=["batch_stats"])
        return jcrit(logits, jnp.asarray(text[:, 1:]))

    jgrads = jax.jit(jax.grad(jloss))(params)
    jstate, jm = jax_make_train_step(jmodel, jcrit, jtx, jcfg)(
        JaxTrainState(jnp.int32(0), params, stats, jtx.init(params)), jnp.asarray(images),
        jnp.asarray(text), jax.random.PRNGKey(1))
    crit = criterion_from_config(make_config(cfg))
    _, _, pgrads = loss_and_grads(copy.deepcopy(port), crit, normalize(torch.from_numpy(images)),
                                  torch.from_numpy(text).long())
    pstate, ptx = create_train_state(port, make_config(cfg))
    pm = make_train_step(port, crit, ptx, make_config(cfg))(pstate, images, text,
                                                            torch.Generator().manual_seed(0))

    assert float(pm["loss"]) == pytest.approx(float(jm["loss"]), rel=LOSS_RTOL)
    assert float(pm["token_acc"]) == float(jm["token_acc"])
    want, got = _leaves(jgrads), _leaves(tree_to_flax(pgrads))
    assert set(got) == set(want)
    head = 0
    for k, w in want.items():
        if k.endswith("/b_score"):
            assert np.all(got[k] == 0.0)
            continue
        rtol = CNN_GRAD_RTOL if k.startswith(CNN) else GRAD_TOL
        head += k.startswith("predicter/")
        err = np.abs(got[k] - w).max()
        assert err <= rtol * np.linalg.norm(w) + GRAD_FLOOR, (k, err, np.linalg.norm(w))
    assert head > 0
    lr = float(cfg["optimizer"]["lr"])
    got_p, want_p = _leaves(to_variables(port)["params"]), _leaves(jstate.params)
    for k in want_p:
        assert np.abs(got_p[k] - np.asarray(want_p[k])).max() <= 2 * lr + 1e-6, k
