"""The release tools' twins against the JAX package and the repository's
tools (``tools/export_demo_weights.py``, ``tools/train_resizer.py``,
``tools/e2e_demo.py``):

- ``export_demo_weights``: a port training checkpoint (optimizer state
  and all) exported in float16 and float32 gives the same bytes and the
  same sidecar (but its source path) as the JAX tool's export of it, and
  restores equal in both packages' ``load_pretrained_variables``;
- ``train_resizer``: the probes and bucket targets of ``build_dataset``
  equal JAX's bit for bit (the off-scale draw and the 2x regime); the
  first loss on the JAX-initialised weights (ordinal and one-hot) within
  1e-5 of JAX's ``loss_fn``; ``flax_init`` draws flax's default layout;
- ``e2e_demo`` at a tiny width runs its loop (train, keep, reload,
  evaluate) on the CPU, and the reloaded last checkpoint decodes the same
  beam tokens as the in-memory model.

The file imports JAX only inside its tests, and holds torch to one thread.
"""

from __future__ import annotations

import copy
import json
import os
import sys

import numpy as np
import pytest
import torch

HERE = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(HERE)
sys.path.insert(0, ROOT)
sys.path.insert(0, HERE)
from torch_port_threads import one_torch_thread  # noqa: E402,F401

from doc2tex_tpu_torch.config import make_config  # noqa: E402
from doc2tex_tpu_torch.decode.runner import make_decode_fn  # noqa: E402
from doc2tex_tpu_torch.models import build_model  # noqa: E402
from doc2tex_tpu_torch.models.extras import LearnedResizer  # noqa: E402
from doc2tex_tpu_torch.tools import e2e_demo, export_demo_weights, train_resizer  # noqa: E402
from doc2tex_tpu_torch.train.checkpoint import (load_pretrained_variables,  # noqa: E402
                                                save_checkpoint)
from doc2tex_tpu_torch.train.trainer import create_train_state  # noqa: E402
from doc2tex_tpu_torch.weights import load_variables, to_variables  # noqa: E402


def _tiny_demo_config(steps: int):
    cfg = copy.deepcopy(dict(e2e_demo.demo_config(steps)))
    seq = cfg["SequenceModeling"]["params"]
    seq.update(depth=1, num_heads=2, hidden_size=16)
    seq["backbone"]["output_channel"] = 16
    cfg["Prediction"]["params"].update(input_size=16, hidden_size=16, kernel_dim=8)
    cfg.update(batch_size=8, dtype="float32")
    return make_config(cfg)


@pytest.fixture(scope="module")
def checkpoint(tmp_path_factory):
    """A port training checkpoint of the tiny demo model after one
    optimizer update (non-zero moments)."""
    cfg = _tiny_demo_config(4)
    model = build_model(cfg, 40)
    state, tx = create_train_state(model, cfg)
    params = {k: p.detach() for k, p in model.named_parameters()}
    grads = {k: torch.full_like(p, 0.01) for k, p in params.items()}
    updates, state.opt_state = tx.update(grads, state.opt_state, params)
    with torch.no_grad():
        for k, p in params.items():
            p.add_(updates[k])
    state.step = 1
    path = str(tmp_path_factory.mktemp("ckpt") / "last.msgpack")
    save_checkpoint(path, state, {"iter": 1, "best_acc": 0.5})
    return path, cfg, model


@pytest.mark.parametrize("dtype", ["float16", "float32"])
def test_export_equals_jax_and_restores_in_both(checkpoint, tmp_path, dtype):
    import jax
    import jax.numpy as jnp

    jax.config.update("jax_platforms", "cpu")
    from doc2tex_tpu.config import make_config as jax_make_config
    from doc2tex_tpu.models import build_model as jax_build_model
    from doc2tex_tpu.train.checkpoint import load_pretrained_variables as jax_load
    from tools import export_demo_weights as jax_export

    ckpt, cfg, model = checkpoint
    ours, theirs = str(tmp_path / "port.msgpack"), str(tmp_path / "jax.msgpack")
    info = export_demo_weights.export(ckpt, ours, dtype)
    jinfo = jax_export.export(ckpt, theirs, dtype)
    assert open(ours, "rb").read() == open(theirs, "rb").read()
    assert {k: v for k, v in info.items() if k != "source"} == \
        {k: v for k, v in jinfo.items() if k != "source"}
    with open(ours + ".json") as f:
        assert json.load(f)["source_meta"] == {"iter": 1, "best_acc": 0.5}

    want = to_variables(model)
    cast = np.dtype(dtype)
    fresh = build_model(cfg, 40)
    load_pretrained_variables(ours, fresh)
    got = to_variables(fresh)
    jmodel = jax_build_model(jax_make_config(dict(cfg)), 40)
    shapes = jax.eval_shape(lambda: jmodel.init(
        jax.random.PRNGKey(0), jnp.zeros((1, 32, 128, 1)), jnp.zeros((1, 26), jnp.int32),
        train=False))
    zeros = jax.tree_util.tree_map(lambda s: np.zeros(s.shape, s.dtype), shapes)
    jparams, jstats, jinfo = jax_load(ours, zeros["params"], zeros["batch_stats"])
    assert jinfo["skipped"] == 0
    for kind, tree in (("params", jparams), ("batch_stats", jstats)):
        flat_want = dict(_leaves(want[kind]))
        flat_jax = dict(_leaves(jax.tree_util.tree_map(np.asarray, tree)))
        flat_got = dict(_leaves(got[kind]))
        assert flat_want.keys() == flat_jax.keys() == flat_got.keys()
        for key, w in flat_want.items():
            expect = w.astype(cast).astype(np.float32) if kind == "params" else w
            np.testing.assert_array_equal(flat_got[key], expect, err_msg=key)
            np.testing.assert_array_equal(np.asarray(flat_jax[key], np.float32), expect,
                                          err_msg=key)


def _leaves(tree, prefix=()):
    for k, v in tree.items():
        if isinstance(v, dict):
            yield from _leaves(v, prefix + (k,))
        else:
            yield prefix + (k,), v


@pytest.mark.parametrize("seed,lo,hi", [(41, 0.4, 2.5), (42, 2.0, 2.0)])
def test_resizer_probes_equal_jax(seed, lo, hi):
    from tools import train_resizer as jax_train_resizer

    got = train_resizer.build_dataset(5, seed, lo, hi)
    want = jax_train_resizer.build_dataset(5, seed, lo, hi)
    for g, w in zip(got[:2], want[:2]):
        assert g.dtype == w.dtype and np.array_equal(g, w)
    assert all(np.array_equal(a, b) for a, b in zip(got[2], want[2]))
    assert got[3] == want[3]
    assert [train_resizer.native_bucket(w) for w in (10, 31, 48, 700, 1000)] == [
        jax_train_resizer.native_bucket(w) for w in (10, 31, 48, 700, 1000)]


@pytest.mark.parametrize("tau", [0.7, 0.0])
def test_resizer_first_loss_equals_jax(tau):
    import jax
    import jax.numpy as jnp
    import optax

    jax.config.update("jax_platforms", "cpu")
    from doc2tex_tpu.models.extras import LearnedResizer as JaxResizer

    probes, labels, _, _ = train_resizer.build_dataset(8, 41)
    jmodel = JaxResizer(num_buckets=train_resizer.N_BUCKETS)
    variables = jax.jit(jmodel.init)(jax.random.PRNGKey(0), jnp.zeros((2, 64, 64, 1)))

    def loss_fn(p, x, y):      # tools/train_resizer.py's loss_fn
        logits, _ = jmodel.apply({"params": p, "batch_stats": variables["batch_stats"]}, x,
                                 train=True, mutable=["batch_stats"])
        if tau > 0:
            d = (jnp.arange(train_resizer.N_BUCKETS)[None, :] - y[:, None]).astype(jnp.float32)
            t = jax.nn.softmax(-(d * d) / (2 * tau ** 2), -1)
            return optax.softmax_cross_entropy(logits, t).mean()
        return optax.softmax_cross_entropy_with_integer_labels(logits, y).mean()

    want = float(loss_fn(variables["params"], jnp.asarray(probes), jnp.asarray(labels)))
    model = LearnedResizer(num_buckets=train_resizer.N_BUCKETS)
    load_variables(model, jax.tree_util.tree_map(np.asarray, variables))
    with torch.no_grad():
        got = float(train_resizer.resizer_loss(model, torch.from_numpy(probes),
                                               torch.from_numpy(labels).long(), tau))
    assert abs(got - want) <= 1e-5 * max(1.0, abs(want)), (got, want)


def test_resizer_flax_init_layout():
    model = LearnedResizer(num_buckets=train_resizer.N_BUCKETS)
    init = train_resizer.flax_init(to_variables(model), np.random.default_rng(0))
    load_variables(model, init)
    leaves = dict(_leaves(init))
    kernel = leaves[("params", "Conv_0", "kernel")]
    assert np.abs(kernel).max() <= 2 / 0.87962566103423978 * kernel[..., :1].size ** -0.5 * 1.001
    assert all((v == 1).all() for k, v in leaves.items() if k[-1] in ("scale", "var"))
    assert all((v == 0).all() for k, v in leaves.items() if k[-1] in ("bias", "mean"))


def test_e2e_demo_runs_and_reload_decodes_the_same(tmp_path):
    out = e2e_demo.run(steps=2, n_train=24, n_eval=6, device="cpu", log_dir=str(tmp_path),
                       reload="last_checkpoint", cfg=_tiny_demo_config(2))
    assert out["steps"] == 2 and out["n_eval"] == 6 and 0.0 <= out["em"] <= 1.0
    assert sorted(os.listdir(tmp_path)) == sorted(
        f + s for f in ("best_accuracy.msgpack", "best_bleu.msgpack", "last_checkpoint.msgpack")
        for s in ("", ".json"))
    model, reloaded = out["models"]
    cfg = out["config"]
    from doc2tex_tpu_torch.data.buckets import pad_to_bucket

    batch = np.stack([pad_to_bucket(im, (64, 512)) for im in out["eval_images"]])[..., None]
    a = make_decode_fn(model, cfg, beam_size=5, device="cpu")(batch)[0]
    b = make_decode_fn(reloaded, cfg, beam_size=5, device="cpu")(batch)[0]
    assert torch.equal(a, b)
