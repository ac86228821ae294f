"""The port's optimizers, schedule, criteria and msgpack writer against the
JAX package (optax, flax), on the CPU.

- every optimizer name ``create_optimizer`` takes, ``lookahead_adamw`` and
  ``accum_grad`` 2, over a small tree with 1-D, 2-D, 4-D (a conv kernel:
  HWIO in flax, OIHW in the port) and (1, 1, D) leaves, clip 1.0 and a
  warmup cosine: the parameters after 3 updates within 1e-6 of optax's,
  and the optimizer state laid out as ``flax.serialization.to_state_dict``
  lays out optax's, with equal leaves (1e-6) and read back by
  ``state_from_flax``;
- ``schedule_from_config``: equal to the JAX function's float32 values
  (as written, run op by op) at steps 0, 1, the warmup's end, mid-run, the
  horizon and twice the horizon, and on a degenerate horizon.  (XLA's
  compiled form of the JAX function differs from its own op-by-op values,
  by up to ~5e-6 relative near the horizon where 1 + cos cancels, so it is
  not the reference here);
- the two criteria with padding and an all-pad row, within 1e-6 relative;
  a batch of padding gives 0;
- ``_msgpack.packb`` gives ``msgpack_serialize``'s bytes.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch
from flax import serialization

from doc2tex_tpu.train.loss import create_criterion as jax_create_criterion
from doc2tex_tpu.train.optim import create_optimizer as jax_create_optimizer
from doc2tex_tpu.train.schedule import schedule_from_config as jax_schedule_from_config
from doc2tex_tpu.train.schedule import warmup_cosine_schedule as jax_warmup_cosine
from doc2tex_tpu_torch import _msgpack
from doc2tex_tpu_torch.train import optim
from doc2tex_tpu_torch.train.loss import create_criterion
from doc2tex_tpu_torch.train.schedule import schedule_from_config, warmup_cosine_schedule
from doc2tex_tpu_torch.weights import convert_variables, tree_to_flax

SHAPES = {"conv": {"kernel": (3, 2, 4, 5)}, "dense": {"kernel": (6, 7), "bias": (7,)},
          "cls_token": (1, 1, 8)}
OPT_TOL = 1e-6


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    """One torch thread for this file: its tensors are tiny, and the
    suite's xdist workers (each with a thread pool as large as the
    machine) otherwise oversubscribe the cores many times over."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _draw(rng, shapes, scale):
    return {k: _draw(rng, v, scale) if isinstance(v, dict)
            else rng.normal(0.0, scale, v).astype(np.float32) for k, v in shapes.items()}


def _port(tree) -> dict:
    return dict(convert_variables({"params": tree}))


def _max_diff(a, b) -> float:
    la, lb = jax.tree_util.tree_leaves(a), jax.tree_util.tree_leaves(b)
    assert len(la) == len(lb)
    return max((float(np.abs(np.asarray(x, np.float64) - np.asarray(y, np.float64)).max())
                for x, y in zip(la, lb)), default=0.0)


@pytest.mark.parametrize("opt,accum", [
    ("adamw", 1), ("adam", 1), ("adamp", 1), ("adadelta", 1), ("adagrad", 1), ("lamb", 1),
    ("madgrad", 1), ("sgd", 1), ("lookahead_adamw", 1), ("adamw", 2)])
def test_optimizer_matches_optax(opt, accum):
    rng = np.random.default_rng(0)
    params = _draw(rng, SHAPES, 1.0)
    grads = [_draw(rng, SHAPES, 0.5) for _ in range(4)]
    kw = dict(opt=opt, lr=1e-2, weight_decay=0.05, grad_clip=1.0, accum_grad=accum)
    jp = jax.tree_util.tree_map(jnp.asarray, params)
    jtx = jax_create_optimizer(jp, schedule=jax_warmup_cosine(1e-2, 1e-3, 1, 4, 2), **kw)
    pp = _port(params)
    ptx = optim.create_optimizer(pp, schedule=warmup_cosine_schedule(1e-2, 1e-3, 1, 4, 2), **kw)
    js, ps = jtx.init(jp), ptx.init(pp)
    jstep = jax.jit(jtx.update)
    # 3 updates; lookahead syncs every 6, so it takes 6 to cross a sync
    updates = 6 if opt.startswith("lookahead_") else 3
    for i in range(updates * accum):
        ju, js = jstep(jax.tree_util.tree_map(jnp.asarray, grads[i % 4]), js, jp)
        jp = optax.apply_updates(jp, ju)
        pu, ps = ptx.update(_port(grads[i % 4]), ps, pp)
        pp = {k: pp[k] + pu[k] for k in pp}
        assert _max_diff(jp, tree_to_flax(pp)) <= OPT_TOL, f"update {i}"
    jlayout = jax.tree_util.tree_map(np.asarray, serialization.to_state_dict(js))
    playout = optim.state_to_flax(ps)
    assert jax.tree_util.tree_structure(jlayout) == jax.tree_util.tree_structure(playout)
    assert _max_diff(jlayout, playout) <= OPT_TOL
    restored = optim.state_from_flax(ptx.init(pp), jlayout)
    assert _max_diff(optim.state_to_flax(restored), jlayout) <= OPT_TOL


def test_state_from_flax_refuses_another_layout():
    rng = np.random.default_rng(1)
    pp = _port(_draw(rng, SHAPES, 1.0))
    adamw = optim.create_optimizer(pp, opt="adamw", weight_decay=0.1, grad_clip=5.0)
    sgd = optim.create_optimizer(pp, opt="sgd", grad_clip=5.0)
    with pytest.raises(ValueError, match="opt_state"):
        optim.state_from_flax(adamw.init(pp), optim.state_to_flax(sgd.init(pp)))


SCHEDULE_CONFIGS = [
    # the release recipe's schedule; the warmup's end at 10000, the horizon 100000
    (dict(valInterval=25000, num_iter=100000, warmup_epochs=0.4, min_lr=1e-4,
          optimizer={"lr": 5e-4}), [0, 1, 10000, 55000, 100000, 200000]),
    (dict(valInterval=7, num_iter=100, warmup_epochs=2, min_lr=1e-5, accum_grad=2,
          optimizer={"lr": 1e-3}), [0, 1, 14, 27, 49, 98]),
    # degenerate horizon: num_iter < valInterval
    (dict(valInterval=50, num_iter=10, warmup_epochs=5, min_lr=1e-5,
          optimizer={"lr": 1e-3}), [0, 1, 45, 49, 50, 100]),
]


@pytest.mark.parametrize("cfg,steps", SCHEDULE_CONFIGS)
def test_schedule_matches_jax(cfg, steps):
    jax_fn, port_fn = jax_schedule_from_config(cfg), schedule_from_config(cfg)
    for s in steps:
        want = np.float32(jax_fn(jnp.int32(s)))
        got = np.float32(port_fn(s))
        assert got == want, (s, got, want)
    if cfg["num_iter"] < cfg["valInterval"]:   # held at one epoch: the rate moves
        assert port_fn(steps[2]) > 0


@pytest.mark.parametrize("name", ["entropy", "smooth"])
def test_criteria_match_jax(name):
    rng = np.random.default_rng(2)
    logits = rng.normal(0.0, 2.0, (3, 7, 11)).astype(np.float32)
    targets = rng.integers(1, 11, (3, 7)).astype(np.int32)
    targets[0, 4:] = 0          # padding
    targets[2, :] = 0           # an all-pad row
    want = float(jax_create_criterion(name, 0)(jnp.asarray(logits), jnp.asarray(targets)))
    got = float(create_criterion(name, 0)(torch.from_numpy(logits), torch.from_numpy(targets)))
    assert got == pytest.approx(want, rel=1e-6)
    zero = create_criterion(name, 0)(torch.from_numpy(logits), torch.zeros((3, 7), dtype=torch.long))
    assert float(zero) == 0.0


def test_msgpack_writer_equals_flax():
    rng = np.random.default_rng(3)
    tree = {"step": np.asarray(3, np.int32),
            "params": {"a": {"kernel": rng.random((3, 4, 5, 6)).astype(np.float32)},
                       "b" * 40: np.float32(2.5), "empty": {}},
            "opt_state": {str(i): {"count": np.asarray(i, np.int32)} for i in range(20)},
            "bytes": np.zeros(70000, np.uint8), "n": -5, "m": 70000, "f": 1.5,
            "s": "x" * 300, "t": True}
    assert _msgpack.packb(tree) == serialization.msgpack_serialize(tree)
    back = _msgpack.unpackb(_msgpack.packb(tree))
    assert back["step"].shape == () and int(back["step"]) == 3 and back["params"]["empty"] == {}
