"""The port's model and decoders against the JAX package, at a tiny size.

ViT depth 2, width 64, 2 heads over a 64-channel ResNet; TFM head 2 layers,
d 64.  The JAX model's variables are drawn with numpy (every parameter and
BatchNorm statistic random, so each leaf matters), carried into the port by
``weights.py``, and the same numpy inputs go through both.  float32 on the CPU: encoder memory and
logits within 1e-4, greedy and beam tokens exactly.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from doc2tex_tpu.config import make_config as jax_make_config
from doc2tex_tpu.decode.beam import tfm_gather as jax_tfm_gather
from doc2tex_tpu.decode.runner import make_decode_fn as jax_make_decode_fn
from doc2tex_tpu.models import build_model as jax_build_model
from doc2tex_tpu_torch.config import make_config
from doc2tex_tpu_torch.decode.beam import tfm_gather
from doc2tex_tpu_torch.decode.runner import make_decode_fn
from doc2tex_tpu_torch.models import build_model
from doc2tex_tpu_torch.weights import load_variables
from torch_port_threads import one_torch_thread  # noqa: F401

V = 24            # 4 specials + 20 tokens
END = 2
BUCKETS = [(32, 64), (64, 128)]


def tiny_config() -> dict:
    return dict(
        max_dimension=[64, 128], min_dimension=[32, 32], batch_max_length=40,
        dtype="float32",
        FeatureExtraction={"name": "None"},
        SequenceModeling={"name": "ViT", "params": {
            "backbone": {"name": "resnet", "input_channel": 1, "output_channel": 64,
                         "gcb": False},
            "fix_embed": True, "input_channel": 1, "patching_style": "2d",
            "patch_size": [2, 2], "depth": 2, "num_heads": 2, "hidden_size": 64}},
        Prediction={"name": "TFM", "params": {
            "d_model": 64, "nhead": 2, "num_decoder_layers": 2, "dim_feedforward": 128,
            "dropout": 0.0}},
    )


def _random_variables(shapes, rng) -> dict:
    """numpy draws for every leaf of the flax variable tree ``shapes``."""

    def draw(path, leaf):
        name = path[-1].key
        shape = leaf.shape
        if name in ("var",):
            return rng.uniform(0.5, 1.5, shape).astype(np.float32)
        if name in ("scale",) or name.endswith(("_n1_s", "_n2_s", "_n3_s")):
            return (1.0 + rng.normal(0.0, 0.1, shape)).astype(np.float32)
        if len(shape) >= 2 and name != "cls_token":
            fan_in = int(np.prod(shape[:-1]))
            return rng.normal(0.0, fan_in ** -0.5, shape).astype(np.float32)
        return rng.normal(0.0, 0.1 if name != "word_embed" else 0.5, shape).astype(np.float32)

    return jax.tree_util.tree_map_with_path(draw, shapes)


@pytest.fixture(scope="module")
def pair():
    """(jax model, jax variables, port model) sharing random weights."""
    cfg = tiny_config()
    jmodel = jax_build_model(jax_make_config(cfg), V)
    shapes = jax.eval_shape(
        lambda: jmodel.init(jax.random.PRNGKey(0), jnp.zeros((1, 32, 64, 1)),
                            jnp.zeros((1, 41), jnp.int32), train=False))
    variables = _random_variables(dict(shapes), np.random.default_rng(0))
    # the end token's bias decides how often beams finish: at this value
    # some rows finish and some never do (asserted by the beam test)
    variables["params"]["predicter"]["b_proj"][END] = 0.6
    port = build_model(make_config(cfg), V).eval()
    assert load_variables(port, variables) == len(jax.tree_util.tree_leaves(variables))
    return jmodel, jax.tree_util.tree_map(jnp.asarray, variables), port


def _images(bucket, n, seed):
    rng = np.random.default_rng(seed)
    img = rng.integers(0, 256, (n, *bucket, 1)).astype(np.uint8)
    img[:, :, : bucket[1] // 3] = 255   # white margin, like padded crops
    return img


def _normalized(img):
    return (img.astype(np.float32) / 255.0 - 0.5) / 0.5


@pytest.mark.parametrize("bucket", BUCKETS)
def test_encode_matches_jax(pair, bucket):
    jmodel, variables, port = pair
    x = _normalized(_images(bucket, 2, seed=1))
    encode = jax.jit(lambda v, x: jmodel.apply(v, x, method="encode"))
    ref = np.asarray(encode(variables, jnp.asarray(x)))
    with torch.no_grad():
        got = port.encode(torch.from_numpy(x)).numpy()
    assert got.shape == ref.shape
    np.testing.assert_allclose(got, ref, atol=1e-4, rtol=0)


def test_decode_step_logits_match_jax(pair):
    """Three decode steps with a beam shuffle between them: logits within
    1e-4 at each step."""
    jmodel, variables, port = pair
    B, K, T = 2, 3, 6
    x = _normalized(_images(BUCKETS[1], B, seed=2))
    jenc = jax.jit(lambda v, x: jmodel.apply(v, x, method="encode"))(variables, jnp.asarray(x))
    jstate = jax.jit(lambda v, e: jmodel.apply(v, e, T, K, method="init_decode_state"))(
        variables, jenc)
    jstep = jax.jit(lambda v, s, t: jmodel.apply(v, s, t, method="decode_step"))
    with torch.no_grad():
        penc = port.encode(torch.from_numpy(x))
        pstate = port.init_decode_state(penc, T, K)
    rng = np.random.default_rng(3)
    for _ in range(3):
        tokens = rng.integers(1, V, (B * K,)).astype(np.int32)
        jstate, jlogits = jstep(variables, jstate, jnp.asarray(tokens))
        with torch.no_grad():
            pstate, plogits = port.decode_step(pstate, torch.from_numpy(tokens).long())
        np.testing.assert_allclose(plogits.numpy(), np.asarray(jlogits), atol=1e-4, rtol=0)
        beam_idx = rng.integers(0, K, (B, K)).astype(np.int32)
        jstate = jax_tfm_gather(jstate, jnp.asarray(beam_idx), B, K)
        pstate = tfm_gather(pstate, torch.from_numpy(beam_idx).long(), B, K)
        np.testing.assert_array_equal(pstate.sel.numpy(), np.asarray(jstate.sel) > 0.5)


@pytest.mark.parametrize("beam", [1, 5])
def test_decode_tokens_match_jax(pair, beam):
    """Greedy and beam-5 decodes of 41 steps in 5 cache chunks: token-exact, with
    rows that finish and (beam 5) a row in which no beam finishes."""
    jmodel, variables, port = pair
    cfg = tiny_config()
    images = _images(BUCKETS[0], 4, seed=4)
    jfn = jax_make_decode_fn(jmodel, jax_make_config(cfg), beam_size=beam, jit=True)
    jtok, _ = jfn(variables, jnp.asarray(images))
    pfn = make_decode_fn(port, make_config(cfg), beam_size=beam, device="cpu")
    ptok, _ = pfn(images)
    jtok = np.asarray(jtok)
    np.testing.assert_array_equal(ptok.numpy(), jtok)
    finished = (jtok == END).any(axis=1)
    assert finished.any()
    if beam > 1:
        assert not finished.all(), "the data must hold a row where no beam finishes"
