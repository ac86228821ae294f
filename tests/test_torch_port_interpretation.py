"""Interpretation's twin (``doc2tex_tpu_torch/tools/interpretation.py``)
against ``doc2tex_tpu.tools.interpretation`` on tiny models, the same
numpy-drawn variables in both packages (float32):

- the ViT blocks' attention probabilities and the rollout with mean, max
  and min head fusion within 1e-5 of JAX's;
- the feature maps (ResNet and embedding outputs, and the sown attention
  probabilities) under the same keys, within 1e-5 of each map's largest
  magnitude (the ResNet's activations are tens);
- the coverage-LSTM head's decoder maps within 1e-5 on its patch grid; a
  TFM head gives none in both packages;
- capture off (the default) leaves the encoder's output bit-identical to
  a run with capture on, and capture is off again after it;
- the numpy helpers (``upsample_map``, ``saliency_overlay``,
  ``select_samples``) equal JAX's.

The file imports JAX only inside its tests, and holds torch to one thread.
"""

from __future__ import annotations

import os
import sys

import numpy as np
import pytest
import torch

from doc2tex_tpu_torch.config import make_config
from doc2tex_tpu_torch.models import build_model
from doc2tex_tpu_torch.models.layers import SelfAttention
from doc2tex_tpu_torch.tools import interpretation
from doc2tex_tpu_torch.weights import load_variables

HERE = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, HERE)
from test_torch_port_coalesce import _tiny_config as _tiny_tfm_config  # noqa: E402
from torch_port_threads import one_torch_thread  # noqa: E402,F401

TOL = 1e-5
V = 30


def _tiny_lstm_config() -> dict:
    cfg = _tiny_tfm_config()
    cfg["SequenceModeling"]["params"]["depth"] = 2
    cfg["Prediction"] = {"name": "Attnv2", "params": {
        "seqmodel": "TFM", "input_size": 16, "hidden_size": 16, "kernel_size": 2,
        "kernel_dim": 8, "embed_target": True, "enc_init": True, "attn_type": "coverage",
        "method": "concat", "droprate": 0.0}}
    return cfg


def _pair(cfg):
    import jax
    import jax.numpy as jnp

    jax.config.update("jax_platforms", "cpu")
    from doc2tex_tpu.config import make_config as jax_make_config
    from doc2tex_tpu.models import build_model as jax_build_model

    from test_torch_port_model import _random_variables

    jmodel = jax_build_model(jax_make_config(cfg), V)
    shapes = jax.eval_shape(lambda: jmodel.init(
        jax.random.PRNGKey(0), jnp.zeros((1, 32, 96, 1)), jnp.zeros((1, 12), jnp.int32),
        train=False))
    variables = _random_variables(dict(shapes), np.random.default_rng(0))
    port = build_model(make_config(cfg), V).eval()
    load_variables(port, jax.tree_util.tree_map(np.asarray, variables))
    return jmodel, variables, port


def _image(seed=0):
    return np.random.default_rng(seed).standard_normal((2, 32, 96, 1)).astype(np.float32)


@pytest.fixture(scope="module")
def tfm_pair():
    return _pair(_tiny_tfm_config())


@pytest.fixture(scope="module")
def lstm_pair():
    return _pair(_tiny_lstm_config())


@pytest.mark.parametrize("fusion", ["mean", "max", "min"])
def test_rollout_equals_jax(lstm_pair, fusion):
    from doc2tex_tpu.tools import interpretation as jax_interp

    jmodel, variables, port = lstm_pair
    x = _image()
    want = jax_interp.collect_vit_attention(jmodel, variables, x)
    got = interpretation.collect_vit_attention(port, x)
    assert len(got) == len(want) == 2
    for g, w in zip(got, want):
        np.testing.assert_allclose(g, w, atol=TOL, rtol=0)
    np.testing.assert_allclose(interpretation.attention_rollout(got, fusion, 0.5),
                               jax_interp.attention_rollout(want, fusion, 0.5), atol=TOL, rtol=0)


def test_feature_maps_equal_jax(tfm_pair):
    from doc2tex_tpu.tools import interpretation as jax_interp

    jmodel, variables, port = tfm_pair
    x = _image(1)
    want = jax_interp.collect_feature_maps(jmodel, variables, x)
    got = interpretation.collect_feature_maps(port, x)
    assert sorted(got) == sorted(want) and len(got) == 4
    for key, w in want.items():     # activations of tens: TOL of each map's largest value
        np.testing.assert_allclose(got[key], w, atol=TOL * np.abs(w).max(), rtol=0, err_msg=key)


def test_decoder_maps_equal_jax(lstm_pair, tfm_pair):
    from doc2tex_tpu.tools import interpretation as jax_interp

    x = _image(2)[:1]       # JAX's maps feed one token a step: batch 1
    tokens = np.array([1, 5, 9, 3, 7])
    jmodel, variables, port = lstm_pair
    S = port.encode(torch.from_numpy(x)).shape[1]
    grid = (1, S - 1)       # the memory holds the class token first
    want = jax_interp.decoder_attention_maps(jmodel, variables, x, tokens, grid)
    got = interpretation.decoder_attention_maps(port, x, tokens, grid)
    assert len(got) == len(want) == len(tokens)
    for g, w in zip(got, want):
        assert g.shape == w.shape == grid
        np.testing.assert_allclose(g, w, atol=TOL, rtol=0)
    jmodel, variables, port = tfm_pair
    assert interpretation.decoder_attention_maps(port, x, tokens, grid) == [] == \
        jax_interp.decoder_attention_maps(jmodel, variables, x, tokens, grid)


def test_capture_off_moves_no_bit(tfm_pair):
    _, _, port = tfm_pair
    x = torch.from_numpy(_image(3))
    attn = [m for m in port.modules() if isinstance(m, SelfAttention)]
    assert attn and all(m.capture is None for m in attn)
    with torch.no_grad():
        off = port.encode(x)
        with interpretation.capture_attention(port) as captured:
            on = port.encode(x)
        after = port.encode(x)
    assert all(len(v) == 1 for v in captured.values())
    assert torch.equal(off, on) and torch.equal(off, after)
    assert all(m.capture is None for m in attn)


def test_numpy_helpers_equal_jax():
    from doc2tex_tpu.tools import interpretation as jax_interp

    rng = np.random.default_rng(4)
    m = rng.random((3, 7)).astype(np.float32)
    img = rng.integers(0, 256, (30, 80)).astype(np.uint8)
    np.testing.assert_array_equal(interpretation.upsample_map(m, (30, 80)),
                                  jax_interp.upsample_map(m, (30, 80)))
    for image in (img, np.repeat(img[..., None], 3, -1)):
        np.testing.assert_array_equal(interpretation.saliency_overlay(image, m, 0.4),
                                      jax_interp.saliency_overlay(image, m, 0.4))
    rows = [{"name": f"n{i}", "pred": " ".join("x" * (i % 9)), "label": "x",
             "iscorrect": i % 3 == 0} for i in range(40)]
    for cond in (None, "(len < 5 & len > 1)", "(len >= 3)%iscorrect: True",
                 "%iscorrect: False"):
        assert interpretation.select_samples(rows, cond, seed=2) == \
            jax_interp.select_samples(rows, cond, seed=2)
