"""The rest of the model zoo against the JAX package, at a tiny size: the
stage matrix of ``tests/test_model_variants.py`` (ResNet/VGG feature
stages, the BiLSTM stage with and without its GatedSum position blend, the
coverage and bahdanau heads, the TFM head over a 2D map; the luong heads
are ``test_torch_port_zoo_luong.py``'s), held as
``torch_port_zoo_cases.check_case_matches_jax`` says.

Also here: the plain B2 content form (no location term) and coverage form
at D != H against JAX's ``attention_step_reference`` and its interpret-mode
kernel, the refusals the JAX model keeps, and where ``quantize: int8``
reaches on a CNN model.
"""

from __future__ import annotations

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from doc2tex_tpu_torch.config import make_config
from doc2tex_tpu_torch.models import build_model
from torch_port_threads import one_torch_thread  # noqa: F401
from torch_port_zoo_cases import (LUONG, STAGE_MATRIX, V, check_case_matches_jax, cnn_config,
                                  vit_config)


@pytest.mark.parametrize("case", sorted(set(STAGE_MATRIX) - set(LUONG)))
def test_zoo_case_matches_jax(case):
    check_case_matches_jax(STAGE_MATRIX[case])


@pytest.mark.parametrize("D,H,K", [(64, 32, 1), (48, 64, 3), (128, 256, 5)])
def test_content_and_coverage_forms_at_d_not_h_match_jax(D, H, K):
    """B2's plain content form (no location term) and coverage form at D !=
    H against JAX's reference step (its memory repeated per beam) and, at K
    = 1, its Pallas kernel in interpret mode (a location of zeros, as the
    bahdanau step's 0.0)."""
    from doc2tex_tpu.ops import attention_step as jax_b2
    from doc2tex_tpu_torch.ops.attention_step import (content_attention_step,
                                                      coverage_attention_step,
                                                      location_features)

    rng = np.random.default_rng(D + H + K)
    Bs, S, Kl = 2, 37, 8
    f = lambda *s: rng.normal(0, 0.5, s).astype(np.float32)  # noqa: E731
    enc, proj, q, w_score = f(Bs, S, D), f(Bs, S, H), f(Bs * K, H), f(H)
    rep = lambda a: np.repeat(a, K, axis=0)  # noqa: E731
    ctx, alpha = content_attention_step(*map(torch.from_numpy, (enc, proj, q, w_score)),
                                        valid_len=30)
    zeros = np.zeros((Bs * K, S, 4), np.float32)
    jctx, jalpha = jax_b2.attention_step_reference(
        rep(enc), rep(proj), q, zeros, np.zeros((4, H), np.float32),
        np.zeros(H, np.float32), w_score[:, None], valid_len=30)
    np.testing.assert_allclose(ctx.numpy(), np.asarray(jctx), atol=1e-5, rtol=0)
    np.testing.assert_allclose(alpha.numpy(), np.asarray(jalpha), atol=1e-6, rtol=0)
    if K == 1:
        ictx, ialpha = jax_b2.fused_attention_step(
            jnp.asarray(enc), jnp.asarray(proj), jnp.asarray(q), jnp.asarray(zeros),
            jnp.zeros((4, H)), jnp.zeros(H), jnp.asarray(w_score), valid_len=30,
            interpret=True)
        np.testing.assert_allclose(ctx.numpy(), np.asarray(ictx), atol=1e-5, rtol=0)
        np.testing.assert_allclose(alpha.numpy(), np.asarray(ialpha), atol=1e-6, rtol=0)
    mem = np.abs(f(Bs * K, S))
    conv_w, conv_b, w_loc, b_loc = f(5, 1, Kl), f(Kl), f(Kl, H), f(H)
    ctx, alpha = coverage_attention_step(*map(torch.from_numpy, (
        enc, proj, q, mem, conv_w, conv_b, w_loc, b_loc, w_score)))
    loc = location_features(*map(torch.from_numpy, (mem, conv_w, conv_b))).numpy()
    jctx, jalpha = jax_b2.attention_step_reference(rep(enc), rep(proj), q, loc, w_loc, b_loc,
                                                   w_score[:, None])
    np.testing.assert_allclose(ctx.numpy(), np.asarray(jctx), atol=1e-5, rtol=0)
    np.testing.assert_allclose(alpha.numpy(), np.asarray(jalpha), atol=1e-6, rtol=0)


def test_refusals_kept_from_jax():
    """A ViT behind a feature stage, and the MS_TFM head name in the model,
    raise ValueError as in JAX; the converter and the runner take MS_TFM."""
    from doc2tex_tpu_torch.decode.runner import token_ids_for
    from doc2tex_tpu_torch.tokenizer.converters import TFMLabelConverter, create_converter

    bad = vit_config()
    bad["FeatureExtraction"] = {"name": "ResNet", "params": {"output_channel": 64}}
    with pytest.raises(ValueError, match="Feat='None'"):
        build_model(make_config(bad), V)
    ms = cnn_config("ResNet", "None", "MS_TFM")
    with pytest.raises(ValueError, match="unknown Prediction"):
        build_model(make_config(ms), V)
    ms["character"] = list("abc")
    assert isinstance(create_converter(make_config(ms)), TFMLabelConverter)
    assert token_ids_for("MS_TFM") == token_ids_for("TFM")


def test_int8_reaches_the_resnet_stage_only():
    """``quantize: int8`` on a CNN model reaches the ResNet's convolutions
    (the gated ones), never a VGG, GCB, BiLSTM or head layer, as JAX's
    ``maybe_conv_general`` does."""
    cfg = cnn_config("ResNet", "BiLSTM", "Attn", feat_params={"gcb": True, "output_channel": 512},
                     pred_params={"input_size": 64})
    cfg["quantize"] = "int8"
    port = build_model(make_config(cfg), V)
    assert port.int8_layers and all(n.startswith("resnet.") for n in port.int8_layers)
    assert not any("GCB" in n for n in port.int8_layers)
    vgg = cnn_config("VGG", "None", "TFM", feat_params={"output_channel": 512},
                     pred_params={"d_model": 512, "nhead": 8})
    vgg["quantize"] = "int8"
    assert build_model(make_config(vgg), V).int8_layers == []
