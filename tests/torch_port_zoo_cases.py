"""The zoo's tiny configurations and the parity check the three
``test_torch_port_zoo*.py`` files share (imported, not collected).

Every leaf of the JAX model's variables is drawn with numpy (the BatchNorm
statistics included; ``weights.random_variables``, the drawer of
``chip_smoke.zoo_variables``) and carried into the port by ``weights.py``; the same
numpy images go through both.  float32 on the CPU: encoder memory within
1e-5, teacher-forced logits within 1e-4, greedy and beam-5 tokens equal
over the decode's 9 steps.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np
import torch

from doc2tex_tpu.config import make_config as jax_make_config
from doc2tex_tpu.decode.runner import make_decode_fn as jax_make_decode_fn
from doc2tex_tpu.models import build_model as jax_build_model
from doc2tex_tpu_torch.config import make_config
from doc2tex_tpu_torch.decode.runner import make_decode_fn
from doc2tex_tpu_torch.models import build_model
from doc2tex_tpu_torch.weights import load_variables, random_variables

V = 20
BUCKET = (32, 64)


def cnn_config(feat="ResNet", seq="None", pred="TFM", attn_type="coverage", method="dot",
               seq_params=None, pred_params=None, feat_params=None):
    """``tests/test_model_variants.py::cnn_config`` with overrides."""
    pp = ({"d_model": 64, "nhead": 4, "num_decoder_layers": 2, "dim_feedforward": 128,
           "dropout": 0.0} if pred == "TFM" else
          {"seqmodel": "BiLSTM" if seq == "BiLSTM" else "None", "input_size": 64,
           "hidden_size": 64, "kernel_size": 2, "kernel_dim": 32, "embed_target": True,
           "enc_init": False, "attn_type": attn_type, "method": method, "droprate": 0.0})
    return dict(
        max_dimension=[64, 128], min_dimension=[32, 32], batch_max_length=8,
        FeatureExtraction={"name": feat, "params": {"input_channel": 1, "output_channel": 64,
                                                    **(feat_params or {})}},
        SequenceModeling={"name": seq, "params": {"hidden_size": 64, "output_size": 64,
                                                  "num_layers": 2, **(seq_params or {})}},
        Prediction={"name": pred, "params": {**pp, **(pred_params or {})}},
        dtype="float32",
    )


def vit_config(pred="TFM", backbone="resnet", gcb=False, patching="2d", patch=(2, 2),
               fix_embed=True, interpolate_embed=True, pred_params=None):
    """A ViT (depth 2, width 64) over ``backbone`` with the head ``pred``."""
    cfg = cnn_config("None", "ViT", pred, pred_params=pred_params)
    bb = {"name": backbone, "input_channel": 1, "output_channel": 64, "gcb": gcb}
    cfg["FeatureExtraction"] = {"name": "None"}
    cfg["SequenceModeling"] = {"name": "ViT", "params": {
        "backbone": bb, "fix_embed": fix_embed, "interpolate_embed": interpolate_embed,
        "input_channel": 1, "patching_style": patching, "patch_size": list(patch),
        "depth": 2, "num_heads": 4, "hidden_size": 64}}
    if pred != "TFM":
        cfg["Prediction"]["params"]["seqmodel"] = "TFM"
    return cfg


# tests/test_model_variants.py::TestStageMatrix
STAGE_MATRIX = {
    "resnet_none_tfm": cnn_config("ResNet", "None", "TFM"),
    "vgg_bilstm_attn_coverage": cnn_config("VGG", "BiLSTM", "Attn"),
    "resnet_bilstm_attn_bahdanau": cnn_config("ResNet", "BiLSTM", "Attn", "bahdanau"),
    "bilstm_pos_enc_gatedsum": cnn_config("ResNet", "BiLSTM", "Attn",
                                          seq_params={"pos_enc": True}),
    "luong_dot": cnn_config("ResNet", "BiLSTM", "Attn", "luong", "dot"),
    "luong_general": cnn_config("ResNet", "BiLSTM", "Attn", "luong", "general"),
    "luong_concat": cnn_config("ResNet", "BiLSTM", "Attn", "luong", "concat"),
}
# the head's and the feature stage's other options
HEADS = {
    # the GatedSum's projection (stage input 64 wide, output 48) and the
    # coverage head at D 48 != H 64
    "bilstm_pos_enc_projected": cnn_config(
        "ResNet", "BiLSTM", "Attn", seq_params={"pos_enc": True, "hidden_size": 32,
                                                "output_size": 48},
        pred_params={"input_size": 48, "enc_init": True}),
    # bahdanau at D 64 != H 32 on a VGG map, the one-hot input
    "vgg_none_bahdanau_onehot": cnn_config(
        "VGG", "None", "Attn", "bahdanau",
        pred_params={"hidden_size": 32, "embed_target": False}),
    "coverage_onehot": cnn_config("ResNet", "BiLSTM", "Attnv2",
                                  pred_params={"embed_target": False, "enc_init": True}),
    "luong_onehot": cnn_config("VGG", "BiLSTM", "Attn", "luong", "general",
                               pred_params={"embed_target": False}),
    "gcb_resnet_none_tfm": cnn_config("ResNet", "None", "TFM", feat_params={"gcb": True}),
    "vgg_none_tfm": cnn_config("VGG", "None", "TFM"),
}
# the ViT options
VIT = {
    "vit_gcb_sincos_tfm": vit_config(gcb=True),
    "vit_1d_tfm": vit_config(patching="1d", patch=(1, 2), fix_embed=False),
    "vit_patch_embed_tfm": vit_config(backbone="cnn", patch=(8, 8)),
    "vit_truncate_attnv2": vit_config("Attnv2", fix_embed=False, interpolate_embed=False,
                                      pred_params={"enc_init": True}),
    "vit_interpolate_luong_concat": vit_config(
        "Attnv2", gcb=True, fix_embed=False,
        pred_params={"attn_type": "luong", "method": "concat", "enc_init": True}),
}


def _images(n, seed):
    rng = np.random.default_rng(seed)
    img = rng.integers(0, 256, (n, *BUCKET, 1)).astype(np.uint8)
    img[:, :, : BUCKET[1] // 3] = 255
    return img


def _normalized(img):
    return (img.astype(np.float32) / 255.0 - 0.5) / 0.5


def _pair(cfg):
    jmodel = jax_build_model(jax_make_config(cfg), V)
    shapes = jax.eval_shape(lambda: jmodel.init(
        jax.random.PRNGKey(0), jnp.zeros((1, *BUCKET, 1)), jnp.zeros((1, 9), jnp.int32),
        train=False))
    variables = random_variables(shapes, np.random.default_rng(0))
    port = build_model(make_config(cfg), V).eval()
    assert load_variables(port, variables) == len(jax.tree_util.tree_leaves(variables))
    return jmodel, jax.tree_util.tree_map(jnp.asarray, variables), port


CASES = {**STAGE_MATRIX, **HEADS, **VIT}
# the cases a file of their own takes (each file stays near a minute)
LUONG = ("luong_concat", "luong_dot", "luong_general")
VIT_TABLES = ("vit_interpolate_luong_concat", "vit_truncate_attnv2")


def check_case_matches_jax(cfg):
    """Encoder memory, teacher-forced logits, greedy and beam-5 tokens."""
    jmodel, variables, port = _pair(cfg)
    img = _images(2, seed=1)
    x = _normalized(img)
    jenc = np.asarray(jax.jit(lambda v, x: jmodel.apply(v, x, method="encode"))(
        variables, jnp.asarray(x)))
    text = np.random.default_rng(2).integers(1, V, (2, 9)).astype(np.int32)
    jlogits = np.asarray(jax.jit(lambda v, x, t: jmodel.apply(v, x, t, False))(
        variables, jnp.asarray(x), jnp.asarray(text)))
    with torch.no_grad():
        penc = port.encode(torch.from_numpy(x)).numpy()
        plogits = port(torch.from_numpy(x), torch.from_numpy(text).long()).numpy()
    assert penc.shape == jenc.shape
    np.testing.assert_allclose(penc, jenc, atol=1e-5, rtol=0)
    np.testing.assert_allclose(plogits, jlogits, atol=1e-4, rtol=0)
    for beam in (1, 5):
        jtok, _ = jax_make_decode_fn(jmodel, jax_make_config(cfg), beam_size=beam)(
            variables, jnp.asarray(img))
        ptok, _ = make_decode_fn(port, make_config(cfg), beam_size=beam, device="cpu")(img)
        np.testing.assert_array_equal(ptok.numpy(), np.asarray(jtok))


