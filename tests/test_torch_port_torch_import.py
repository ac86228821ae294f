"""``doc2tex_tpu_torch.tools.torch_import`` against the JAX package's
importer (``doc2tex_tpu/tools/torch_import.py``).

One random state_dict under the reference's key names (the port's
``reference_state_dict`` spells them out, as
``doc2tex_tpu/tools/torch_import.py:43-202`` reads them; a name it got
wrong would fail JAX's importer) goes to JAX's ``import_torch_state_dict``, whose trees reach a port
model through ``weights.py``, and to the port's importer: the two models'
states are equal bit for bit, and so are the ``missing`` lists.  Cases: a
fixed and a learned position table, an Attnv2 head (coverage, with the
GCB backbone) and a TFM head, a ``module.`` prefixed state_dict and a
``.pth`` file.  The last case is ``synthetic_tfm_big``'s architecture at
full width.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from doc2tex_tpu.config import make_config as jax_make_config
from doc2tex_tpu.models import build_model as jax_build_model
from doc2tex_tpu.tools.torch_import import import_torch_state_dict as jax_import
from doc2tex_tpu_torch.config import make_config
from doc2tex_tpu_torch.models import build_model
from doc2tex_tpu_torch.recognition import load_recog_config
from doc2tex_tpu_torch.tools.torch_import import (import_torch_state_dict,
                                                  load_torch_checkpoint, reference_state_dict)
from doc2tex_tpu_torch.weights import load_variables
from torch_port_threads import one_torch_thread  # noqa: F401

V = 24
def vit_config(pred="TFM", fix_embed=True, gcb=False, width=32):
    head = ({"d_model": width, "nhead": 2, "num_decoder_layers": 2,
             "dim_feedforward": 2 * width, "dropout": 0.0} if pred == "TFM" else
            {"seqmodel": "TFM", "input_size": width, "hidden_size": width, "kernel_size": 2,
             "kernel_dim": 16, "embed_target": True, "enc_init": True,
             "attn_type": "coverage", "droprate": 0.0})
    return dict(
        max_dimension=[64, 128], min_dimension=[32, 32], batch_max_length=10,
        dtype="float32", FeatureExtraction={"name": "None"},
        SequenceModeling={"name": "ViT", "params": {
            "backbone": {"name": "resnet", "input_channel": 1, "output_channel": 32,
                         "gcb": gcb},
            "fix_embed": fix_embed, "input_channel": 1, "patching_style": "2d",
            "patch_size": [2, 2], "depth": 2, "num_heads": 2, "hidden_size": width}},
        Prediction={"name": pred, "params": head})


_JAX_VARIABLES = {}   # repr(cfg) -> the JAX model's initial variables (one init a config)


def _jax_variables(cfg):
    """The JAX model's initial variables of ``cfg``, initialised once per
    config (JAX compiles the init) and handed out in fresh containers."""
    key = repr(cfg)
    if key not in _JAX_VARIABLES:
        jmodel = jax_build_model(jax_make_config(cfg), V)
        bucket = tuple(cfg["min_dimension"])
        _JAX_VARIABLES[key] = jax.jit(lambda: jmodel.init(
            jax.random.PRNGKey(0), jnp.zeros((1, *bucket, 1)), jnp.zeros((1, 3), jnp.int32),
            train=False))()
    return jax.tree_util.tree_map(lambda x: x, _JAX_VARIABLES[key])


def _both(cfg, sd):
    """(JAX's import carried into a port model, the port's import, both
    missing lists)."""
    variables = _jax_variables(cfg)
    params, stats, jmissing = jax_import(sd, cfg, variables["params"],
                                         variables["batch_stats"])
    via_jax = build_model(make_config(cfg), V)
    load_variables(via_jax, jax.tree_util.tree_map(
        np.asarray, {"params": params, "batch_stats": stats}))
    torch.manual_seed(1)
    port = build_model(make_config(cfg), V)
    return via_jax, port, jmissing


@pytest.mark.parametrize("pred,fix_embed,gcb", [("TFM", True, False), ("Attnv2", False, True),
                                                ("TFM", False, False)])
def test_import_matches_jax_bit_for_bit(pred, fix_embed, gcb):
    cfg = vit_config(pred, fix_embed, gcb)
    template = build_model(make_config(cfg), V)
    sd = reference_state_dict(template, cfg, np.random.default_rng(0))
    via_jax, port, jmissing = _both(cfg, sd)
    missing = import_torch_state_dict({f"module.{k}": v for k, v in sd.items()}, cfg, port)
    assert sorted(missing) == sorted(jmissing)
    want = via_jax.state_dict()
    for key, value in port.state_dict().items():
        assert torch.equal(value, want[key]), key
    # the parameters a state_dict leaves out are reported, as JAX reports them
    del sd["predicter.Prediction.proj.weight" if pred == "TFM" else
           "predicter.Prediction.proj_init_h.weight"]
    if pred == "TFM":
        with pytest.raises(KeyError):
            import_torch_state_dict(sd, cfg, port)
    else:
        missing = import_torch_state_dict(sd, cfg, port)
        assert sorted(missing) == sorted(_both(cfg, sd)[2])
        assert "predicter/w_init_h" in missing


def test_release_architecture_from_a_pth_file(tmp_path):
    """``synthetic_tfm_big``'s architecture at full width (ViT 256x6, TFM
    head 6 layers): a .pth of a random reference state_dict loads through
    ``load_torch_checkpoint`` to the state JAX's importer gives."""
    cfg, _ = load_recog_config(version="synthetic_tfm_big")
    cfg["dtype"] = "float32"
    cfg["min_dimension"] = [32, 32]
    V_big = V
    template = build_model(make_config(cfg), V_big)
    sd = reference_state_dict(template, cfg, np.random.default_rng(1))
    path = tmp_path / "ref.pth"
    torch.save({"model": sd}, path)
    via_jax, port, jmissing = _both(cfg, {k: v.numpy() for k, v in sd.items()})
    assert load_torch_checkpoint(str(path), cfg, port) == [] == jmissing
    want = via_jax.state_dict()
    for key, value in port.state_dict().items():
        assert torch.equal(value, want[key]), key
