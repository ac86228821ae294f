"""The zoo's other head and feature-stage options against the JAX package
(``torch_port_zoo_cases.check_case_matches_jax``): the one-hot head input,
the GatedSum's projection with a coverage head at D != H, bahdanau at D !=
H on a VGG map, the GCB ResNet and the VGG map under the TFM head; and
``to_variables`` of every new module back to the same state bit for bit.
"""

from __future__ import annotations

import pytest
import torch

from doc2tex_tpu_torch.config import make_config
from doc2tex_tpu_torch.models import build_model
from doc2tex_tpu_torch.weights import load_variables, to_variables
from torch_port_threads import one_torch_thread  # noqa: F401
from torch_port_zoo_cases import CASES, HEADS, V, check_case_matches_jax


@pytest.mark.parametrize("case", sorted(HEADS))
def test_zoo_case_matches_jax(case):
    check_case_matches_jax(HEADS[case])


def test_variables_round_trip_bit_for_bit():
    """``to_variables`` of every new module's leaves loads back equal."""
    for case in ("vgg_bilstm_attn_coverage", "bilstm_pos_enc_projected",
                 "vit_interpolate_luong_concat", "luong_concat", "vit_1d_tfm",
                 "vit_patch_embed_tfm", "vgg_none_bahdanau_onehot"):
        
        port = build_model(make_config(CASES[case]), V)
        before = {k: v.clone() for k, v in port.state_dict().items()}
        again = build_model(make_config(CASES[case]), V)
        load_variables(again, to_variables(port))
        for key, value in again.state_dict().items():
            assert torch.equal(value, before[key]), (case, key)


