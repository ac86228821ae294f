"""The ViT's learned position tables against the JAX package
(``torch_port_zoo_cases.check_case_matches_jax``): truncated and
interpolated (with the luong concat head) at a grid smaller than the max
grid (the 32x64 bucket of a 64x128 max), and the table's bicubic resize
against ``jax.image.resize`` within 1e-6.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from torch_port_threads import one_torch_thread  # noqa: F401
from torch_port_zoo_cases import VIT, VIT_TABLES, check_case_matches_jax


@pytest.mark.parametrize("case", VIT_TABLES)
def test_zoo_case_matches_jax(case):
    check_case_matches_jax(VIT[case])


@pytest.mark.parametrize("grid,out", [((7, 33), (3, 17)), ((4, 9), (4, 5)), ((5, 6), (2, 6)),
                                      ((6, 4), (6, 8))])
def test_bicubic_resize_matches_jax_image_resize(grid, out):
    from doc2tex_tpu_torch.models.vit import bicubic_resize

    table = np.random.default_rng(0).normal(size=(*grid, 8)).astype(np.float32)
    want = np.asarray(jax.image.resize(jnp.asarray(table), (*out, 8), "bicubic"))
    got = bicubic_resize(torch.from_numpy(table), out).numpy()
    np.testing.assert_allclose(got, want, atol=1e-6, rtol=0)


