"""The port's beam decode attention against the JAX package.

On the CPU the wrapper runs the plain PyTorch version; it is held to the
JAX reference (``force_reference=True``) within 1e-5 in float32.  The CUDA
kernel itself runs only on a card: its tests are in
``test_torch_port_cuda.py``.
"""

from __future__ import annotations

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from doc2tex_tpu.ops.decode_attention import decode_attention as jax_decode_attention
from doc2tex_tpu_torch.ops.decode_attention import decode_attention

NH, HD = 4, 32


def _inputs(B, K, M, masked, seed):
    rng = np.random.default_rng(seed)
    q = (rng.normal(size=(B, K, NH, HD)) / np.sqrt(HD)).astype(np.float32)
    k = rng.normal(size=(B, M, NH, HD)).astype(np.float32)
    v = rng.normal(size=(B, M, NH, HD)).astype(np.float32)
    mask = None
    if masked:
        mask = rng.random((B, K, M)) < 0.4
        mask[:, :, 0] = True  # every row attends somewhere
    return q, k, v, mask


@pytest.mark.parametrize("masked", [False, True])
@pytest.mark.parametrize("K", [1, 5])
def test_plain_version_matches_jax_reference(K, masked):
    q, k, v, mask = _inputs(3, K, 7 * K + 3, masked, seed=K + 10 * masked)
    ref = jax_decode_attention(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                               None if mask is None else jnp.asarray(mask),
                               force_reference=True)
    before = decode_attention.launches
    got = decode_attention(torch.from_numpy(q), torch.from_numpy(k), torch.from_numpy(v),
                           None if mask is None else torch.from_numpy(mask))
    assert decode_attention.launches == before  # the CPU path launches no kernel
    assert got.shape == (3, K, NH, HD) and got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), atol=1e-5, rtol=0)


def test_wrapper_rejects_what_the_kernel_does_not_take():
    q, k, v, mask = (torch.from_numpy(x) for x in _inputs(2, 3, 9, True, seed=0))
    with pytest.raises(NotImplementedError, match="int8"):
        decode_attention(q, k, v, mask, k_scale=torch.ones(2, 9, NH))
    with pytest.raises(ValueError, match="shape"):
        decode_attention(q, k[:, :, :2], v, mask)
    with pytest.raises(ValueError, match="mask"):
        decode_attention(q, k, v, mask.float())
    with pytest.raises(ValueError, match="mask"):
        decode_attention(q, k, v, mask[:, :, :-1])
