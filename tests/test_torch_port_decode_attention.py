"""Beam decode attention (B1): where the probabilities are rounded, and the
kernel's launch plan, checked on the CPU.

- The reference rounds the normalised softmax probabilities to v's type
  before P.V.  On inputs where that and keeping them in float32 give
  different results, the port's plain version equals the JAX package's
  ``_reference`` bit for bit, and the float32-probability order does not.
  (The kernel is held to the plain version on the same inputs on the card:
  ``test_torch_port_cuda.py``.)
- ``launch_plan`` splits M over a cluster of at most 8 blocks whose ranges
  cover M once, within 227 KB of shared memory a block, for every shape the
  shipped TFM configs launch (batch 1 to 64, M up to 5010), and raises past
  what 8 blocks hold.
"""

from __future__ import annotations

import os
import sys

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from doc2tex_tpu.ops.decode_attention import _reference as jax_reference
from doc2tex_tpu_torch.ops.decode_attention import (
    HEAD_DIMS, MAX_CLUSTER, SMEM_LIMIT, TILE, decode_attention_reference, launch_plan, smem_bytes)

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
import chip_smoke  # noqa: E402  (the repository root: the shared input makers)
from torch_port_threads import one_torch_thread  # noqa: E402,F401

JNP = {torch.bfloat16: jnp.bfloat16, torch.float16: jnp.float16}


def _f32_probabilities(q, k, v, mask):
    """The order the reference does not take: P.V on float32 probabilities."""
    sc = torch.einsum("bkhd,bmhd->bkhm", q.float(), k.float())
    if mask is not None:
        sc = sc.masked_fill(~mask[:, :, None, :], float("-inf"))
    return torch.einsum("bkhm,bmhd->bkhd", torch.softmax(sc, dim=-1), v.float()).to(v.dtype)


@pytest.mark.parametrize("n,v0", chip_smoke.ROUNDING_POINT_CASES)
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float16])
def test_plain_version_rounds_probabilities_where_the_reference_does(dtype, n, v0):
    for spread in (1, 500):
        q, k, v, mask = chip_smoke.rounding_point_inputs(n, v0, dtype, "cpu", spread=spread)
        got = decode_attention_reference(q, k, v, mask)
        ref = jax_reference(*(jnp.asarray(t.float().numpy(), dtype=JNP[dtype]) for t in (q, k, v)),
                            None if mask is None else jnp.asarray(mask.numpy()))
        ref = np.asarray(ref.astype(jnp.float32))
        np.testing.assert_array_equal(got.float().numpy(), ref)
        assert not np.array_equal(_f32_probabilities(q, k, v, mask).float().numpy(), ref)


def _check_plan(B, K, M, nh, hd, dtype):
    plan = launch_plan(B, K, M, nh, hd, dtype)
    # block r of a cluster owns positions [r * chunk, min(M, (r + 1) * chunk))
    ranges = [(r * plan.chunk, min(M, (r + 1) * plan.chunk)) for r in range(plan.cluster)]
    assert 1 <= plan.cluster <= MAX_CLUSTER and plan.chunk % TILE == 0 and plan.stages in (2, 3)
    assert ranges[0][0] == 0 and ranges[-1][1] == M
    assert all(a < b for a, b in ranges) and all(b == c for (_, b), (c, _) in zip(ranges, ranges[1:]))
    assert all(b - a <= plan.chunk for a, b in ranges)
    assert plan.smem_bytes == smem_bytes(K, plan.chunk, plan.stages, hd, dtype.itemsize)
    assert plan.smem_bytes <= SMEM_LIMIT < 227 * 1024 + 1
    return plan


# M at every decode step length the shipped TFM configs reach (self: up to
# 501 steps x beam 10; cross: the patch grids), the chunk edges among them
MS = sorted(set(range(1, 5011, 149)) | {310, 620, 623, 624, 930, 1240, 1510, 5010}
            | {TILE * i + d for i in range(1, 5) for d in (-1, 0, 1)})


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float16, torch.float32])
@pytest.mark.parametrize("nh", [4, 8])
def test_launch_plan_covers_m_once_within_shared_memory(nh, dtype):
    for B in (1, 2, 8, 16, 64):
        for K in (1, 5, 10, 16):
            for M in MS:
                _check_plan(B, K, M, nh, 32, dtype)


def test_launch_plan_other_head_dims_and_the_release_shapes():
    for hd in HEAD_DIMS:
        for dtype in (torch.bfloat16, torch.float32):
            for B, K, M in ((1, 1, 3), (4, 3, 70), (8, 16, 1000), (64, 10, 1510)):
                _check_plan(B, K, M, 8, hd, dtype)
    # the synthetic_tfm_big main path: one block per (sample, head) at batch 64,
    # M split over a cluster at batch 1
    assert launch_plan(64, 10, 623, 8, 32, torch.bfloat16).cluster == 1
    assert launch_plan(1, 10, 1510, 8, 32, torch.bfloat16).cluster > 1


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
def test_launch_plan_raises_past_what_eight_blocks_hold(dtype):
    lo, hi = 1, 1 << 20  # lo plans, hi does not
    with pytest.raises(ValueError, match="does not fit"):
        launch_plan(1, 16, hi, 8, 32, dtype)
    while hi - lo > 1:
        mid = (lo + hi) // 2
        try:
            launch_plan(1, 16, mid, 8, 32, dtype)
            lo = mid
        except ValueError:
            hi = mid
    assert _check_plan(1, 16, lo, 8, 32, dtype).cluster == MAX_CLUSTER
    chunk = -(-(-(-hi // MAX_CLUSTER)) // TILE) * TILE  # 8 blocks' share of hi, in tiles
    assert smem_bytes(16, chunk, 2, 32, dtype.itemsize) > SMEM_LIMIT
