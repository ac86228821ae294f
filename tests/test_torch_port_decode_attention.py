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
  what 8 blocks hold; so does the int8 K/V form's plan (bf16 and float32
  q), in whole tiles of its own size and rings of its own depths.
- ``smem_bytes`` is the kernel's ``make_layout``: the source's layout code,
  compiled with the host's C++ compiler, gives the same bytes.
"""

from __future__ import annotations

import os
import re
import subprocess
import sys

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from doc2tex_tpu.ops.decode_attention import _reference as jax_reference
from doc2tex_tpu_torch.ops.decode_attention import (
    HEAD_DIMS, MAX_CLUSTER, SMEM_LIMIT, SOURCE, STAGES, STAGES_INT8, TILE, TILE_INT8,
    decode_attention_reference, launch_plan, packed_int8, smem_bytes, tile_of)
from doc2tex_tpu_torch._build import CSRC

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


def _check_plan(B, K, M, nh, hd, dtype, kv=None):
    plan = launch_plan(B, K, M, nh, hd, dtype, kv)
    kelem = None if kv is None else kv.itemsize
    # block r of a cluster owns positions [r * chunk, min(M, (r + 1) * chunk))
    ranges = [(r * plan.chunk, min(M, (r + 1) * plan.chunk)) for r in range(plan.cluster)]
    depths = STAGES_INT8 if packed_int8(dtype.itemsize, kelem or dtype.itemsize) else STAGES
    assert 1 <= plan.cluster <= MAX_CLUSTER and plan.chunk % TILE == 0
    assert plan.stages in depths and set(STAGES) == {2, 3} and set(STAGES_INT8) <= set(range(2, 9))
    assert ranges[0][0] == 0 and ranges[-1][1] == M
    assert all(a < b for a, b in ranges) and all(b == c for (_, b), (c, _) in zip(ranges, ranges[1:]))
    assert all(b - a <= plan.chunk for a, b in ranges)
    assert plan.smem_bytes == smem_bytes(K, plan.chunk, plan.stages, hd, dtype.itemsize, kelem)
    assert plan.smem_bytes <= SMEM_LIMIT < 227 * 1024 + 1
    return plan


def _dtypes(dtype):
    """(q's type, K/V's: None for q's, or torch.int8) of a parameter."""
    return dtype if isinstance(dtype, tuple) else (dtype, None)


# the int8 K/V form's q types, as parameters after the float forms' (their
# ids unchanged)
INT8_CASES = [pytest.param((torch.bfloat16, torch.int8), id="bf16-int8"),
              pytest.param((torch.float32, torch.int8), id="f32-int8")]


# M at every decode step length the shipped TFM configs reach (self: up to
# 501 steps x beam 10; cross: the patch grids), the chunk edges among them
MS = sorted(set(range(1, 5011, 149)) | {310, 620, 623, 624, 930, 1240, 1510, 5010}
            | {t * i + d for t in (TILE, TILE_INT8) for i in range(1, 5) for d in (-1, 0, 1)})


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float16, torch.float32] + INT8_CASES)
@pytest.mark.parametrize("nh", [4, 8])
def test_launch_plan_covers_m_once_within_shared_memory(nh, dtype):
    dtype, kv = _dtypes(dtype)
    for B in (1, 2, 8, 16, 64):
        for K in (1, 5, 10, 16):
            for M in MS:
                _check_plan(B, K, M, nh, 32, dtype, kv)


def test_launch_plan_other_head_dims_and_the_release_shapes():
    for hd in HEAD_DIMS:
        for dtype in (torch.bfloat16, torch.float32):
            for kv in (None, torch.int8):
                for B, K, M in ((1, 1, 3), (4, 3, 70), (8, 16, 1000), (64, 10, 1510)):
                    _check_plan(B, K, M, 8, hd, dtype, kv)
    # the synthetic_tfm_big main path: one block per (sample, head) at batch 64,
    # M split over a cluster at batch 1
    assert launch_plan(64, 10, 623, 8, 32, torch.bfloat16).cluster == 1
    assert launch_plan(1, 10, 1510, 8, 32, torch.bfloat16).cluster > 1
    assert launch_plan(1, 10, 1510, 8, 32, torch.bfloat16, torch.int8).cluster > 1
    # the int8 form with bf16 q: 256-position tiles, deeper rings than 3 where
    # they fit (its share of the card's bytes in flight)
    int8 = launch_plan(64, 10, 1510, 8, 32, torch.bfloat16, torch.int8)
    assert int8.chunk >= 1510 and tile_of(2, 1) == 2 * TILE


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32] + INT8_CASES)
def test_launch_plan_raises_past_what_eight_blocks_hold(dtype):
    dtype, kv = _dtypes(dtype)
    kelem = None if kv is None else kv.itemsize
    lo, hi = 1, 1 << 20  # lo plans, hi does not
    with pytest.raises(ValueError, match="does not fit"):
        launch_plan(1, 16, hi, 8, 32, dtype, kv)
    while hi - lo > 1:
        mid = (lo + hi) // 2
        try:
            launch_plan(1, 16, mid, 8, 32, dtype, kv)
            lo = mid
        except ValueError:
            hi = mid
    assert _check_plan(1, 16, lo, 8, 32, dtype, kv).cluster == MAX_CLUSTER
    chunk = -(-(-(-hi // MAX_CLUSTER)) // TILE) * TILE  # 8 blocks' share of hi, in tiles
    assert smem_bytes(16, chunk, 2, 32, dtype.itemsize, kelem) > SMEM_LIMIT


def test_smem_bytes_is_the_kernels_make_layout(tmp_path):
    """The layout code of the kernel's source (its constants, ``Layout``
    and ``make_layout``), compiled for the host, against ``smem_bytes`` for
    every form (q float32, float16, bfloat16; K/V of q's type or int8 with
    float32 or bf16 q) over chunks, rings, head dims and beams."""
    with open(os.path.join(CSRC, SOURCE)) as f:
        src = f.read()
    start = src.index("constexpr int kWarps")
    end = src.index("template <typename T> __device__ __forceinline__ T from_f32")
    forms = [(4, 4), (2, 2), (4, 1), (2, 1)]
    grid = [(K, chunk, stages, hd, elem, kelem) for K in (1, 10, 16)
            for chunk in (256, 768, 1536, 2048) for stages in (2, 3, 5, 8) for hd in HEAD_DIMS
            for elem, kelem in forms]
    calls = "\n".join(f"  std::printf(\"%d\\n\", make_layout({', '.join(map(str, g))}).total);"
                      for g in grid)
    code = ("#include <cstdio>\n#include <cstdint>\n#define __host__\n#define __device__\n"
            "namespace {\n" + src[start:end] + "}\nint main() {\n" + calls + "\n}\n")
    cpp = tmp_path / "layout.cpp"
    cpp.write_text(code)
    exe = tmp_path / "layout"
    subprocess.run(["g++", "-std=c++17", "-o", str(exe), str(cpp)], check=True,
                   capture_output=True, timeout=120)
    got = [int(x) for x in subprocess.run([str(exe)], check=True, capture_output=True,
                                          text=True).stdout.split()]
    want = [smem_bytes(*g) for g in grid]
    assert got == want
    assert re.search(r"kTile8 = 256;", src) and tile_of(2, 1) == 256
