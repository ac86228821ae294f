"""Beam decode attention (self- and cross-) for the TFM head.

Per layer and decode step, K beam queries of a sample attend over an
(M, nh, hd) key/value buffer: the fixed-slot self-attention cache (M =
Tmax*K, masked by the beam ancestry) or the beam-shared encoder memory
(M = S, no mask).  Semantics, in the order of rounding of the JAX package's
``doc2tex_tpu.ops.decode_attention._reference``:

    scores[b,k,h,m] = sum_d q[b,k,h,d] * k[b,m,h,d]     (f32; q pre-scaled)
    scores = where(mask[b,k,m], scores, -inf)
    p = softmax_m(scores)                                (f32, over all M)
    ctx[b,k,h,d] = sum_m round_to(v.dtype, p)[b,k,h,m] * v[b,m,h,d]

With int8 K/V (``k_scale``/``v_scale`` (B, M, nh) float32, the
``decoder_mem`` and ``decoder_kv`` quantized parts), the order of the
reference's int8 branch, the scales folded around the reduces and the
output in q's type:

    scores = (sum_d q * k_int8) * k_scale                (f32)
    p = round_to(q.dtype, softmax_m(masked scores))
    ctx = sum_m round_to(q.dtype, p * round_to(q.dtype, v_scale)) * v_int8

``decode_attention`` runs the hand-written CUDA kernel
(``csrc/decode_attention.cu``; its int8 K/V form for int8 K/V) on CUDA
tensors, with the grid that ``launch_plan`` chooses, and the plain PyTorch
versions, ``decode_attention_reference`` and
``decode_attention_int8_reference``, on CPU tensors.  It never falls back
from one to the other: on a CUDA tensor it launches the kernel or raises.
Each form counts its launches: ``decode_attention.launches`` and
``decode_attention.int8_launches``.
"""

from __future__ import annotations

import ctypes
import functools
from typing import NamedTuple

import torch

from .._build import load_library

SOURCE = "decode_attention.cu"
MAX_BEAM = 16            # queries per sample the kernel holds on chip
HEAD_DIMS = (32, 64, 128)
_DTYPE_CODE = {torch.float32: 0, torch.float16: 1, torch.bfloat16: 2}
INT8_Q_DTYPES = (torch.float32, torch.bfloat16)   # q's types of the int8 K/V form

# The kernel's grid (csrc/decode_attention.cu): one cluster of up to
# MAX_CLUSTER blocks per (sample, head), each block owning `chunk` positions
# and keeping their f32 scores in shared memory.
TILE = 128                # positions per ring buffer
WARPS = 8
MAX_CLUSTER = 8           # portable cluster size
SMEM_LIMIT = 232_448      # dynamic shared memory a block may use on sm_90 (227 KB)
SMEM_PER_SM = 233_472     # an SM's shared memory; each block also takes 1 KB
SMS = 132                 # H100 SXM
# blocks of 256 threads an SM holds by registers, by (element bytes, hd):
# 64 registers a thread below float32 at hd <= 64, 127 at hd 128; float32
# 126-128, and 183 at hd 128 (nvcc -Xptxas -v, PR 6)
BLOCKS_PER_SM = {(2, 32): 4, (2, 64): 4, (2, 128): 2, (4, 32): 2, (4, 64): 2, (4, 128): 1}
# the int8 K/V form, by q's element bytes and hd: 48 registers at bf16 hd 32,
# 64 at hd 64, 118 at hd 128; float32 125, 128 and 167 (nvcc -Xptxas -v)
BLOCKS_PER_SM_INT8 = {(2, 32): 5, (2, 64): 4, (2, 128): 2, (4, 32): 2, (4, 64): 2,
                      (4, 128): 1}
# launch_plan: one block per (sample, head) when that makes at least
# ONE_BLOCK_MIN blocks and fits; else the plan of least modelled time,
# waves of blocks x (FIXED_US + CLUSTER_US if split + US_PER_POSITION x
# chunk).  Fitted to B1's bf16 device times over every plan on an H100
# (tools/bench_decode_attention.py --sweep; PERF.md, PR 6).
ONE_BLOCK_MIN = 2 * SMS
FIXED_US, CLUSTER_US, US_PER_POSITION = 15.0, 5.0, 0.01


class LaunchPlan(NamedTuple):
    """The kernel's grid: block r of a (sample, head)'s cluster owns
    positions [r * chunk, min(M, (r + 1) * chunk))."""

    cluster: int     # blocks per (sample, head)
    chunk: int       # positions per block, a multiple of TILE
    stages: int      # ring buffers of TILE K or V rows
    smem_bytes: int  # dynamic shared memory per block


def _up16(x: int) -> int:
    return (x + 15) // 16 * 16


def smem_bytes(K: int, chunk: int, stages: int, hd: int, elem: int, kelem: int | None = None
               ) -> int:
    """Dynamic shared memory of one block: ``make_layout`` of the kernel.
    ``elem``: bytes of q's type; ``kelem``: of K/V's (1 for int8 K/V, whose
    form adds the positions' scales)."""
    kelem = elem if kelem is None else kelem
    rs = hd * elem + 16  # a padded Q row
    rsk = hd * kelem + 16  # a padded K/V row of the ring
    q8 = 2 * _up16(chunk * 4) if kelem != elem else 0
    return (_up16(max(stages * TILE * rsk, WARPS * MAX_BEAM * hd * 4))  # ring / partial outputs
            + _up16(MAX_BEAM * rs)                                   # queries
            + _up16(MAX_BEAM * hd * 4)                               # the block's output
            + _up16((WARPS + 4) * MAX_BEAM * 4)                      # row max and sum
            + _up16(MAX_BEAM * WARPS * 4)                            # sums per row and warp
            + _up16(chunk // TILE * 4)                               # tile flags
            + _up16(chunk * 2)                                       # mask bits per position
            + _up16(K * (chunk + 4) * 4)                             # f32 scores
            + q8)                                                    # int8: k and v scales


@functools.lru_cache(maxsize=None)
def launch_plan(B: int, K: int, M: int, nh: int, hd: int, dtype: torch.dtype,
                kv_dtype: torch.dtype | None = None) -> LaunchPlan:
    """The kernel's grid for one call, over cluster sizes 1..MAX_CLUSTER
    and rings of 3 or 2 tiles whose blocks fit shared memory: a cluster of
    one when B*nh >= ONE_BLOCK_MIN and it fits, with the ring that takes
    the fewest waves of blocks; else the plan of least modelled time (see
    FIXED_US).  Ties go to the smaller cluster, then the deeper ring.
    ``kv_dtype`` torch.int8 plans the int8 K/V form (its own blocks per SM;
    the model's times are the bf16 form's).
    Raises where M does not fit MAX_CLUSTER blocks."""
    if dtype not in _DTYPE_CODE:
        raise TypeError(f"kernel takes float32/float16/bfloat16; got {dtype}")
    if kv_dtype not in (None, dtype, torch.int8) or (kv_dtype == torch.int8
                                                      and dtype not in INT8_Q_DTYPES):
        raise TypeError(f"kernel takes K/V of q's type, or int8 with q float32/bfloat16; "
                        f"got q {dtype}, K/V {kv_dtype}")
    if not (0 < K <= MAX_BEAM) or hd not in HEAD_DIMS or M <= 0 or B <= 0 or nh <= 0:
        raise ValueError(f"kernel takes K <= {MAX_BEAM}, hd in {HEAD_DIMS}, M > 0; "
                         f"got K={K}, hd={hd}, M={M}")
    elem = dtype.itemsize
    kelem = elem if kv_dtype is None else kv_dtype.itemsize
    best = None
    for cluster in range(1, MAX_CLUSTER + 1):
        chunk = -(-(-(-M // cluster)) // TILE) * TILE
        if -(-M // chunk) != cluster:
            continue  # the same chunks as a smaller cluster
        for stages in (3, 2):
            smem = smem_bytes(K, chunk, stages, hd, elem, kelem)
            if smem > SMEM_LIMIT:
                continue
            blocks = BLOCKS_PER_SM if kelem == elem else BLOCKS_PER_SM_INT8
            per_sm = min(blocks[elem, hd], SMEM_PER_SM // (smem + 1024))
            waves = -(-B * nh * cluster // (SMS * per_sm))
            if cluster == 1 and B * nh >= ONE_BLOCK_MIN:
                cost = waves
            else:
                cost = waves * (FIXED_US + CLUSTER_US * (cluster > 1) + US_PER_POSITION * chunk)
            key = (cluster > 1 or B * nh < ONE_BLOCK_MIN, cost, cluster, -stages)
            if best is None or key < best[0]:
                best = (key, LaunchPlan(cluster, chunk, stages, smem))
    if best is None:
        raise ValueError(f"M={M} does not fit {MAX_CLUSTER} blocks of {SMEM_LIMIT} bytes "
                         f"(K={K}, hd={hd}, {dtype})")
    return best[1]


def decode_attention_reference(q, k, v, mask=None):
    """Plain PyTorch version: q (B,K,nh,hd), k/v (B,M,nh,hd), mask (B,K,M)
    bool (True = attend) or None -> (B,K,nh,hd) in v.dtype."""
    sc = torch.einsum("bkhd,bmhd->bkhm", q.float(), k.float())
    if mask is not None:
        sc = sc.masked_fill(~mask[:, :, None, :], float("-inf"))
    attn = torch.softmax(sc, dim=-1).to(v.dtype)
    return torch.einsum("bkhm,bmhd->bkhd", attn, v)


def decode_attention_int8_reference(q, k, v, mask, k_scale, v_scale):
    """Plain PyTorch version of the int8 K/V form, step for step the JAX
    package's ``_reference`` int8 branch: q (B,K,nh,hd) float32 or
    bfloat16, k/v (B,M,nh,hd) int8, k_scale/v_scale (B,M,nh) float32, mask
    (B,K,M) bool or None -> (B,K,nh,hd) in q's type."""
    dtype = q.dtype
    sc = torch.einsum("bkhd,bmhd->bkhm", q.float(), k.float())
    sc = sc * k_scale.permute(0, 2, 1)[:, None]
    if mask is not None:
        sc = sc.masked_fill(~mask[:, :, None, :], float("-inf"))
    attn = torch.softmax(sc, dim=-1).to(dtype)
    aw = attn * v_scale.to(dtype).permute(0, 2, 1)[:, None]
    return torch.einsum("bkhm,bmhd->bkhd", aw, v.to(dtype))


def _kernel():
    lib, info = load_library(SOURCE)
    fn = lib.d2t_decode_attention
    fn.restype = ctypes.c_int
    fn.argtypes = [ctypes.c_void_p] * 5 + [ctypes.c_int] * 10 + [ctypes.c_void_p]
    return fn, info


def _int8_kernel():
    lib, _ = load_library(SOURCE)
    fn = lib.d2t_decode_attention_int8
    fn.restype = ctypes.c_int
    fn.argtypes = [ctypes.c_void_p] * 7 + [ctypes.c_int] * 10 + [ctypes.c_void_p]
    return fn


def build() -> dict:
    """Build (if needed) and load the kernel; returns ``load_library``'s info."""
    return _kernel()[1]


def _check(q, k, v, mask, k_scale=None, v_scale=None):
    if q.dim() != 4 or k.dim() != 4 or v.dim() != 4:
        raise ValueError("q, k, v must be 4-D: (B,K,nh,hd), (B,M,nh,hd), (B,M,nh,hd)")
    B, K, nh, hd = q.shape
    if k.shape != v.shape or k.shape[0] != B or k.shape[2:] != (nh, hd):
        raise ValueError(f"shape mismatch: q {tuple(q.shape)}, k {tuple(k.shape)}, v {tuple(v.shape)}")
    if mask is not None:
        if mask.dtype != torch.bool or mask.shape != (B, K, k.shape[1]):
            raise ValueError(f"mask must be bool (B,K,M); got {mask.dtype} {tuple(mask.shape)}")
    quantized = (k_scale, v_scale)
    if any(t is None for t in quantized) != all(t is None for t in quantized):
        raise ValueError("k_scale and v_scale come together (int8 K/V) or not at all")
    if k_scale is not None:
        if k.dtype != torch.int8 or v.dtype != torch.int8 or q.dtype not in INT8_Q_DTYPES:
            raise TypeError(f"with scales K/V must be int8 and q float32/bfloat16; got q "
                            f"{q.dtype}, k {k.dtype}, v {v.dtype}")
        for t in quantized:
            if t.dtype != torch.float32 or t.shape != k.shape[:3]:
                raise ValueError(f"k_scale/v_scale must be float32 (B,M,nh) = "
                                 f"{tuple(k.shape[:3])}; got {t.dtype} {tuple(t.shape)}")
    devices = {t.device for t in (q, k, v) + (() if mask is None else (mask,))
               + (() if k_scale is None else quantized)}
    if len(devices) != 1:
        raise ValueError(f"tensors on different devices: {devices}")


def decode_attention(q, k, v, mask=None, k_scale=None, v_scale=None):
    """Beam decode attention; see the module docstring.  With
    ``k_scale``/``v_scale`` (B, M, nh) float32, k and v are int8 and the
    output is in q's type."""
    _check(q, k, v, mask, k_scale, v_scale)
    q8 = k_scale is not None
    if q.device.type == "cpu":
        if q8:
            return decode_attention_int8_reference(q, k, v, mask, k_scale, v_scale)
        return decode_attention_reference(q, k, v, mask)
    if q.device.type != "cuda":
        raise ValueError(f"unsupported device {q.device}")
    B, K, nh, hd = q.shape
    M = k.shape[1]
    if not q8 and (not (q.dtype == k.dtype == v.dtype) or q.dtype not in _DTYPE_CODE):
        raise TypeError(f"q, k, v must share one of float32/float16/bfloat16; got "
                        f"{q.dtype}, {k.dtype}, {v.dtype}")
    tensors = (q, k, v) + (() if mask is None else (mask,))
    if not all(t.is_contiguous() for t in tensors + ((k_scale, v_scale) if q8 else ())):
        raise ValueError("q, k, v, mask and the scales must be contiguous")
    if any(t.data_ptr() % 16 for t in tensors):
        raise ValueError("q, k, v and mask must be 16-byte aligned")
    plan = launch_plan(B, K, M, nh, hd, q.dtype, k.dtype if q8 else None)
    return launch(q, k, v, mask, plan, scales=(k_scale, v_scale) if q8 else None)


def launch(q, k, v, mask, plan: LaunchPlan, kernel=None, scales=None):
    """Launch the kernel (or ``kernel``, a library of the same C
    signature) with ``plan`` on checked CUDA tensors; returns the output.
    With ``scales`` = (k_scale, v_scale), the int8 K/V form, its output
    in q's type.  Every launch adds one to ``decode_attention.launches``,
    or ``.int8_launches`` for the int8 form."""
    B, K, nh, hd = q.shape
    out = torch.empty_like(q)
    kernel = kernel or (_kernel()[0] if scales is None else _int8_kernel())
    pointers = [t.data_ptr() for t in (q, k, v) + (scales or ())]
    with torch.cuda.device(q.device):
        rc = kernel(
            *pointers, None if mask is None else mask.data_ptr(), out.data_ptr(),
            B, K, k.shape[1], nh, hd, _DTYPE_CODE[q.dtype], *plan,
            torch.cuda.current_stream(q.device).cuda_stream,
        )
    if rc != 0:
        raise RuntimeError(f"decode_attention kernel launch failed: CUDA error {rc}")
    if scales is None:
        decode_attention.launches += 1
    else:
        decode_attention.int8_launches += 1
    return out


decode_attention.launches = 0
decode_attention.int8_launches = 0
