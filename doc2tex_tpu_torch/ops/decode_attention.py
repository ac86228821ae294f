"""Beam decode attention (self- and cross-) for the TFM head.

Per layer and decode step, K beam queries of a sample attend over an
(M, nh, hd) key/value buffer: the fixed-slot self-attention cache (M =
Tmax*K, masked by the beam ancestry) or the beam-shared encoder memory
(M = S, no mask).  Semantics (f32 softmax), as the JAX package's
``doc2tex_tpu.ops.decode_attention._reference``:

    scores[b,k,h,m] = sum_d q[b,k,h,d] * k[b,m,h,d]     (q pre-scaled)
    scores = where(mask[b,k,m], scores, -inf)
    ctx[b,k,h,d] = sum_m softmax_m(scores)[b,k,h,m] * v[b,m,h,d]

``decode_attention`` runs the hand-written CUDA kernel
(``csrc/decode_attention.cu``) on CUDA tensors and the plain PyTorch
version, ``decode_attention_reference``, on CPU tensors.  It never falls
back from one to the other: on a CUDA tensor it launches the kernel or
raises.
"""

from __future__ import annotations

import ctypes

import torch

from .._build import load_library

SOURCE = "decode_attention.cu"
MAX_BEAM = 16            # queries per sample the kernel holds on chip
HEAD_DIMS = (32, 64, 128)
_DTYPE_CODE = {torch.float32: 0, torch.float16: 1, torch.bfloat16: 2}


def decode_attention_reference(q, k, v, mask=None):
    """Plain PyTorch version: q (B,K,nh,hd), k/v (B,M,nh,hd), mask (B,K,M)
    bool (True = attend) or None -> (B,K,nh,hd) in v.dtype."""
    sc = torch.einsum("bkhd,bmhd->bkhm", q.float(), k.float())
    if mask is not None:
        sc = sc.masked_fill(~mask[:, :, None, :], float("-inf"))
    attn = torch.softmax(sc, dim=-1).to(v.dtype)
    return torch.einsum("bkhm,bmhd->bkhd", attn, v)


def _kernel():
    lib, info = load_library(SOURCE)
    fn = lib.d2t_decode_attention
    fn.restype = ctypes.c_int
    fn.argtypes = [ctypes.c_void_p] * 5 + [ctypes.c_int] * 6 + [ctypes.c_void_p]
    return fn, info


def build() -> dict:
    """Build (if needed) and load the kernel; returns ``load_library``'s info."""
    return _kernel()[1]


def _check(q, k, v, mask):
    if q.dim() != 4 or k.dim() != 4 or v.dim() != 4:
        raise ValueError("q, k, v must be 4-D: (B,K,nh,hd), (B,M,nh,hd), (B,M,nh,hd)")
    B, K, nh, hd = q.shape
    if k.shape != v.shape or k.shape[0] != B or k.shape[2:] != (nh, hd):
        raise ValueError(f"shape mismatch: q {tuple(q.shape)}, k {tuple(k.shape)}, v {tuple(v.shape)}")
    if mask is not None:
        if mask.dtype != torch.bool or mask.shape != (B, K, k.shape[1]):
            raise ValueError(f"mask must be bool (B,K,M); got {mask.dtype} {tuple(mask.shape)}")
    devices = {t.device for t in (q, k, v) + (() if mask is None else (mask,))}
    if len(devices) != 1:
        raise ValueError(f"tensors on different devices: {devices}")


def decode_attention(q, k, v, mask=None, k_scale=None, v_scale=None):
    """Beam decode attention; see the module docstring.

    ``k_scale``/``v_scale`` (int8 K/V) are not ported yet and raise."""
    if k_scale is not None or v_scale is not None:
        raise NotImplementedError("int8 K/V decode attention is not ported yet")
    _check(q, k, v, mask)
    if q.device.type == "cpu":
        return decode_attention_reference(q, k, v, mask)
    if q.device.type != "cuda":
        raise ValueError(f"unsupported device {q.device}")
    B, K, nh, hd = q.shape
    M = k.shape[1]
    if not (q.dtype == k.dtype == v.dtype) or q.dtype not in _DTYPE_CODE:
        raise TypeError(f"q, k, v must share one of float32/float16/bfloat16; got "
                        f"{q.dtype}, {k.dtype}, {v.dtype}")
    if K > MAX_BEAM or hd not in HEAD_DIMS or M == 0:
        raise ValueError(f"kernel takes K <= {MAX_BEAM}, hd in {HEAD_DIMS}, M > 0; "
                         f"got K={K}, hd={hd}, M={M}")
    tensors = (q, k, v) + (() if mask is None else (mask,))
    if not all(t.is_contiguous() for t in tensors):
        raise ValueError("q, k, v and mask must be contiguous")
    if any(t.data_ptr() % 16 for t in (q, k, v)):
        raise ValueError("q, k, v must be 16-byte aligned")
    kernel, _ = _kernel()
    out = torch.empty_like(q)
    with torch.cuda.device(q.device):
        rc = kernel(
            q.data_ptr(), k.data_ptr(), v.data_ptr(),
            None if mask is None else mask.data_ptr(), out.data_ptr(),
            B, K, M, nh, hd, _DTYPE_CODE[q.dtype],
            torch.cuda.current_stream(q.device).cuda_stream,
        )
    if rc != 0:
        raise RuntimeError(f"decode_attention kernel launch failed: CUDA error {rc}")
    decode_attention.launches += 1
    return out


decode_attention.launches = 0
