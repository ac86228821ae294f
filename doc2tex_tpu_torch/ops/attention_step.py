"""One coverage-attention decode step of the LSTM head.

Per row (a sample's beam) of the decode batch, over S encoder positions,
as the JAX package's ``doc2tex_tpu.ops.attention_step``:

    e[b,s]     = tanh(enc_proj[b,s] + q[b] + loc_feat[b,s] @ w_loc + b_loc) @ w_score
    e[b,s]     = -1e30 where s >= valid_len
    alpha[b,s] = softmax_s(e[b])
    context[b] = sum_s alpha[b,s] * enc[b,s]

``fused_attention_step`` runs the hand-written CUDA kernel
(``csrc/attention_step.cu``) on CUDA tensors and the plain PyTorch version,
``attention_step_reference``, on CPU tensors.  It never falls back from one
to the other: on a CUDA tensor it launches the kernel or raises.
"""

from __future__ import annotations

import ctypes

import torch

from .._build import load_library

SOURCE = "attention_step.cu"
NEG_INF = -1e30
WIDTHS = (128, 256)            # D = H the kernel is built for
_DTYPE_CODE = {torch.float32: 0, torch.bfloat16: 2}


def attention_step_reference(enc, enc_proj, q, loc_feat, w_loc, b_loc, w_score,
                             valid_len=None):
    """Plain PyTorch version: enc (B,S,D), enc_proj (B,S,H) in the compute
    type, q (B,H), loc_feat (B,S,Kl) float32, w_loc (Kl,H), b_loc (H,),
    w_score (H,) or (H,1) -> (context (B,D) f32, alpha (B,S) f32)."""
    H = enc_proj.shape[-1]
    loc_h = loc_feat.float() @ w_loc.float() + b_loc.float()
    x = torch.tanh(enc_proj.float() + q.float()[:, None, :] + loc_h)
    e = (x @ w_score.float().reshape(H, 1))[..., 0]
    if valid_len is not None:
        pos = torch.arange(e.shape[-1], device=e.device)
        e = e.masked_fill(pos[None, :] >= valid_len, NEG_INF)
    alpha = torch.softmax(e, dim=-1)
    context = torch.einsum("bs,bsd->bd", alpha, enc.float())
    return context, alpha


def _kernel():
    lib, info = load_library(SOURCE)
    fn = lib.d2t_attention_step
    fn.restype = ctypes.c_int
    fn.argtypes = [ctypes.c_void_p] * 9 + [ctypes.c_int] * 7 + [ctypes.c_void_p]
    return fn, info


def build() -> dict:
    """Build (if needed) and load the kernel; returns ``load_library``'s info."""
    return _kernel()[1]


def _check(enc, enc_proj, q, loc_feat, w_loc, b_loc, w_score):
    if enc.dim() != 3 or enc_proj.dim() != 3 or loc_feat.dim() != 3 or q.dim() != 2:
        raise ValueError("enc, enc_proj, loc_feat must be 3-D and q 2-D")
    B, S, _ = enc.shape
    H, Kl = enc_proj.shape[-1], loc_feat.shape[-1]
    if enc_proj.shape[:2] != (B, S) or loc_feat.shape[:2] != (B, S) or q.shape != (B, H):
        raise ValueError(f"shape mismatch: enc {tuple(enc.shape)}, enc_proj "
                         f"{tuple(enc_proj.shape)}, q {tuple(q.shape)}, loc_feat "
                         f"{tuple(loc_feat.shape)}")
    if w_loc.shape != (Kl, H) or b_loc.shape != (H,) or w_score.numel() != H:
        raise ValueError(f"weights must be w_loc (Kl,H), b_loc (H,), w_score (H,); got "
                         f"{tuple(w_loc.shape)}, {tuple(b_loc.shape)}, {tuple(w_score.shape)}")
    tensors = (enc, enc_proj, q, loc_feat, w_loc, b_loc, w_score)
    devices = {t.device for t in tensors}
    if len(devices) != 1:
        raise ValueError(f"tensors on different devices: {devices}")


def fused_attention_step(enc, enc_proj, q, loc_feat, w_loc, b_loc, w_score,
                         valid_len=None):
    """One coverage-attention step; see the module docstring.

    ``valid_len``: None, or an int; positions ``s >= valid_len`` get no
    attention.  Returns (context (B, D) float32, alpha (B, S) float32)."""
    _check(enc, enc_proj, q, loc_feat, w_loc, b_loc, w_score)
    if enc.device.type == "cpu":
        return attention_step_reference(enc, enc_proj, q, loc_feat, w_loc, b_loc, w_score,
                                        valid_len)
    if enc.device.type != "cuda":
        raise ValueError(f"unsupported device {enc.device}")
    B, S, D = enc.shape
    H, Kl = enc_proj.shape[-1], loc_feat.shape[-1]
    if enc.dtype != enc_proj.dtype or enc.dtype not in _DTYPE_CODE:
        raise TypeError(f"enc and enc_proj must share float32 or bfloat16; got "
                        f"{enc.dtype}, {enc_proj.dtype}")
    f32 = (q, loc_feat, w_loc, b_loc, w_score)
    if any(t.dtype != torch.float32 for t in f32):
        raise TypeError("q, loc_feat, w_loc, b_loc and w_score must be float32")
    if D != H or D not in WIDTHS or Kl % 4 or Kl == 0 or S == 0:
        raise ValueError(f"kernel takes D = H in {WIDTHS}, Kl a multiple of 4, S > 0; got "
                         f"D={D}, H={H}, Kl={Kl}, S={S}")
    tensors = (enc, enc_proj) + f32
    if not all(t.is_contiguous() for t in tensors):
        raise ValueError("all inputs must be contiguous")
    if any(t.data_ptr() % 16 for t in tensors):
        raise ValueError("all inputs must be 16-byte aligned")
    valid = -1 if valid_len is None else max(int(valid_len), 0)  # the kernel reads -1 as no mask
    kernel, _ = _kernel()
    ctx = torch.empty((B, D), dtype=torch.float32, device=enc.device)
    alpha = torch.empty((B, S), dtype=torch.float32, device=enc.device)
    with torch.cuda.device(enc.device):
        rc = kernel(
            enc.data_ptr(), enc_proj.data_ptr(), q.data_ptr(), loc_feat.data_ptr(),
            w_loc.data_ptr(), b_loc.data_ptr(), w_score.data_ptr(),
            ctx.data_ptr(), alpha.data_ptr(),
            B, S, D, H, Kl, valid, _DTYPE_CODE[enc.dtype],
            torch.cuda.current_stream(enc.device).cuda_stream,
        )
    if rc != 0:
        raise RuntimeError(f"attention_step kernel launch failed at B={B} S={S} D={D} Kl={Kl}: "
                           f"CUDA error {rc} (S and Kl too large for shared memory give 1)")
    fused_attention_step.launches += 1
    return ctx, alpha


fused_attention_step.launches = 0
