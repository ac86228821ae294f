"""Common layers: Dense, LayerNorm, sin-cos tables and the ViT block.

Counterparts of ``doc2tex_tpu.models.layers``.  Parameter names follow the
flax variables (``kernel``, ``bias``, ``scale``; sub-modules named
``Dense_0``, ``LayerNorm_1``, ...) so ``weights.py`` maps a flax path to a
state-dict key one to one.  Dense kernels stay ``(in, out)`` and are
applied as ``x @ kernel``, as the JAX code does.

Types follow the JAX modules: a Dense or the attention products compute in
the model's compute type (``dtype``), LayerNorm and softmax in float32.  In
bfloat16 the rounding follows JAX's too: constants are rounded to the
compute type (``scalar``) and the gelu rounds after each op; float32 keeps
the fused forms.
"""

from __future__ import annotations

import math

import torch
import torch.nn as nn
import torch.nn.functional as F


class Dense(nn.Module):
    """flax ``nn.Dense``: ``x @ kernel + bias`` in the compute type."""

    def __init__(self, in_features: int, out_features: int, bias: bool = True,
                 dtype: torch.dtype = torch.float32):
        super().__init__()
        self.dtype = dtype
        self.kernel = nn.Parameter(torch.empty(in_features, out_features))
        self.bias = nn.Parameter(torch.zeros(out_features)) if bias else None
        nn.init.trunc_normal_(self.kernel, std=0.02)

    def forward(self, x):
        y = x.to(self.dtype) @ self.kernel.to(self.dtype)
        return y if self.bias is None else y + self.bias.to(self.dtype)


class LayerNorm(nn.Module):
    """flax ``nn.LayerNorm(dtype=float32)``: normalizes and returns float32."""

    def __init__(self, dim: int, eps: float):
        super().__init__()
        self.eps = eps
        self.scale = nn.Parameter(torch.ones(dim))
        self.bias = nn.Parameter(torch.zeros(dim))

    def forward(self, x):
        return F.layer_norm(x.float(), (x.shape[-1],), self.scale.float(),
                            self.bias.float(), self.eps)


def sincos_2d_posembed(embed_dim: int, grid_h: int, grid_w: int,
                       cls_token: bool = True) -> torch.Tensor:
    """Fixed 2D sin-cos positional table, float32 (grid_h*grid_w [+1], D);
    the cls row is zeros.  Same layout as the JAX function: the first half
    of the channels encodes the column, the second half the row."""
    if embed_dim % 4:
        raise ValueError("embed_dim must be a multiple of 4")
    gh = torch.arange(grid_h, dtype=torch.float32)
    gw = torch.arange(grid_w, dtype=torch.float32)
    grid = torch.stack(torch.meshgrid(gw, gh, indexing="xy"), dim=0)  # (2, gh, gw)

    def emb_1d(pos, dim):
        omega = torch.arange(dim // 2, dtype=torch.float32) / (dim / 2.0)
        omega = 1.0 / 10000 ** omega
        out = pos.reshape(-1)[:, None] * omega[None, :]
        return torch.cat([torch.sin(out), torch.cos(out)], dim=1)

    emb = torch.cat([emb_1d(grid[0], embed_dim // 2),
                     emb_1d(grid[1], embed_dim // 2)], dim=1)
    if cls_token:
        emb = torch.cat([torch.zeros(1, embed_dim), emb], dim=0)
    return emb


def word_posenc(max_len: int, d_model: int) -> torch.Tensor:
    """Decoder-side 1D sin-cos table (max_len, d_model), float32; sin at even
    columns, cos at odd."""
    pos = torch.arange(max_len, dtype=torch.float32)[:, None]
    dim = torch.arange(0, d_model, 2, dtype=torch.float32)
    ang = pos * torch.exp(-math.log(10000.0) * dim / d_model)
    return torch.stack([torch.sin(ang), torch.cos(ang)], dim=-1).reshape(max_len, d_model)


def scalar(value: float, dtype: torch.dtype) -> float:
    """``value`` rounded to ``dtype``.  JAX casts a Python scalar to the
    array's type before an op on it; PyTorch computes with the scalar as
    given, which differs in bfloat16."""
    return float(torch.tensor(value, dtype=dtype))


def gelu_tanh(x):
    """``jax.nn.gelu(x, approximate=True)``.  In float32, PyTorch's fused
    gelu (one pass).  In a narrower type, as JAX writes it, op by op, so
    that each step and each constant rounds to x's type (there a fused
    gelu rounds once and gives other values)."""
    if x.dtype == torch.float32:
        return F.gelu(x, approximate="tanh")
    c0, c1 = scalar(math.sqrt(2 / math.pi), x.dtype), scalar(0.044715, x.dtype)
    cdf = 0.5 * (1.0 + torch.tanh(c0 * (x + c1 * (x ** 3))))
    return x * cdf


class Mlp(nn.Module):
    def __init__(self, dim: int, hidden: int, dtype: torch.dtype):
        super().__init__()
        self.Dense_0 = Dense(dim, hidden, dtype=dtype)
        self.Dense_1 = Dense(hidden, dim, dtype=dtype)

    def forward(self, x):
        return self.Dense_1(gelu_tanh(self.Dense_0(x)))


class SelfAttention(nn.Module):
    """Fused-qkv multi-head self-attention: plain matmul + float32 softmax,
    as the JAX module writes it (no fused attention call)."""

    def __init__(self, dim: int, num_heads: int, dtype: torch.dtype):
        super().__init__()
        self.num_heads = num_heads
        self.dtype = dtype
        self.Dense_0 = Dense(dim, 3 * dim, dtype=dtype)
        self.Dense_1 = Dense(dim, dim, dtype=dtype)

    def forward(self, x):
        B, N, C = x.shape
        hd = C // self.num_heads
        qkv = self.Dense_0(x).reshape(B, N, 3, self.num_heads, hd)
        q, k, v = qkv.unbind(dim=2)  # (B, N, H, hd)
        attn = torch.einsum("bnhd,bmhd->bhnm", q, k) * scalar(hd ** -0.5, self.dtype)
        attn = torch.softmax(attn.float(), dim=-1).to(self.dtype)
        out = torch.einsum("bhnm,bmhd->bnhd", attn, v).reshape(B, N, C)
        return self.Dense_1(out)


class Block(nn.Module):
    """Pre-LN transformer block (LayerNorm eps 1e-6)."""

    def __init__(self, dim: int, num_heads: int, mlp_ratio: float, dtype: torch.dtype):
        super().__init__()
        self.LayerNorm_0 = LayerNorm(dim, 1e-6)
        self.SelfAttention_0 = SelfAttention(dim, num_heads, dtype)
        self.LayerNorm_1 = LayerNorm(dim, 1e-6)
        self.Mlp_0 = Mlp(dim, int(dim * mlp_ratio), dtype)

    def forward(self, x):
        x = x + self.SelfAttention_0(self.LayerNorm_0(x))
        return x + self.Mlp_0(self.LayerNorm_1(x))
