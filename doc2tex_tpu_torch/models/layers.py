"""Common layers: Dense, LayerNorm, sin-cos tables, dropout, drop-path and
the ViT block.

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

Dropout and drop-path act only when a module is called with ``train`` and
a rate above 0; their masks are drawn from the ``torch.Generator`` the
caller passes (on the input's device), and the kept values are divided by
the keep rate as flax does: ``where(mask, x / keep, 0)``.
"""

from __future__ import annotations

import math

import torch
import torch.nn as nn
import torch.nn.functional as F

from ..ops import quant
from ..parallel.mesh import rand


class Dense(nn.Module):
    """flax ``nn.Dense``: ``x @ kernel + bias`` in the compute type.

    With ``int8`` set (the ViT blocks' Denses under ``quantize: int8``) and
    the shape gates of ``ops/quant.py`` passed, the product runs through
    the int8 op instead; ``quantizable=False`` marks a Dense the JAX package
    never routes there."""

    def __init__(self, in_features: int, out_features: int, bias: bool = True,
                 dtype: torch.dtype = torch.float32, quantizable: bool = True):
        super().__init__()
        self.dtype = dtype
        self.quantizable = quantizable
        self.int8 = False
        self._int8_kernel = None
        self.kernel = nn.Parameter(torch.empty(in_features, out_features))
        self.bias = nn.Parameter(torch.zeros(out_features)) if bias else None
        nn.init.trunc_normal_(self.kernel, std=0.02)

    def takes_int8(self) -> bool:
        return self.int8 and self.quantizable and quant.gated(*self.kernel.shape)

    def forward(self, x):
        if self.takes_int8():
            w_q, w_scale = quant.layer_weight(self, quant.quantize_weight)
            return quant.int8_linear(x, w_q, w_scale, self.bias, self.dtype)
        y = x.to(self.dtype) @ self.kernel.to(self.dtype)
        return y if self.bias is None else y + self.bias.to(self.dtype)


def quantizable_layers(module: nn.Module, rename: dict | None = None):
    """(name, layer) of every Conv and Dense under ``module`` that the JAX
    package routes through its int8 hook (``quantizable``), named by their
    path with the prefixes of ``rename`` replaced."""
    from .resnet import Conv

    for name, layer in module.named_modules():
        if isinstance(layer, (Conv, Dense)) and layer.quantizable:
            for old, new in (rename or {}).items():
                name = name.replace(old, new)
            yield name, layer


def set_int8(layers, on: bool) -> list[str]:
    """Set the int8 flag of each (name, layer); returns the names of the
    layers that pass the shape gates and so take the int8 op."""
    names = []
    for name, layer in layers:
        layer.int8 = on
        if layer.takes_int8():
            names.append(name)
    return names


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


def posenc_1d(max_len: int, d_model: int) -> torch.Tensor:
    """1D sin-cos table over sequence positions (the BiLSTM stage's)."""
    return word_posenc(max_len, d_model)


def posenc_2d_hw(h: int, w: int, d_model: int) -> torch.Tensor:
    """h/w-split 2D sin-cos table (h, w, d_model) float32: the first half
    of the channels encodes the row, the second half the column."""
    if d_model % 2:
        raise ValueError("d_model must be even")
    half = d_model // 2
    pe_h = word_posenc(h, half)[:, None, :].expand(h, w, half)
    pe_w = word_posenc(w, half)[None, :, :].expand(h, w, half)
    return torch.cat([pe_h, pe_w], dim=-1)


class GatedSum(nn.Module):
    """Sigmoid-gated blend ``g * a + (1 - g) * b``, g from a float32 Dense
    of the two inputs side by side."""

    def __init__(self, dim: int):
        super().__init__()
        self.Dense_0 = Dense(2 * dim, 1, quantizable=False)

    def forward(self, a, b):
        t = torch.promote_types(a.dtype, b.dtype)
        g = torch.sigmoid(self.Dense_0(torch.cat([a.to(t), b.to(t)], dim=-1)))
        return g * a + (1.0 - g) * b


class Adaptive2DPositionalEncoding(nn.Module):
    """SATRN's adaptive 2D table: the h and w sin-cos tables, each scaled
    per sample and channel by a sigmoid of a 2-layer MLP over the map's
    mean.  NCHW in, NCHW out."""

    def __init__(self, d_model: int, max_h: int = 256, max_w: int = 256,
                 dtype: torch.dtype = torch.float32):
        super().__init__()
        self.register_buffer("pe_h", word_posenc(max_h, d_model), persistent=False)
        self.register_buffer("pe_w", word_posenc(max_w, d_model), persistent=False)
        for axis in ("h", "w"):
            self.add_module(f"{axis}_fc1", Dense(d_model, d_model // 2, dtype=dtype,
                                                 quantizable=False))
            self.add_module(f"{axis}_fc2", Dense(d_model // 2, d_model, dtype=dtype,
                                                 quantizable=False))

    def forward(self, x):
        B, C, H, W = x.shape
        pooled = x.mean(dim=(2, 3))
        alpha = {axis: torch.sigmoid(getattr(self, f"{axis}_fc2")(
            F.relu(getattr(self, f"{axis}_fc1")(pooled)))) for axis in ("h", "w")}
        pe_h = self.pe_h[:H].to(x.dtype).T[None, :, :, None]     # (1, C, H, 1)
        pe_w = self.pe_w[:W].to(x.dtype).T[None, :, None, :]     # (1, C, 1, W)
        return (x + alpha["h"][:, :, None, None] * pe_h
                + alpha["w"][:, :, None, None] * pe_w)


class PosConv(nn.Module):
    """PEG positional encoding: a depthwise 3x3 conv (SAME) over the token
    grid, added back at stride 1.  Tokens (B, N, C) without the cls token."""

    def __init__(self, dim: int, stride: int = 1, dtype: torch.dtype = torch.float32):
        super().__init__()
        from .resnet import Conv

        self.stride = stride
        self.Conv_0 = Conv(dim, dim, (3, 3), (stride, stride), "SAME", bias=True,
                           dtype=dtype, groups=dim, quantizable=False)

    def forward(self, x, grid_hw):
        B, N, C = x.shape
        feat = x.reshape(B, *grid_hw, C).permute(0, 3, 1, 2)
        out = self.Conv_0(feat)
        if self.stride == 1:
            out = out + feat
        return out.flatten(2).transpose(1, 2)


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


def _keep(x, keep: float, mask):
    return torch.where(mask, x / scalar(keep, x.dtype), torch.zeros((), dtype=x.dtype,
                                                                      device=x.device))


def dropout(x, rate: float, train: bool = False, generator=None):
    """flax ``nn.Dropout(rate)``: identity at rate 0 or outside training;
    else each element kept with probability 1 - rate."""
    if rate == 0.0 or not train:
        return x
    if rate == 1.0:
        return torch.zeros_like(x)
    keep = 1.0 - rate
    mask = rand(x.shape, generator=generator, device=x.device) < keep
    return _keep(x, keep, mask)


def drop_path(x, rate: float, train: bool = False, generator=None):
    """Stochastic depth (``doc2tex_tpu.models.layers.DropPath``): one keep
    draw per sample, broadcast over the other axes."""
    if rate == 0.0 or not train:
        return x
    keep = 1.0 - rate
    shape = (x.shape[0],) + (1,) * (x.dim() - 1)
    mask = rand(shape, generator=generator, device=x.device) < keep
    return _keep(x, keep, mask)


class Mlp(nn.Module):
    def __init__(self, dim: int, hidden: int, dtype: torch.dtype, drop: float = 0.0):
        super().__init__()
        self.drop = drop
        self.Dense_0 = Dense(dim, hidden, dtype=dtype)
        self.Dense_1 = Dense(hidden, dim, dtype=dtype)

    def forward(self, x, train: bool = False, generator=None):
        x = dropout(gelu_tanh(self.Dense_0(x)), self.drop, train, generator)
        return dropout(self.Dense_1(x), self.drop, train, generator)


class SelfAttention(nn.Module):
    """Fused-qkv multi-head self-attention: plain matmul + float32 softmax,
    as the JAX module writes it (no fused attention call).  ``capture`` is
    off (None) unless a caller sets it to a list
    (``tools.interpretation.capture_attention``): then each forward appends
    its attention probabilities, as the JAX module sows ``attn_probs``."""

    capture = None

    def __init__(self, dim: int, num_heads: int, dtype: torch.dtype,
                 attn_drop: float = 0.0, proj_drop: float = 0.0):
        super().__init__()
        self.num_heads = num_heads
        self.dtype = dtype
        self.attn_drop, self.proj_drop = attn_drop, proj_drop
        self.Dense_0 = Dense(dim, 3 * dim, dtype=dtype)
        self.Dense_1 = Dense(dim, dim, dtype=dtype)

    def forward(self, x, train: bool = False, generator=None):
        B, N, C = x.shape
        hd = C // self.num_heads
        qkv = self.Dense_0(x).reshape(B, N, 3, self.num_heads, hd)
        q, k, v = qkv.unbind(dim=2)  # (B, N, H, hd)
        attn = torch.einsum("bnhd,bmhd->bhnm", q, k) * scalar(hd ** -0.5, self.dtype)
        attn = torch.softmax(attn.float(), dim=-1).to(self.dtype)
        if self.capture is not None:
            self.capture.append(attn.detach())
        attn = dropout(attn, self.attn_drop, train, generator)
        out = torch.einsum("bhnm,bmhd->bnhd", attn, v).reshape(B, N, C)
        return dropout(self.Dense_1(out), self.proj_drop, train, generator)


class Block(nn.Module):
    """Pre-LN transformer block (LayerNorm eps 1e-6)."""

    def __init__(self, dim: int, num_heads: int, mlp_ratio: float, dtype: torch.dtype,
                 drop: float = 0.0, attn_drop: float = 0.0, drop_path: float = 0.0):
        super().__init__()
        self.drop_path = drop_path
        self.LayerNorm_0 = LayerNorm(dim, 1e-6)
        self.SelfAttention_0 = SelfAttention(dim, num_heads, dtype, attn_drop, drop)
        self.LayerNorm_1 = LayerNorm(dim, 1e-6)
        self.Mlp_0 = Mlp(dim, int(dim * mlp_ratio), dtype, drop)

    def forward(self, x, train: bool = False, generator=None):
        h = self.SelfAttention_0(self.LayerNorm_0(x), train, generator)
        x = x + drop_path(h, self.drop_path, train, generator)
        h = self.Mlp_0(self.LayerNorm_1(x), train, generator)
        return x + drop_path(h, self.drop_path, train, generator)
