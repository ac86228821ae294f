"""ViT encoders over hybrid CNN or raw patches (counterpart of
``doc2tex_tpu.models.vit``).

Patch embeddings, by ``patching_style`` and backbone:

- ``HybridEmbed`` (2d, backbone ``resnet`` or ``vgg``): the CNN map,
  zero-padded up to a patch multiple, then the patch conv;
- ``HybridEmbed1D`` (1d, TRIG): the CNN map, padded in width, a (1, w)
  conv of stride (1, w), then the mean over height: one token per column
  window;
- ``PatchEmbed`` (no backbone): the patch conv over the padded image.

Position tables (``pos_embed_mode``):

- ``sincos``: the fixed 2D sin-cos table of the max-dimension grid,
  truncated as a FLAT prefix of its row-major order, a quirk of the JAX
  package (``vit.py:192-194``) kept on purpose because the weights were
  trained with it;
- ``truncate``: a learned table ``pos_embed`` (max_n + 1, D), truncated
  the same way;
- ``interpolate``: the learned table's grid resized to the bucket's grid
  by ``bicubic_resize``, the JAX package's ``jax.image.resize(...,
  "bicubic")`` (the learned table is used as it is at the max grid).

Shapes are static per bucket.  Only the ResNet's convolutions, the 2d
hybrid patch conv and the blocks' Denses take the int8 op, as in JAX.
"""

from __future__ import annotations

import numpy as np
import torch
import torch.nn as nn
import torch.nn.functional as F

from .layers import Block, LayerNorm, dropout, quantizable_layers, set_int8, sincos_2d_posembed
from .resnet import Conv, ResNetFeatureExtractor, feature_hw
from .vgg import VGGFeatureExtractor


_RESNET = "HybridEmbed_0.ResNetFeatureExtractor_0.FANResNet_0."


def _ceil_to(x: int, m: int) -> int:
    return -(-x // m) * m


def grid_size_for(img_hw: tuple[int, int], patch: tuple[int, int],
                  backbone: str | None = "resnet", patching_style: str = "2d"
                  ) -> tuple[int, int]:
    """Patch-grid size for an input image shape."""
    if backbone == "resnet":
        fh, fw = feature_hw(*img_hw)
    elif backbone is None:
        fh, fw = img_hw
    else:
        raise ValueError(f"unknown backbone {backbone!r}")
    if patching_style == "1d":
        return 1, _ceil_to(fw, patch[1]) // patch[1]
    return _ceil_to(fh, patch[0]) // patch[0], _ceil_to(fw, patch[1]) // patch[1]


def keys_cubic(x):
    """The Keys cubic kernel with a = -0.5 at |x| (``jax.image``'s)."""
    out = ((1.5 * x - 2.5) * x) * x + 1.0
    out = torch.where(x >= 1.0, ((-0.5 * x + 2.5) * x - 4.0) * x + 2.0, out)
    return torch.where(x >= 2.0, torch.zeros_like(x), out)


def cubic_weights(n_in: int, n_out: int) -> torch.Tensor:
    """(n_in, n_out) float32 weights of ``jax.image.scale_and_translate``'s
    ``compute_weight_mat`` for the Keys cubic at half-pixel centres: the
    kernel widened by 1 / scale where it shrinks (antialias), each column
    normalised to sum 1, in float32 as JAX computes it."""
    inv_scale = 1.0 / (n_out / n_in)
    inv = torch.tensor(inv_scale, dtype=torch.float32)
    kernel_scale = torch.clamp(inv, min=1.0)
    sample = (torch.arange(n_out, dtype=torch.float32) + 0.5) * inv - 0.0 * inv - 0.5
    x = (sample[None, :] - torch.arange(n_in, dtype=torch.float32)[:, None]).abs() / kernel_scale
    w = keys_cubic(x)
    total = w.sum(dim=0, keepdim=True)
    w = torch.where(total.abs() > 1000.0 * float(np.finfo(np.float32).eps),
                    w / torch.where(total != 0, total, torch.ones_like(total)),
                    torch.zeros_like(w))
    inside = (sample >= -0.5) & (sample <= n_in - 0.5)
    return torch.where(inside[None, :], w, torch.zeros_like(w))


def bicubic_resize(grid: torch.Tensor, out_hw: tuple[int, int]) -> torch.Tensor:
    """``jax.image.resize(grid, (h, w, D), "bicubic")`` of a float32 (H, W,
    D) grid: one weight matrix per resized axis (an axis of equal size is
    left alone, as JAX skips it)."""
    H, W, _ = grid.shape
    h, w = out_hw
    if H != h:
        grid = torch.einsum("hwd,hk->kwd", grid, cubic_weights(H, h).to(grid.device))
    if W != w:
        grid = torch.einsum("hwd,wk->hkd", grid, cubic_weights(W, w).to(grid.device))
    return grid


def _backbone(name: str, input_channel: int, channels: int, gcb: bool, dtype):
    """(module name, module) of a CNN backbone, as flax names it."""
    if name == "resnet":
        return "ResNetFeatureExtractor_0", ResNetFeatureExtractor(input_channel, channels,
                                                                  dtype=dtype, gcb=gcb)
    if name == "vgg":
        return "VGGFeatureExtractor_0", VGGFeatureExtractor(input_channel, channels, dtype)
    raise ValueError(f"unknown backbone {name!r}")


class HybridEmbed(nn.Module):
    """CNN -> zero-pad to a patch multiple -> patch conv.  Takes NCHW,
    returns (tokens (B, N, D) in row-major grid order, (gh, gw))."""

    def __init__(self, patch_size, embed_dim: int, backbone_channels: int,
                 input_channel: int, dtype: torch.dtype, backbone_name: str = "resnet",
                 gcb: bool = False):
        super().__init__()
        self.patch_size = tuple(patch_size)
        self.backbone, module = _backbone(backbone_name, input_channel, backbone_channels,
                                          gcb, dtype)
        self.add_module(self.backbone, module)
        self.Conv_0 = Conv(backbone_channels, embed_dim, self.patch_size,
                           self.patch_size, (0, 0), bias=True, dtype=dtype)
        nn.init.trunc_normal_(self.Conv_0.kernel, std=0.02)

    def forward(self, x, train: bool = False):
        feat = getattr(self, self.backbone)(x, train)
        _, _, fh, fw = feat.shape
        ph, pw = self.patch_size
        pad_h, pad_w = _ceil_to(fh, ph) - fh, _ceil_to(fw, pw) - fw
        if pad_h or pad_w:
            feat = F.pad(feat, (0, pad_w, 0, pad_h))
        tokens = self.Conv_0(feat)                       # (B, D, gh, gw)
        gh, gw = tokens.shape[2:]
        return tokens.flatten(2).transpose(1, 2), (gh, gw)


class HybridEmbed1D(nn.Module):
    """TRIG 1d patching: CNN -> pad the width to a multiple of
    ``patch_width`` -> a (1, w) conv of stride (1, w) -> mean over height.
    Returns (tokens (B, gw, D), (1, gw))."""

    def __init__(self, patch_width: int, embed_dim: int, backbone_channels: int,
                 input_channel: int, dtype: torch.dtype, backbone_name: str = "resnet",
                 gcb: bool = False):
        super().__init__()
        self.patch_width = patch_width
        self.backbone, module = _backbone(backbone_name, input_channel, backbone_channels,
                                          gcb, dtype)
        self.add_module(self.backbone, module)
        self.Conv_0 = Conv(backbone_channels, embed_dim, (1, patch_width), (1, patch_width),
                           (0, 0), bias=True, dtype=dtype, quantizable=False)
        nn.init.trunc_normal_(self.Conv_0.kernel, std=0.02)

    def forward(self, x, train: bool = False):
        feat = getattr(self, self.backbone)(x, train)
        fw = feat.shape[3]
        pad_w = _ceil_to(fw, self.patch_width) - fw
        if pad_w:
            feat = F.pad(feat, (0, pad_w))
        tokens = self.Conv_0(feat).mean(dim=2)           # (B, D, gw)
        return tokens.transpose(1, 2), (1, tokens.shape[2])


class PatchEmbed(nn.Module):
    """Patch conv over the image, zero-padded up to a patch multiple."""

    def __init__(self, patch_size, embed_dim: int, input_channel: int, dtype: torch.dtype):
        super().__init__()
        self.patch_size = tuple(patch_size)
        self.Conv_0 = Conv(input_channel, embed_dim, self.patch_size, self.patch_size, (0, 0),
                           bias=True, dtype=dtype, quantizable=False)
        nn.init.trunc_normal_(self.Conv_0.kernel, std=0.02)

    def forward(self, x, train: bool = False):
        _, _, H, W = x.shape
        ph, pw = self.patch_size
        pad_h, pad_w = _ceil_to(H, ph) - H, _ceil_to(W, pw) - W
        if pad_h or pad_w:
            x = F.pad(x, (0, pad_w, 0, pad_h))
        tokens = self.Conv_0(x)
        gh, gw = tokens.shape[2:]
        return tokens.flatten(2).transpose(1, 2), (gh, gw)


class ViTEncoder(nn.Module):
    """ViT over hybrid or raw patches with the position table of
    ``pos_embed_mode`` (see the module docstring).  The drop rates act in
    training only; block i's drop-path rate is the i-th of ``depth`` points
    from 0 to ``drop_path_rate``, as in the JAX module (built from a
    config, it leaves all three at 0)."""

    def __init__(self, embed_dim: int = 256, depth: int = 6, num_heads: int = 8,
                 patch_size=(2, 2), max_grid=(24, 24), backbone_channels: int = 512,
                 input_channel: int = 1, mlp_ratio: float = 4.0,
                 dtype: torch.dtype = torch.float32, drop_rate: float = 0.0,
                 attn_drop_rate: float = 0.0, drop_path_rate: float = 0.0,
                 patching_style: str = "2d", backbone_name: str | None = "resnet",
                 gcb: bool = False, pos_embed_mode: str = "sincos"):
        super().__init__()
        if pos_embed_mode not in ("sincos", "truncate", "interpolate"):
            raise ValueError(pos_embed_mode)
        self.dtype = dtype
        self.drop_rate = drop_rate
        self.max_grid, self.pos_embed_mode = tuple(max_grid), pos_embed_mode
        if patching_style == "1d":
            self.embed = "HybridEmbed1D_0"
            module = HybridEmbed1D(patch_size[1], embed_dim, backbone_channels, input_channel,
                                   dtype, backbone_name or "resnet", gcb)
        elif backbone_name is None:
            self.embed = "PatchEmbed_0"
            module = PatchEmbed(patch_size, embed_dim, input_channel, dtype)
        else:
            self.embed = "HybridEmbed_0"
            module = HybridEmbed(patch_size, embed_dim, backbone_channels, input_channel,
                                 dtype, backbone_name, gcb)
        self.add_module(self.embed, module)
        self.cls_token = nn.Parameter(torch.zeros(1, 1, embed_dim))
        nn.init.trunc_normal_(self.cls_token, std=0.02)
        if pos_embed_mode == "sincos":
            self.register_buffer(
                "pos_table", sincos_2d_posembed(embed_dim, *max_grid, cls_token=True),
                persistent=False)
        else:
            self.pos_embed = nn.Parameter(torch.zeros(max_grid[0] * max_grid[1] + 1,
                                                      embed_dim))
            nn.init.trunc_normal_(self.pos_embed, std=0.02)
        self.depth = depth
        dpr = np.linspace(0.0, drop_path_rate, depth)
        for i in range(depth):
            self.add_module(f"Block_{i}", Block(embed_dim, num_heads, mlp_ratio, dtype,
                                                drop_rate, attn_drop_rate, float(dpr[i])))
        self.LayerNorm_0 = LayerNorm(embed_dim, 1e-6)

    def position_table(self, grid: tuple[int, int], n: int) -> torch.Tensor:
        """The (n + 1, D) float32 table added to the cls token and n patches
        of a ``grid``."""
        if self.pos_embed_mode == "sincos":
            table = self.pos_table
        else:
            table = self.pos_embed
            if self.pos_embed_mode == "interpolate" and tuple(grid) != self.max_grid:
                D = table.shape[1]
                resized = bicubic_resize(table[1:].float().reshape(*self.max_grid, D), grid)
                return torch.cat([table[:1], resized.reshape(n, D)], dim=0)
        if n + 1 > table.shape[0]:
            raise ValueError(f"{n} patches exceed the max-dimension grid")
        return table[: n + 1]

    def int8_modules(self):
        """(name, layer) of every layer the reference's int8 hook reaches:
        the ResNet's convolutions (``resnet.``), the 2d patch conv and the
        blocks' Denses (attention qkv and proj, MLP fc1 and fc2)."""
        return quantizable_layers(self, {_RESNET: "resnet."})

    def set_int8(self, on: bool) -> list[str]:
        """Route those layers through the int8 op, or back; returns the
        names of the ones that pass the shape gates and so take it."""
        return set_int8(self.int8_modules(), on)

    def forward(self, x, train: bool = False, generator=None):
        """x: (B, H, W, C) -> (tokens (B, N+1, D) in the compute type, grid).
        ``train`` uses the BatchNorm batch statistics (updating the running
        ones) and the drop rates, masks drawn from ``generator``."""
        tokens, grid = getattr(self, self.embed)(x.permute(0, 3, 1, 2), train)
        B, N, D = tokens.shape
        cls = self.cls_token.to(tokens.dtype).expand(B, 1, D)
        tokens = torch.cat([cls, tokens], dim=1)
        tokens = tokens + self.position_table(grid, N).to(tokens.dtype)[None]
        tokens = dropout(tokens, self.drop_rate, train, generator)
        for i in range(self.depth):
            tokens = getattr(self, f"Block_{i}")(tokens, train, generator)
        return self.LayerNorm_0(tokens).to(self.dtype), grid
