"""ViT encoder over hybrid CNN patches (counterpart of
``doc2tex_tpu.models.vit``, the ``HybridEmbed`` + ``pos_embed_mode='sincos'``
variant the released recognizers use).

Shapes are static per bucket: a bucket (H, W) gives the ResNet feature map
``feature_hw(H, W)``, padded up to a multiple of the patch size, and a
token grid of ``grid_size_for`` patches.  The fixed sin-cos table is built
for the max-dimension grid and truncated as a FLAT prefix of its row-major
order — a quirk of the JAX package (``vit.py:192-194``) kept on purpose,
because the weights were trained with it.
"""

from __future__ import annotations

import numpy as np
import torch
import torch.nn as nn
import torch.nn.functional as F

from .layers import Block, Dense, LayerNorm, dropout, sincos_2d_posembed
from .resnet import Conv, ResNetFeatureExtractor, feature_hw


_RESNET = "HybridEmbed_0.ResNetFeatureExtractor_0.FANResNet_0."


def _ceil_to(x: int, m: int) -> int:
    return -(-x // m) * m


def grid_size_for(img_hw: tuple[int, int], patch: tuple[int, int],
                  backbone: str | None = "resnet") -> tuple[int, int]:
    """Patch-grid size for an input image shape (2d patching)."""
    if backbone == "resnet":
        fh, fw = feature_hw(*img_hw)
    elif backbone is None:
        fh, fw = img_hw
    else:
        raise ValueError(f"unknown backbone {backbone!r}")
    return _ceil_to(fh, patch[0]) // patch[0], _ceil_to(fw, patch[1]) // patch[1]


class HybridEmbed(nn.Module):
    """ResNet -> zero-pad to a patch multiple -> patch conv.  Takes NCHW,
    returns (tokens (B, N, D) in row-major grid order, (gh, gw))."""

    def __init__(self, patch_size, embed_dim: int, backbone_channels: int,
                 input_channel: int, dtype: torch.dtype):
        super().__init__()
        self.patch_size = tuple(patch_size)
        self.ResNetFeatureExtractor_0 = ResNetFeatureExtractor(
            input_channel, backbone_channels, dtype=dtype)
        self.Conv_0 = Conv(backbone_channels, embed_dim, self.patch_size,
                           self.patch_size, (0, 0), bias=True, dtype=dtype)
        nn.init.trunc_normal_(self.Conv_0.kernel, std=0.02)

    def forward(self, x, train: bool = False):
        feat = self.ResNetFeatureExtractor_0(x, train)
        _, _, fh, fw = feat.shape
        ph, pw = self.patch_size
        pad_h, pad_w = _ceil_to(fh, ph) - fh, _ceil_to(fw, pw) - fw
        if pad_h or pad_w:
            feat = F.pad(feat, (0, pad_w, 0, pad_h))
        tokens = self.Conv_0(feat)                       # (B, D, gh, gw)
        gh, gw = tokens.shape[2:]
        return tokens.flatten(2).transpose(1, 2), (gh, gw)


class ViTEncoder(nn.Module):
    """Hybrid ViT with the fixed sin-cos table ('sincos' mode).  The drop
    rates act in training only; block i's drop-path rate is the i-th of
    ``depth`` points from 0 to ``drop_path_rate``, as in the JAX module
    (built from a config, it leaves all three at 0)."""

    def __init__(self, embed_dim: int = 256, depth: int = 6, num_heads: int = 8,
                 patch_size=(2, 2), max_grid=(24, 24), backbone_channels: int = 512,
                 input_channel: int = 1, mlp_ratio: float = 4.0,
                 dtype: torch.dtype = torch.float32, drop_rate: float = 0.0,
                 attn_drop_rate: float = 0.0, drop_path_rate: float = 0.0):
        super().__init__()
        self.dtype = dtype
        self.drop_rate = drop_rate
        self.HybridEmbed_0 = HybridEmbed(patch_size, embed_dim, backbone_channels,
                                         input_channel, dtype)
        self.cls_token = nn.Parameter(torch.zeros(1, 1, embed_dim))
        nn.init.trunc_normal_(self.cls_token, std=0.02)
        self.register_buffer(
            "pos_table", sincos_2d_posembed(embed_dim, *max_grid, cls_token=True),
            persistent=False)
        self.depth = depth
        dpr = np.linspace(0.0, drop_path_rate, depth)
        for i in range(depth):
            self.add_module(f"Block_{i}", Block(embed_dim, num_heads, mlp_ratio, dtype,
                                                drop_rate, attn_drop_rate, float(dpr[i])))
        self.LayerNorm_0 = LayerNorm(embed_dim, 1e-6)

    def int8_modules(self):
        """(name, layer) of every layer the reference's int8 hook reaches:
        the convolutions (the ResNet's, ``resnet.``, and the patch conv) and
        the blocks' Denses (attention qkv and proj, MLP fc1 and fc2)."""
        for name, layer in self.named_modules():
            if isinstance(layer, (Conv, Dense)):
                yield name.replace(_RESNET, "resnet."), layer

    def set_int8(self, on: bool) -> list[str]:
        """Route those layers through the int8 op, or back; returns the
        names of the ones that pass the shape gates and so take it."""
        names = []
        for name, layer in self.int8_modules():
            layer.int8 = on
            if layer.takes_int8():
                names.append(name)
        return names

    def forward(self, x, train: bool = False, generator=None):
        """x: (B, H, W, C) -> (tokens (B, N+1, D) in the compute type, grid).
        ``train`` uses the BatchNorm batch statistics (updating the running
        ones) and the drop rates, masks drawn from ``generator``."""
        tokens, grid = self.HybridEmbed_0(x.permute(0, 3, 1, 2), train)
        B, N, D = tokens.shape
        if N + 1 > self.pos_table.shape[0]:
            raise ValueError(f"{N} patches exceed the max-dimension grid")
        cls = self.cls_token.to(tokens.dtype).expand(B, 1, D)
        tokens = torch.cat([cls, tokens], dim=1)
        tokens = tokens + self.pos_table[: N + 1].to(tokens.dtype)[None]
        tokens = dropout(tokens, self.drop_rate, train, generator)
        for i in range(self.depth):
            tokens = getattr(self, f"Block_{i}")(tokens, train, generator)
        return self.LayerNorm_0(tokens).to(self.dtype), grid
