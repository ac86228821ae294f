"""The demo fork's extra components (counterpart of
``doc2tex_tpu.models.extras``): ``Maxout``, ``DepthwiseSeparableConv``,
``ConvModule``, ``ASPP``, ``LocationAwareAttention2DCell``,
``SARDecoderCell``, ``ClovaResNetFeatureExtractor``, ``ConfigurableVGG``
and ``LearnedResizer`` (the width-bucket predictor of ``api.infer
--resizer``).

Their interface is the JAX modules': NHWC maps in and out, the flax
defaults kept (``padding="SAME"``, a bias on every convolution that does
not say otherwise, BatchNorm of momentum 0.99 in float32).  Sub-modules are
named as flax numbers them (``Conv_0``, ``BatchNorm_0``, ``Dense_0``, ...,
in the order the JAX module creates them), so ``weights.py`` carries the
variables across leaf for leaf.  Unlike flax, each module is told its
input widths when it is built.  None of their layers takes the int8 op.
"""

from __future__ import annotations

import torch
import torch.nn as nn
import torch.nn.functional as F

from .layers import Dense, dropout
from .resnet import BatchNorm, Conv, max_pool

FLAX_MOMENTUM = 0.99   # nn.BatchNorm's default, which these modules keep


def _conv(cin, cout, kernel=(3, 3), stride=(1, 1), padding="SAME", bias=True,
          dtype=torch.float32, **kw):
    return Conv(cin, cout, tuple(kernel), tuple(stride), padding, bias=bias, dtype=dtype,
                quantizable=False, **kw)


def _nchw(x):
    return x.permute(0, 3, 1, 2)


def _nhwc(x):
    return x.permute(0, 2, 3, 1)


class Maxout(nn.Module):
    """Max over fixed-size pools of the last axis."""

    def __init__(self, pool_size: int):
        super().__init__()
        self.pool_size = pool_size

    def forward(self, x):
        return x.reshape(*x.shape[:-1], x.shape[-1] // self.pool_size, self.pool_size).amax(-1)


class DepthwiseSeparableConv(nn.Module):
    """A depthwise conv (one group per channel) then a 1x1 conv."""

    def __init__(self, in_channels: int, features: int, kernel=(3, 3), strides=(1, 1),
                 dtype=torch.float32):
        super().__init__()
        self.Conv_0 = _conv(in_channels, in_channels, kernel, strides, dtype=dtype,
                            groups=in_channels)
        self.Conv_1 = _conv(in_channels, features, (1, 1), dtype=dtype)

    def forward(self, x):
        return _nhwc(self.Conv_1(self.Conv_0(_nchw(x))))


class ConvModule(nn.Module):
    """conv (no bias) -> BatchNorm -> relu."""

    def __init__(self, in_channels: int, features: int, kernel=(3, 3), strides=(1, 1),
                 dtype=torch.float32):
        super().__init__()
        self.Conv_0 = _conv(in_channels, features, kernel, strides, bias=False, dtype=dtype)
        self.BatchNorm_0 = BatchNorm(features, momentum=FLAX_MOMENTUM)

    def forward(self, x, train: bool = False):
        return _nhwc(F.relu(self.BatchNorm_0(self.Conv_0(_nchw(x)), train)))


class ASPP(nn.Module):
    """Atrous spatial pyramid pooling: a dilated branch per dilation (1x1 at
    dilation 1), a global-pool branch, concatenated and projected by a 1x1
    conv; dropout in training."""

    def __init__(self, in_channels: int, features: int, dilations=(1, 6, 12, 18),
                 dropout: float = 0.5, dtype=torch.float32):
        super().__init__()
        self.dilations, self.rate = tuple(dilations), dropout
        for i, d in enumerate(self.dilations):
            k = (1, 1) if d == 1 else (3, 3)
            self.add_module(f"Conv_{i}", _conv(in_channels, features, k, bias=False,
                                               dtype=dtype, dilation=(d, d)))
        n = len(self.dilations)
        self.add_module(f"Conv_{n}", _conv(in_channels, features, (1, 1), dtype=dtype))
        self.add_module(f"Conv_{n + 1}", _conv(features * (n + 1), features, (1, 1),
                                               dtype=dtype))

    def forward(self, x, train: bool = False, generator=None):
        x = _nchw(x)
        B, _, H, W = x.shape
        n = len(self.dilations)
        branches = [F.relu(getattr(self, f"Conv_{i}")(x)) for i in range(n)]
        gp = F.relu(getattr(self, f"Conv_{n}")(x.mean(dim=(2, 3), keepdim=True)))
        branches.append(gp.expand(B, gp.shape[1], H, W))
        out = F.relu(getattr(self, f"Conv_{n + 1}")(torch.cat(branches, dim=1)))
        return _nhwc(dropout(out, self.rate, train, generator))


class LocationAwareAttention2DCell(nn.Module):
    """2D location-aware additive attention: key and query projections and
    a conv over the last 2D alignment feed a tanh score; float32 softmax
    over h*w."""

    def __init__(self, query_dim: int, enc_dim: int, hidden_dim: int, kernel_size: int = 2,
                 kernel_dim: int = 64, dtype=torch.float32):
        super().__init__()
        k = 2 * kernel_size + 1
        self.Dense_0 = Dense(enc_dim, hidden_dim, dtype=dtype, quantizable=False)     # key
        self.Dense_1 = Dense(query_dim, hidden_dim, dtype=dtype, quantizable=False)   # query
        self.Conv_0 = _conv(1, kernel_dim, (k, k), dtype=dtype)
        self.Dense_2 = Dense(kernel_dim, hidden_dim, dtype=dtype, quantizable=False)  # loc
        self.Dense_3 = Dense(hidden_dim, 1, dtype=dtype, quantizable=False)           # score

    def forward(self, hidden, enc_2d, last_alignment):
        """hidden (B, Hq); enc_2d (B, h, w, D); last_alignment (B, h, w) ->
        (context (B, D), alignment (B, h, w))."""
        B, h, w, _ = enc_2d.shape
        key = self.Dense_0(enc_2d)
        query = self.Dense_1(hidden)
        loc = self.Dense_2(_nhwc(self.Conv_0(last_alignment[:, None])))
        score = self.Dense_3(torch.tanh(key + query[:, None, None, :] + loc))[..., 0]
        alignment = torch.softmax(score.reshape(B, h * w).float(), dim=-1).reshape(B, h, w)
        return torch.einsum("bhw,bhwd->bd", alignment, enc_2d), alignment


class LSTMCell(nn.Module):
    """flax ``nn.LSTMCell``: gate Denses ``ii``/``if``/``ig``/``io`` of the
    input (no bias) and ``hi``/``hf``/``hg``/``ho`` of h (with bias);
    ``forward((c, h), x) -> ((c', h'), h')``."""

    def __init__(self, in_features: int, features: int, dtype=torch.float32):
        super().__init__()
        for g in "ifgo":
            self.add_module(f"i{g}", Dense(in_features, features, bias=False, dtype=dtype,
                                           quantizable=False))
            self.add_module(f"h{g}", Dense(features, features, dtype=dtype, quantizable=False))

    def forward(self, carry, x):
        c, h = carry
        gate = {g: getattr(self, f"i{g}")(x) + getattr(self, f"h{g}")(h) for g in "ifgo"}
        c = torch.sigmoid(gate["f"]) * c + torch.sigmoid(gate["i"]) * torch.tanh(gate["g"])
        h = torch.sigmoid(gate["o"]) * torch.tanh(c)
        return (c, h), h


class SARDecoderCell(nn.Module):
    """SAR's 2-layer LSTM decode cell with 2D attention: the query from the
    second LSTM's h (a 1x1 conv), the key a 3x3 conv of the map, a tanh
    score by a 1x1 conv, float32 softmax over h*w."""

    def __init__(self, embed_dim: int, feature_channels: int, input_size: int,
                 attention_size: int, dtype=torch.float32):
        super().__init__()
        self.lstm1 = LSTMCell(embed_dim, input_size, dtype)
        self.lstm2 = LSTMCell(input_size, input_size, dtype)
        self.Conv_0 = _conv(input_size, attention_size, (1, 1), dtype=dtype)        # query
        self.Conv_1 = _conv(feature_channels, attention_size, (3, 3), dtype=dtype)  # key
        self.Conv_2 = _conv(attention_size, 1, (1, 1), dtype=dtype)                 # score

    def forward(self, dec_input, feature_map, carry):
        """dec_input (B, E); feature_map (B, h, w, C); carry ((h1, c1), (h2,
        c2)) -> (context (B, C), alignment (B, h, w), carry)."""
        (h1, c1), (h2, c2) = carry
        (c1, h1), _ = self.lstm1((c1, h1), dec_input)
        (c2, h2), _ = self.lstm2((c2, h2), h1)
        query = self.Conv_0(h2[:, :, None, None])
        key = self.Conv_1(_nchw(feature_map))
        score = self.Conv_2(torch.tanh(query + key))[:, 0]
        B, h, w = score.shape
        alignment = torch.softmax(score.reshape(B, h * w).float(), -1).reshape(B, h, w)
        context = torch.einsum("bhw,bhwc->bc", alignment, feature_map)
        return context, alignment, ((h1, c1), (h2, c2))


class _Sequential(nn.Module):
    """Convolutions and BatchNorms numbered in creation order, as flax
    numbers the layers of a compact module that calls them from helper
    functions."""

    def __init__(self):
        super().__init__()
        self._count = {"Conv": 0, "BatchNorm": 0}

    def _add(self, kind: str, module: nn.Module) -> str:
        name = f"{kind}_{self._count[kind]}"
        self._count[kind] += 1
        self.add_module(name, module)
        return name


class ClovaResNetFeatureExtractor(_Sequential):
    """Clova deep-text-recognition's ResNet: a conv stem, four residual
    stages with asymmetric pooling, (B, ~H/16, W/4 + 1, output_channel)."""

    def __init__(self, input_channel: int = 1, output_channel: int = 512, dtype=torch.float32):
        super().__init__()
        oc = output_channel
        chans = [oc // 8, oc // 4, oc // 2, oc]
        self.program = []   # ("convbn", relu, conv, bn) | ("block", [...]) | ("pool", args)
        self.cin = input_channel

        def convbn(f, k=(3, 3), s=(1, 1), p="SAME", cin=None):
            conv = self._add("Conv", _conv(cin or self.cin, f, k, s, p, bias=False, dtype=dtype))
            bn = self._add("BatchNorm", BatchNorm(f, momentum=FLAX_MOMENTUM))
            return conv, bn

        def stem(f, **kw):
            self.program.append(("convbn",) + convbn(f, **kw))
            self.cin = f

        def block(f):
            first, second = convbn(f), convbn(f, cin=f)
            short = convbn(f, k=(1, 1)) if self.cin != f else None
            self.program.append(("block", first, second, short))
            self.cin = f

        stem(chans[0] // 2)
        stem(chans[0])
        self.program.append(("pool", (2, 2), (2, 2), "VALID"))
        block(chans[0])
        stem(chans[0])
        self.program.append(("pool", (2, 2), (2, 2), "VALID"))
        block(chans[1])
        stem(chans[1])
        self.program.append(("pool", (2, 2), (2, 1), ((0, 0), (1, 1))))
        block(chans[2])
        stem(chans[2])
        block(chans[3])
        stem(chans[3], k=(2, 2), s=(2, 1), p=(0, 1))
        stem(chans[3], k=(2, 2), s=(1, 1), p=(0, 0))

    def _convbn(self, x, names, train):
        conv, bn = names
        return getattr(self, bn)(getattr(self, conv)(x), train)

    def forward(self, x, train: bool = False):
        x = _nchw(x)
        for op, *args in self.program:
            if op == "pool":
                x = max_pool(x, *args)
            elif op == "convbn":
                x = F.relu(self._convbn(x, args, train))
            else:
                first, second, short = args
                y = self._convbn(F.relu(self._convbn(x, first, train)), second, train)
                r = self._convbn(x, short, train) if short else x
                x = F.relu(y + r)
        return _nhwc(x)


class ConfigurableVGG(_Sequential):
    """timm-style VGG: each stage n convs (3x3, BatchNorm, relu) then a
    SAME max pool of kernel 2 whose strides come from ``down_sample``."""

    def __init__(self, input_channel: int = 1,
                 stages=((64,), (128,), (256, 256), (512, 512)),
                 down_sample=((2, 2), (2, 2), (2, 1), (2, 1)), dtype=torch.float32):
        super().__init__()
        self.plan = []
        cin = input_channel
        for convs, ds in zip(stages, down_sample):
            layers = []
            for f in convs:
                layers.append((self._add("Conv", _conv(cin, f, dtype=dtype)),
                               self._add("BatchNorm", BatchNorm(f, momentum=FLAX_MOMENTUM))))
                cin = f
            self.plan.append((layers, tuple(ds)))

    def forward(self, x, train: bool = False):
        x = _nchw(x)
        for layers, ds in self.plan:
            for conv, bn in layers:
                x = F.relu(getattr(self, bn)(getattr(self, conv)(x), train))
            x = max_pool(x, (2, 2), ds, "SAME")
        return _nhwc(x)


class LearnedResizer(_Sequential):
    """The width-bucket classifier of the learned resizer: a small ResNet
    (a 7x7 stem of stride 2, a 3x3 max pool, stages of 2, 3 and 3 blocks at
    ``width`` x 1, 2, 4) over a grey crop, mean-pooled, to ``num_buckets``
    float32 logits."""

    def __init__(self, num_buckets: int = 21, width: int = 64, input_channel: int = 1,
                 dtype=torch.float32):
        super().__init__()
        self.stem = self._add("Conv", _conv(input_channel, width, (7, 7), (2, 2), dtype=dtype))
        self.blocks = []
        cin = width
        for i, n in enumerate((2, 3, 3)):
            f = width * 2 ** i
            for j in range(n):
                s = 2 if (j == 0 and i > 0) else 1
                a = self._add("Conv", _conv(cin, f, (3, 3), (s, s), bias=False, dtype=dtype))
                bn_a = self._add("BatchNorm", BatchNorm(f, momentum=FLAX_MOMENTUM))
                b = self._add("Conv", _conv(f, f, (3, 3), bias=False, dtype=dtype))
                bn_b = self._add("BatchNorm", BatchNorm(f, momentum=FLAX_MOMENTUM))
                short = (self._add("Conv", _conv(cin, f, (1, 1), (s, s), dtype=dtype))
                         if cin != f or s != 1 else None)
                self.blocks.append((a, bn_a, b, bn_b, short))
                cin = f
        self.Dense_0 = Dense(cin, num_buckets, quantizable=False)

    def forward(self, x, train: bool = False):
        """x (B, H, W, 1) -> logits (B, num_buckets) float32."""
        x = max_pool(getattr(self, self.stem)(_nchw(x)), (3, 3), (2, 2), "SAME")
        for a, bn_a, b, bn_b, short in self.blocks:
            y = F.relu(getattr(self, bn_a)(getattr(self, a)(x), train))
            y = getattr(self, bn_b)(getattr(self, b)(y), train)
            r = getattr(self, short)(x) if short else x
            x = F.relu(y + r)
        return self.Dense_0(x.mean(dim=(2, 3)).float())
