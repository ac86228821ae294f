"""FAN-style ResNet feature extractor (counterpart of
``doc2tex_tpu.models.resnet``).

BasicBlock x [1, 2, 5, 3] with asymmetric pooling so the feature map keeps
horizontal resolution:

  stem conv0_1/conv0_2 -> maxpool(2,2) -> layer1 -> conv1
  -> maxpool(2,2) -> layer2 -> conv2
  -> maxpool(k2, s(2,1), p(0,1)) -> layer3 -> conv3
  -> layer4 -> conv4_1(k2, s(2,1), p(0,1)) -> conv4_2(k2, s1, p0)

Inside, the port runs NCHW convolutions (PyTorch's layout); kernels are
stored OIHW (``weights.py`` converts flax's HWIO).  BatchNorm computes in
float32 and returns the compute type, as flax's BatchNorm does: with its
running statistics, or with ``train`` by flax's training rules (below).
"""

from __future__ import annotations

import torch
import torch.nn as nn
import torch.nn.functional as F

from ..ops import quant


def feature_hw(h: int, w: int) -> tuple[int, int]:
    """Static output-shape math: (H//16 - 1, W//4 + 1) for H, W multiples
    of 16 / 4."""
    h1, w1 = h // 2, w // 2          # maxpool1
    h2, w2 = h1 // 2, w1 // 2        # maxpool2
    h3 = (h2 - 2) // 2 + 1           # maxpool3: k2 s(2,1) p(0,1)
    w3 = w2 + 1
    h4 = (h3 - 2) // 2 + 1           # conv4_1: k2 s(2,1) p(0,1)
    w4 = w3 + 1
    return h4 - 1, w4 - 1            # conv4_2: k2 s1 p0


class Conv(nn.Module):
    """flax ``nn.Conv`` on NCHW input; ``kernel`` is OIHW.

    With ``int8`` set (the encoder under ``quantize: int8``) and the shape
    gates of ``ops/quant.py`` passed, the convolution runs through the int8
    op instead."""

    def __init__(self, cin: int, cout: int, kernel=(3, 3), stride=(1, 1),
                 padding=(1, 1), bias: bool = False, dtype: torch.dtype = torch.float32):
        super().__init__()
        self.stride, self.padding, self.dtype = tuple(stride), tuple(padding), dtype
        self.int8 = False
        self._int8_kernel = None
        self.kernel = nn.Parameter(torch.empty(cout, cin, *kernel))
        self.bias = nn.Parameter(torch.zeros(cout)) if bias else None
        nn.init.kaiming_normal_(self.kernel, mode="fan_out")

    def takes_int8(self) -> bool:
        cout, cin, kh, kw = self.kernel.shape
        return self.int8 and quant.gated(cin * kh * kw, cout)

    def forward(self, x):
        if self.takes_int8():
            w_q, w_scale = quant.layer_weight(self, quant.quantize_conv_weight)
            return quant.int8_conv2d(x, w_q, w_scale, self.bias, tuple(self.kernel.shape[2:]),
                                     self.stride, self.padding, self.dtype)
        kernel = self.kernel.to(self.dtype)
        if self.dtype == torch.float32 or self.bias is None:
            return F.conv2d(x.to(self.dtype), kernel, self.bias, self.stride, self.padding)
        # in a narrower type the bias is added after the convolution's output
        # is rounded to it, as flax does (a bias fused into the convolution
        # would round once, and give other values)
        y = F.conv2d(x.to(self.dtype), kernel, None, self.stride, self.padding)
        return y + self.bias.to(self.dtype).view(1, -1, 1, 1)


class BatchNorm(nn.Module):
    """flax ``nn.BatchNorm(momentum=0.9, epsilon=1e-5)`` over the channel
    axis of NCHW input.

    ``train=False`` normalizes with the running statistics.  ``train=True``
    follows flax, not ``F.batch_norm(training=True)``: the batch statistics
    are ``E[x]`` and the BIASED ``max(E[x^2] - E[x]^2, 0)`` in float32 (or
    the input's type where it is wider, as flax computes them), both
    used to normalize and folded into the running statistics as
    ``0.9 * running + 0.1 * batch`` (torch would fold the unbiased variance,
    at momentum 0.1 of the other side).  One rounding to the input's type
    at the end, as in eval."""

    def __init__(self, channels: int, eps: float = 1e-5):
        super().__init__()
        self.eps = eps
        self.scale = nn.Parameter(torch.ones(channels))
        self.bias = nn.Parameter(torch.zeros(channels))
        self.register_buffer("mean", torch.zeros(channels))
        self.register_buffer("var", torch.ones(channels))

    def forward(self, x, train: bool = False):
        if not train:
            # float32 arithmetic and one rounding to the input's type at the
            # end, in one pass: flax subtracts the float32 running mean from
            # the input, which promotes it, and casts the result to the
            # module's type
            return F.batch_norm(x, self.mean, self.var, self.scale, self.bias,
                                training=False, eps=self.eps)
        x32 = x.to(torch.promote_types(x.dtype, torch.float32))
        mean = x32.mean(dim=(0, 2, 3))
        var = torch.clamp((x32 * x32).mean(dim=(0, 2, 3)) - mean * mean, min=0.0)
        with torch.no_grad():
            self.mean.copy_(0.9 * self.mean + (1 - 0.9) * mean)
            self.var.copy_(0.9 * self.var + (1 - 0.9) * var)
        mul = torch.rsqrt(var + self.eps) * self.scale
        y = (x32 - mean[None, :, None, None]) * mul[None, :, None, None]
        return (y + self.bias[None, :, None, None]).to(x.dtype)


class ConvBN(nn.Module):
    def __init__(self, cin, cout, kernel=(3, 3), stride=(1, 1), padding=(1, 1),
                 dtype=torch.float32):
        super().__init__()
        self.Conv_0 = Conv(cin, cout, kernel, stride, padding, dtype=dtype)
        self.BatchNorm_0 = BatchNorm(cout)

    def forward(self, x, train: bool = False):
        return self.BatchNorm_0(self.Conv_0(x), train)


class BasicBlock(nn.Module):
    """3x3-3x3 residual block; 1x1 conv + BN on the shortcut when the
    channel count changes."""

    def __init__(self, cin: int, planes: int, dtype: torch.dtype):
        super().__init__()
        self.ConvBN_0 = ConvBN(cin, planes, dtype=dtype)
        self.ConvBN_1 = ConvBN(planes, planes, dtype=dtype)
        self.downsample = cin != planes
        if self.downsample:
            self.Conv_0 = Conv(cin, planes, (1, 1), padding=(0, 0), dtype=dtype)
            self.BatchNorm_0 = BatchNorm(planes)

    def forward(self, x, train: bool = False):
        out = self.ConvBN_1(F.relu(self.ConvBN_0(x, train)), train)
        residual = (self.BatchNorm_0(self.Conv_0(x), train) if self.downsample
                    else x.to(out.dtype))
        return F.relu(out + residual)


class FANResNet(nn.Module):
    def __init__(self, input_channel: int = 1, output_channel: int = 512,
                 layers=(1, 2, 5, 3), dtype: torch.dtype = torch.float32):
        super().__init__()
        oc = [output_channel // 4, output_channel // 2, output_channel, output_channel]
        inplanes = output_channel // 8
        convs = [
            ConvBN(input_channel, output_channel // 16, dtype=dtype),
            ConvBN(output_channel // 16, inplanes, dtype=dtype),
            ConvBN(oc[0], oc[0], dtype=dtype),
            ConvBN(oc[1], oc[1], dtype=dtype),
            ConvBN(oc[2], oc[2], dtype=dtype),
            ConvBN(oc[3], oc[3], (2, 2), (2, 1), (0, 1), dtype=dtype),  # conv4_1
            ConvBN(oc[3], oc[3], (2, 2), (1, 1), (0, 0), dtype=dtype),  # conv4_2
        ]
        for i, m in enumerate(convs):
            self.add_module(f"ConvBN_{i}", m)
        self.stages = []
        n, cin = 0, inplanes
        for planes, blocks in zip(oc, layers):
            names = []
            for _ in range(blocks):
                self.add_module(f"BasicBlock_{n}", BasicBlock(cin, planes, dtype))
                names.append(f"BasicBlock_{n}")
                n, cin = n + 1, planes
            self.stages.append(names)

    def _stage(self, x, i, train):
        for name in self.stages[i]:
            x = getattr(self, name)(x, train)
        return x

    def forward(self, x, train: bool = False):
        x = F.relu(self.ConvBN_0(x, train))
        x = F.relu(self.ConvBN_1(x, train))
        x = F.max_pool2d(x, 2, 2)
        x = F.relu(self.ConvBN_2(self._stage(x, 0, train), train))
        x = F.max_pool2d(x, 2, 2)
        x = F.relu(self.ConvBN_3(self._stage(x, 1, train), train))
        x = F.max_pool2d(x, kernel_size=2, stride=(2, 1), padding=(0, 1))
        x = F.relu(self.ConvBN_4(self._stage(x, 2, train), train))
        x = self._stage(x, 3, train)
        x = F.relu(self.ConvBN_5(x, train))
        return F.relu(self.ConvBN_6(x, train))


class ResNetFeatureExtractor(nn.Module):
    """Wrapper kept so module paths match the flax variables."""

    def __init__(self, input_channel: int = 1, output_channel: int = 512,
                 dtype: torch.dtype = torch.float32):
        super().__init__()
        self.FANResNet_0 = FANResNet(input_channel, output_channel, dtype=dtype)

    def forward(self, x, train: bool = False):
        return self.FANResNet_0(x, train)
