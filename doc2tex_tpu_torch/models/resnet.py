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

``gcb`` appends a global-context block (``GCB``) to each of the four
stages, as the JAX module does.
"""

from __future__ import annotations

import torch
import torch.nn as nn
import torch.nn.functional as F

from ..ops import quant
from ..parallel.mesh import all_reduce_sum, data_size
from .layers import Dense, LayerNorm


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


def same_padding(size: int, kernel: int, stride: int, dilation: int = 1) -> tuple[int, int]:
    """flax's ``padding="SAME"`` on one axis: (low, high), the extra one
    at the high end."""
    span = dilation * (kernel - 1) + 1
    total = max((-(-size // stride) - 1) * stride + span - size, 0)
    return total // 2, total - total // 2


class Conv(nn.Module):
    """flax ``nn.Conv`` on NCHW input; ``kernel`` is OIHW.  ``padding`` is
    (ph, pw) on both sides, or ``"SAME"`` (flax's, from the input's size);
    ``groups`` is flax's ``feature_group_count``, ``dilation`` its
    ``kernel_dilation``.

    With ``int8`` set (the encoder under ``quantize: int8``) and the shape
    gates of ``ops/quant.py`` passed, the convolution runs through the int8
    op instead.  ``quantizable=False`` marks a layer that the JAX package
    never routes there (its ``nn.Conv`` has no ``maybe_conv_general``)."""

    def __init__(self, cin: int, cout: int, kernel=(3, 3), stride=(1, 1),
                 padding=(1, 1), bias: bool = False, dtype: torch.dtype = torch.float32,
                 groups: int = 1, dilation=(1, 1), quantizable: bool = True):
        super().__init__()
        self.stride, self.dtype = tuple(stride), dtype
        self.padding = padding if padding == "SAME" else tuple(padding)
        self.groups, self.dilation, self.quantizable = groups, tuple(dilation), quantizable
        self.int8 = False
        self._int8_kernel = None
        self.kernel = nn.Parameter(torch.empty(cout, cin // groups, *kernel))
        self.bias = nn.Parameter(torch.zeros(cout)) if bias else None
        nn.init.kaiming_normal_(self.kernel, mode="fan_out")

    def takes_int8(self) -> bool:
        cout, cin, kh, kw = self.kernel.shape
        return self.int8 and self.quantizable and quant.gated(cin * kh * kw, cout)

    def forward(self, x):
        padding = self.padding
        if padding == "SAME":
            (kh, kw), (sh, sw), (dh, dw) = self.kernel.shape[2:], self.stride, self.dilation
            (t, b), (l, r) = (same_padding(x.shape[2], kh, sh, dh),
                              same_padding(x.shape[3], kw, sw, dw))
            x, padding = F.pad(x, (l, r, t, b)), (0, 0)
        if self.takes_int8():
            w_q, w_scale = quant.layer_weight(self, quant.quantize_conv_weight)
            return quant.int8_conv2d(x, w_q, w_scale, self.bias, tuple(self.kernel.shape[2:]),
                                     self.stride, padding, self.dtype, self.dilation)
        kernel = self.kernel.to(self.dtype)
        args = (self.stride, padding, self.dilation, self.groups)
        if self.dtype == torch.float32 or self.bias is None:
            return F.conv2d(x.to(self.dtype), kernel, self.bias, *args)
        # in a narrower type the bias is added after the convolution's output
        # is rounded to it, as flax does (a bias fused into the convolution
        # would round once, and give other values)
        y = F.conv2d(x.to(self.dtype), kernel, None, *args)
        return y + self.bias.to(self.dtype).view(1, -1, 1, 1)


def max_pool(x, kernel, stride, padding="VALID"):
    """flax ``nn.max_pool`` on NCHW input: ``padding`` "VALID", "SAME" or
    ((top, bottom), (left, right)); the padding is -inf, as flax's."""
    if padding == "VALID":
        return F.max_pool2d(x, kernel, stride)
    if padding == "SAME":
        padding = (same_padding(x.shape[2], kernel[0], stride[0]),
                   same_padding(x.shape[3], kernel[1], stride[1]))
    (t, b), (l, r) = padding
    x = F.pad(x, (l, r, t, b), value=float("-inf"))
    return F.max_pool2d(x, kernel, stride)


class BatchNorm(nn.Module):
    """flax ``nn.BatchNorm(momentum=0.9, epsilon=1e-5)`` over the channel
    axis of NCHW input (``momentum`` may be given: flax's default is 0.99).

    ``train=False`` normalizes with the running statistics.  ``train=True``
    follows flax, not ``F.batch_norm(training=True)``: the batch statistics
    are ``E[x]`` and the BIASED ``max(E[x^2] - E[x]^2, 0)`` in float32 (or
    the input's type where it is wider, as flax computes them), both
    used to normalize and folded into the running statistics as
    ``0.9 * running + 0.1 * batch`` (torch would fold the unbiased variance,
    at momentum 0.1 of the other side).  One rounding to the input's type
    at the end, as in eval.  Under an active mesh the statistics are the
    global batch's, as JAX's over a sharded batch: the sums of x and x^2
    are summed over the data ranks (and their gradients summed back)."""

    def __init__(self, channels: int, eps: float = 1e-5, momentum: float = 0.9):
        super().__init__()
        self.eps, self.momentum = eps, momentum
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
        nd = data_size()
        if nd == 1:
            mean = x32.mean(dim=(0, 2, 3))
            sq = (x32 * x32).mean(dim=(0, 2, 3))
        else:
            n = nd * x32.shape[0] * x32.shape[2] * x32.shape[3]
            sums = all_reduce_sum(torch.stack([x32.sum(dim=(0, 2, 3)),
                                               (x32 * x32).sum(dim=(0, 2, 3))]))
            mean, sq = sums[0] / n, sums[1] / n
        var = torch.clamp(sq - mean * mean, min=0.0)
        with torch.no_grad():
            m = self.momentum
            self.mean.copy_(m * self.mean + (1 - m) * mean)
            self.var.copy_(m * self.var + (1 - m) * var)
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


class GCB(nn.Module):
    """GCNet-style global context (``doc2tex_tpu.models.resnet.GCB``): a
    1x1 conv's softmax (float32, over H*W) pools the map into one context
    vector, a Dense -> LayerNorm -> relu -> Dense bottleneck transforms it,
    and it is added at every position.  The bottleneck's hidden width is C,
    not C / 8: the reference's ConvMLP ignores its ratio, and the weights
    follow it.  None of its layers takes the int8 op."""

    def __init__(self, channels: int, dtype: torch.dtype):
        super().__init__()
        self.Conv_0 = Conv(channels, 1, (1, 1), padding=(0, 0), bias=True, dtype=dtype,
                           quantizable=False)
        self.Dense_0 = Dense(channels, channels, dtype=dtype, quantizable=False)
        self.LayerNorm_0 = LayerNorm(channels, 1e-5)
        self.Dense_1 = Dense(channels, channels, dtype=dtype, quantizable=False)

    def forward(self, x, train: bool = False):
        B, C, H, W = x.shape
        mask = torch.softmax(self.Conv_0(x).reshape(B, H * W).float(), dim=1).to(x.dtype)
        context = torch.einsum("bcn,bn->bc", x.reshape(B, C, H * W), mask)
        t = self.Dense_1(F.relu(self.LayerNorm_0(self.Dense_0(context))))
        return x + t.to(x.dtype).reshape(B, C, 1, 1)


class FANResNet(nn.Module):
    def __init__(self, input_channel: int = 1, output_channel: int = 512,
                 layers=(1, 2, 5, 3), dtype: torch.dtype = torch.float32, gcb: bool = False):
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
            if gcb:
                names.append(f"GCB_{len(self.stages)}")
                self.add_module(names[-1], GCB(planes, dtype))
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
                 dtype: torch.dtype = torch.float32, gcb: bool = False):
        super().__init__()
        self.FANResNet_0 = FANResNet(input_channel, output_channel, dtype=dtype, gcb=gcb)

    def forward(self, x, train: bool = False):
        return self.FANResNet_0(x, train)
