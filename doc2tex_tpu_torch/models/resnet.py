"""FAN-style ResNet feature extractor (counterpart of
``doc2tex_tpu.models.resnet``).

BasicBlock x [1, 2, 5, 3] with asymmetric pooling so the feature map keeps
horizontal resolution:

  stem conv0_1/conv0_2 -> maxpool(2,2) -> layer1 -> conv1
  -> maxpool(2,2) -> layer2 -> conv2
  -> maxpool(k2, s(2,1), p(0,1)) -> layer3 -> conv3
  -> layer4 -> conv4_1(k2, s(2,1), p(0,1)) -> conv4_2(k2, s1, p0)

Inside, the port runs NCHW convolutions (PyTorch's layout); kernels are
stored OIHW (``weights.py`` converts flax's HWIO).  BatchNorm runs with its
running statistics (inference only) in float32 and returns the compute
type, as flax's BatchNorm does.
"""

from __future__ import annotations

import torch
import torch.nn as nn
import torch.nn.functional as F


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
    """flax ``nn.Conv`` on NCHW input; ``kernel`` is OIHW."""

    def __init__(self, cin: int, cout: int, kernel=(3, 3), stride=(1, 1),
                 padding=(1, 1), bias: bool = False, dtype: torch.dtype = torch.float32):
        super().__init__()
        self.stride, self.padding, self.dtype = stride, padding, dtype
        self.kernel = nn.Parameter(torch.empty(cout, cin, *kernel))
        self.bias = nn.Parameter(torch.zeros(cout)) if bias else None
        nn.init.kaiming_normal_(self.kernel, mode="fan_out")

    def forward(self, x):
        kernel = self.kernel.to(self.dtype)
        if self.dtype == torch.float32 or self.bias is None:
            return F.conv2d(x.to(self.dtype), kernel, self.bias, self.stride, self.padding)
        # in a narrower type the bias is added after the convolution's output
        # is rounded to it, as flax does (a bias fused into the convolution
        # would round once, and give other values)
        y = F.conv2d(x.to(self.dtype), kernel, None, self.stride, self.padding)
        return y + self.bias.to(self.dtype).view(1, -1, 1, 1)


class BatchNorm(nn.Module):
    """flax ``nn.BatchNorm(use_running_average=True, epsilon=1e-5)`` over
    the channel axis of NCHW input."""

    def __init__(self, channels: int, eps: float = 1e-5):
        super().__init__()
        self.eps = eps
        self.scale = nn.Parameter(torch.ones(channels))
        self.bias = nn.Parameter(torch.zeros(channels))
        self.register_buffer("mean", torch.zeros(channels))
        self.register_buffer("var", torch.ones(channels))

    def forward(self, x):
        # float32 arithmetic and one rounding to the input's type at the
        # end, in one pass: flax subtracts the float32 running mean from the
        # input, which promotes it, and casts the result to the module's type
        return F.batch_norm(x, self.mean, self.var, self.scale, self.bias,
                            training=False, eps=self.eps)


class ConvBN(nn.Module):
    def __init__(self, cin, cout, kernel=(3, 3), stride=(1, 1), padding=(1, 1),
                 dtype=torch.float32):
        super().__init__()
        self.Conv_0 = Conv(cin, cout, kernel, stride, padding, dtype=dtype)
        self.BatchNorm_0 = BatchNorm(cout)

    def forward(self, x):
        return self.BatchNorm_0(self.Conv_0(x))


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

    def forward(self, x):
        out = self.ConvBN_1(F.relu(self.ConvBN_0(x)))
        residual = self.BatchNorm_0(self.Conv_0(x)) if self.downsample else x.to(out.dtype)
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

    def _stage(self, x, i):
        for name in self.stages[i]:
            x = getattr(self, name)(x)
        return x

    def forward(self, x):
        x = F.relu(self.ConvBN_0(x))
        x = F.relu(self.ConvBN_1(x))
        x = F.max_pool2d(x, 2, 2)
        x = F.relu(self.ConvBN_2(self._stage(x, 0)))
        x = F.max_pool2d(x, 2, 2)
        x = F.relu(self.ConvBN_3(self._stage(x, 1)))
        x = F.max_pool2d(x, kernel_size=2, stride=(2, 1), padding=(0, 1))
        x = F.relu(self.ConvBN_4(self._stage(x, 2)))
        x = self._stage(x, 3)
        x = F.relu(self.ConvBN_5(x))
        return F.relu(self.ConvBN_6(x))


class ResNetFeatureExtractor(nn.Module):
    """Wrapper kept so module paths match the flax variables."""

    def __init__(self, input_channel: int = 1, output_channel: int = 512,
                 dtype: torch.dtype = torch.float32):
        super().__init__()
        self.FANResNet_0 = FANResNet(input_channel, output_channel, dtype=dtype)

    def forward(self, x):
        return self.FANResNet_0(x)
