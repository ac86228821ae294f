"""SSD512 math detector (counterpart of ``doc2tex_tpu.detection.ssd``).

VGG16 base (ceil-mode pool at stage 3, pool5 3x3 stride 1, dilated conv6
and 1x1 conv7), L2Norm (scale 20) on conv4_3, the stride-2 extra layers and
(1, 5)-kernel loc/conf heads over 7 source maps.  NCHW inside; the heads'
outputs are flattened in NHWC order, as flax flattens them, so loc/conf
line up index for index with ``priors.make_priors``.

The convolutions are named as flax names them (``Conv_0`` ... ``Conv_38``
in creation order, ``L2Norm_0``), so ``weights.load_weights`` reads the
released detector (``saved_models/math_detect``) into this module.  They
are cuDNN calls on the card: the JAX package computes them with XLA, not a
Pallas kernel.

``set_quantize`` takes the detector's ``quantize`` modes, as the JAX
package's ``MathDetector`` applies them: ``bf16`` computes every
convolution in bfloat16 (input, kernel and bias cast, the bias added after
the output is rounded, as flax does) while the parameters stay float32;
``L2Norm`` squares in float32 and its output is float32.  ``int8`` keeps
float32 and sends each convolution that passes the shape gates of
``ops/quant.py`` through the int8 op (conv6's dilation included): the
512-channel trunk, conv6/conv7 and the extras; the heads stay float32.
"""

from __future__ import annotations

import torch
import torch.nn as nn
import torch.nn.functional as F

from ..ops import quant
from .priors import MATH_GTDB_512


class Conv2d(nn.Module):
    """flax ``nn.Conv`` with bias on NCHW input; ``kernel`` is OIHW.  It
    computes in ``dtype``, or, with ``int8`` set and the shape gates
    passed, through the int8 op."""

    def __init__(self, cin: int, cout: int, kernel=(3, 3), stride: int = 1,
                 padding=(1, 1), dilation: int = 1):
        super().__init__()
        self.stride, self.padding, self.dilation = stride, tuple(padding), dilation
        self.dtype = torch.float32
        self.int8 = False
        self._int8_kernel = None
        self.kernel = nn.Parameter(torch.empty(cout, cin, *kernel))
        self.bias = nn.Parameter(torch.zeros(cout))
        nn.init.kaiming_normal_(self.kernel, mode="fan_in")

    def takes_int8(self) -> bool:
        cout, cin, kh, kw = self.kernel.shape
        return self.int8 and quant.gated(cin * kh * kw, cout)

    def forward(self, x):
        if self.takes_int8():
            w_q, w_scale = quant.layer_weight(self, quant.quantize_conv_weight)
            return quant.int8_conv2d(x, w_q, w_scale, self.bias, tuple(self.kernel.shape[2:]),
                                     (self.stride,) * 2, self.padding, self.dtype,
                                     (self.dilation,) * 2)
        if self.dtype == torch.float32:
            return F.conv2d(x, self.kernel, self.bias, self.stride, self.padding, self.dilation)
        # in a narrower type the bias is added after the output is rounded
        y = F.conv2d(x.to(self.dtype), self.kernel.to(self.dtype), None, self.stride,
                     self.padding, self.dilation)
        return y + self.bias.to(self.dtype).view(1, -1, 1, 1)


class L2Norm(nn.Module):
    """Channel L2 normalization with a learned scale: the norm in float32
    over the channels, plus 1e-10 after the square root."""

    def __init__(self, channels: int, scale: float = 20.0):
        super().__init__()
        self.weight = nn.Parameter(torch.full((channels,), scale))

    def forward(self, x):
        norm = x.float().square().sum(1, keepdim=True).sqrt() + 1e-10
        return x / norm * self.weight.view(1, -1, 1, 1)


def _pool(x, ceil: bool = False):
    """2x2 stride-2 max pool; ``ceil`` pads an odd side with -inf first."""
    if ceil:
        ph, pw = x.shape[2] % 2, x.shape[3] % 2
        if ph or pw:
            x = F.pad(x, (0, pw, 0, ph), value=float("-inf"))
    return F.max_pool2d(x, 2, 2)


# (cin, cout) of the VGG trunk's 3x3 convolutions, Conv_0 ... Conv_12
_TRUNK = [
    (3, 64), (64, 64), (64, 128), (128, 128),                 # stages 1, 2
    (128, 256), (256, 256), (256, 256),                       # stage 3
    (256, 512), (512, 512), (512, 512),                       # stage 4 -> conv4_3
    (512, 512), (512, 512), (512, 512),                       # stage 5
]
_POOL_AFTER = {1: False, 3: False, 6: True, 9: False}         # conv index -> ceil mode
# extras: (1x1 reduce, 3x3 stride 2) pairs -> 16, 8, 4, 2, then 1x1 + 4x4 pad 1 -> 1
_EXTRAS = [(1024, 256), (256, 512), (512, 128), (128, 256), (256, 128), (128, 256),
           (256, 128), (128, 256)]
_SOURCE_CHANNELS = [512, 1024, 512, 256, 256, 256, 256]


class SSD512(nn.Module):
    """SSD512 over 512x512 windows: float32 (B, 3, 512, 512) ->
    (loc (B, N, 4), conf (B, N, num_classes)), N = 65,532, in the compute
    type (bfloat16 under ``set_quantize("bf16")``)."""

    def __init__(self, num_classes: int = 2, head_kernel: tuple[int, int] = (1, 5)):
        super().__init__()
        self.num_classes = num_classes
        convs = [Conv2d(cin, cout) for cin, cout in _TRUNK]
        convs.append(Conv2d(512, 1024, padding=(6, 6), dilation=6))       # conv6
        convs.append(Conv2d(1024, 1024, (1, 1), padding=(0, 0)))          # conv7
        for k, (cin, cout) in enumerate(_EXTRAS):
            if k % 2 == 0:
                convs.append(Conv2d(cin, cout, (1, 1), padding=(0, 0)))
            else:
                convs.append(Conv2d(cin, cout, stride=2))
        convs.append(Conv2d(256, 128, (1, 1), padding=(0, 0)))
        convs.append(Conv2d(128, 256, (4, 4)))
        kh, kw = head_kernel
        for cin, nb in zip(_SOURCE_CHANNELS, MATH_GTDB_512["mbox"]):
            convs.append(Conv2d(cin, nb * 4, head_kernel, padding=(kh // 2, kw // 2)))
            convs.append(Conv2d(cin, nb * num_classes, head_kernel, padding=(kh // 2, kw // 2)))
        self.n_convs = len(convs)
        for i, conv in enumerate(convs):
            self.add_module(f"Conv_{i}", conv)
        self.L2Norm_0 = L2Norm(512)

    def conv(self, i: int) -> Conv2d:
        return getattr(self, f"Conv_{i}")

    def set_quantize(self, quantize) -> list[str]:
        """None, ``bf16`` or ``int8`` (see the module docstring); returns
        the names of the convolutions that take the int8 op."""
        if quantize not in (None, "bf16", "int8"):
            raise ValueError(f"detection quantize must be None, 'bf16' or 'int8'; got "
                             f"{quantize!r}")
        names = []
        for i in range(self.n_convs):
            conv = self.conv(i)
            conv.dtype = torch.bfloat16 if quantize == "bf16" else torch.float32
            conv.int8 = quantize == "int8"
            if conv.takes_int8():
                names.append(f"Conv_{i}")
        return names

    def forward(self, x):
        for i in range(len(_TRUNK)):
            x = F.relu(self.conv(i)(x))
            if i == 9:
                conv4_3 = x
            if i in _POOL_AFTER:
                x = _pool(x, _POOL_AFTER[i])
        x = F.max_pool2d(x, 3, 1, padding=1)                              # pool5
        x = F.relu(self.conv(13)(x))
        x = F.relu(self.conv(14)(x))
        sources = [self.L2Norm_0(conv4_3), x]
        for i in range(15, 25, 2):                                        # the extras
            x = F.relu(self.conv(i + 1)(F.relu(self.conv(i)(x))))
            sources.append(x)
        locs, confs = [], []
        B = x.shape[0]
        for k, src in enumerate(sources):
            # NCHW -> NHWC before the flatten, as flax's outputs are laid out
            locs.append(self.conv(25 + 2 * k)(src).permute(0, 2, 3, 1).reshape(B, -1, 4))
            confs.append(self.conv(26 + 2 * k)(src).permute(0, 2, 3, 1)
                         .reshape(B, -1, self.num_classes))
        return torch.cat(locs, 1), torch.cat(confs, 1)
