"""CRNN-style VGG feature extractor (counterpart of
``doc2tex_tpu.models.vgg``), on NCHW input:

  conv3-C/8 / pool 2 / conv3-C/4 / pool 2 / conv3-C/2 x2 / pool (2,1) /
  conv3-C +BN x2 / pool (2,1) / conv2-C (valid)

Output size for (H, W): (H // 16 - 1, W // 4 - 1).  The convolutions
without BatchNorm carry a bias; none takes the int8 op (the JAX module's
convolutions have no ``maybe_conv_general``).
"""

from __future__ import annotations

import torch
import torch.nn as nn
import torch.nn.functional as F

from .resnet import BatchNorm, Conv


def vgg_feature_hw(h: int, w: int) -> tuple[int, int]:
    """Static output-shape math of ``VGGFeatureExtractor``."""
    return h // 16 - 1, w // 4 - 1


class VGGFeatureExtractor(nn.Module):
    def __init__(self, input_channel: int = 1, output_channel: int = 512,
                 dtype: torch.dtype = torch.float32):
        super().__init__()
        oc = [output_channel // 8, output_channel // 4, output_channel // 2, output_channel]
        # (cin, cout, kernel, padding, BatchNorm) in the JAX module's order
        spec = [(input_channel, oc[0], 3, 1, False), (oc[0], oc[1], 3, 1, False),
                (oc[1], oc[2], 3, 1, False), (oc[2], oc[2], 3, 1, False),
                (oc[2], oc[3], 3, 1, True), (oc[3], oc[3], 3, 1, True),
                (oc[3], oc[3], 2, 0, False)]
        self.bn = []
        n_bn = 0
        for i, (cin, cout, k, p, bn) in enumerate(spec):
            self.add_module(f"Conv_{i}", Conv(cin, cout, (k, k), padding=(p, p), bias=not bn,
                                              dtype=dtype, quantizable=False))
            if bn:
                self.add_module(f"BatchNorm_{n_bn}", BatchNorm(cout))
                n_bn += 1
            self.bn.append(f"BatchNorm_{n_bn - 1}" if bn else None)

    def _conv(self, x, i, train):
        x = getattr(self, f"Conv_{i}")(x)
        if self.bn[i]:
            x = getattr(self, self.bn[i])(x, train)
        return F.relu(x)

    def forward(self, x, train: bool = False):
        x = F.max_pool2d(self._conv(x, 0, train), 2, 2)
        x = F.max_pool2d(self._conv(x, 1, train), 2, 2)
        x = self._conv(self._conv(x, 2, train), 3, train)
        x = F.max_pool2d(x, (2, 1), (2, 1))
        x = self._conv(self._conv(x, 4, train), 5, train)
        x = F.max_pool2d(x, (2, 1), (2, 1))
        return self._conv(x, 6, train)
