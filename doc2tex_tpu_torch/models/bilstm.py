"""Bidirectional LSTM sequence modeling (counterpart of
``doc2tex_tpu.models.bilstm``): n stacked (BiLSTM -> Dense) layers over the
width axis of a height-collapsed CNN map, with the optional 1D sin-cos
position table blended in by a ``GatedSum``.

The recurrence is a Python loop over the port's own cell (gate order i, f,
g, o, as ``torch.nn.LSTM``), float32 whatever the compute type, as the JAX
scan's carries and products are.  Both directions step together: the
forward direction at t and the backward one at T - 1 - t in one batched
product, the backward's outputs written back in place (JAX's reversed scan
over the whole padded width).  The input products ``x @ w_ih + b_ih`` of
every step are one product ahead of the loop.
"""

from __future__ import annotations

import torch
import torch.nn as nn

from .layers import Dense, GatedSum, posenc_1d

_GATES = ("w_ih", "b_ih", "w_hh", "b_hh")


class BidirectionalLSTM(nn.Module):
    """(B, T, I) -> (B, T, output_size) float32; flat parameters
    ``{fwd,bwd}_{w_ih,b_ih,w_hh,b_hh}`` with ``(in, 4H)`` kernels."""

    def __init__(self, input_size: int, hidden_size: int, output_size: int):
        super().__init__()
        H = hidden_size
        for d in ("fwd", "bwd"):
            for name, shape in zip(_GATES, ((input_size, 4 * H), (4 * H,), (H, 4 * H), (4 * H,))):
                p = nn.Parameter(torch.zeros(shape))
                if len(shape) == 2:
                    nn.init.trunc_normal_(p, std=0.02)
                self.register_parameter(f"{d}_{name}", p)
        self.Dense_0 = Dense(2 * H, output_size, quantizable=False)

    def forward(self, x):
        B, T, _ = x.shape
        H = self.fwd_w_hh.shape[0]
        x = x.float()
        w = {n: torch.stack([getattr(self, f"fwd_{n}"), getattr(self, f"bwd_{n}")])
             for n in _GATES}
        # (2, T, B, 4H): the input products of both directions, every step
        gx = torch.einsum("bti,dig->dtbg", x, w["w_ih"]) + w["b_ih"][:, None, None, :]
        h = x.new_zeros(2, B, H)
        c = x.new_zeros(2, B, H)
        hs = x.new_empty(2, T, B, H)
        idx = torch.tensor([0, 1], device=x.device)
        for t in range(T):
            steps = torch.tensor([t, T - 1 - t], device=x.device)
            gates = gx[idx, steps] + torch.bmm(h, w["w_hh"]) + w["b_hh"][:, None, :]
            i, f, g, o = gates.chunk(4, dim=-1)
            c = torch.sigmoid(f) * c + torch.sigmoid(i) * torch.tanh(g)
            h = torch.sigmoid(o) * torch.tanh(c)
            hs[0, t], hs[1, T - 1 - t] = h[0], h[1]
        out = torch.cat([hs[0], hs[1]], dim=-1).transpose(0, 1)   # (B, T, 2H)
        return self.Dense_0(out)


class BiLSTMSeqModeling(nn.Module):
    """``num_layers`` stacked ``BidirectionalLSTM`` layers; with
    ``use_pos_enc`` the stage's input plus the 1D table (projected by a
    Dense where the widths differ) is blended with the output by a
    ``GatedSum``."""

    def __init__(self, input_size: int, hidden_size: int = 256, output_size: int = 256,
                 num_layers: int = 2, use_pos_enc: bool = False):
        super().__init__()
        self.num_layers, self.use_pos_enc = num_layers, use_pos_enc
        for i in range(num_layers):
            self.add_module(f"BidirectionalLSTM_{i}", BidirectionalLSTM(
                input_size if i == 0 else output_size, hidden_size, output_size))
        if use_pos_enc:
            if input_size != output_size:
                self.Dense_0 = Dense(input_size, output_size, quantizable=False)
            self.GatedSum_0 = GatedSum(output_size)

    def forward(self, x):
        inp = x
        for i in range(self.num_layers):
            x = getattr(self, f"BidirectionalLSTM_{i}")(x)
        if self.use_pos_enc:
            T, C = inp.shape[1:]
            pos_feat = inp + posenc_1d(T, C).to(inp.device, inp.dtype)[None]
            if hasattr(self, "Dense_0"):
                pos_feat = self.Dense_0(pos_feat)
            x = self.GatedSum_0(pos_feat, x)
        return x
