"""Coverage-attention LSTM decoder head (counterpart of
``doc2tex_tpu.models.decoder_lstm``: ``DecoderState``, ``_lstm_cell``,
``LSTMAttentionDecoder.init_state`` and ``.step``).

The Attn / Attnv2 heads.  Parameters are flat and keep the flax names and
layouts (Dense kernels ``(in, out)``, applied as ``x @ W``; ``loc_conv_w``
``(k, 1, Kd)`` width-in-out), so the release msgpack loads leaf for leaf.

Decode, as in the JAX package:

- ``init_state`` repeats every leaf to B*K rows (``repeat_interleave``,
  the row order of ``jnp.repeat``: row b*K + j is beam j of sample b),
  the attention memory included; ``enc_proj = enc @ w_key + b_key`` is
  computed once and kept, like ``enc``, in the compute type;
- ``step``: the location conv over the coverage (``alpha_cum``) or the
  last alignment (``alpha_prev``) -> the coverage-attention step
  (``ops.attention_step.fused_attention_step``: the CUDA kernel on the
  card, where the JAX step inlines the same math) -> LSTM cell (gate order
  i, f, g, o) -> generator.  The carry, scores and logits are float32.

Not ported (they raise): the ``bahdanau`` and ``luong`` attention types, the
int8 attention memory, and the teacher-forced ``__call__``.
"""

from __future__ import annotations

from typing import NamedTuple

import torch
import torch.nn as nn
import torch.nn.functional as F

from ..ops.attention_step import fused_attention_step


class DecoderState(NamedTuple):
    """Per-row decode state (leading dim B, or B*K under beam search)."""

    h: torch.Tensor           # (B, H) f32
    c: torch.Tensor           # (B, H) f32
    alpha_cum: torch.Tensor   # (B, S) f32: coverage, the sum of past alignments
    alpha_prev: torch.Tensor  # (B, S) f32: the last alignment
    enc: torch.Tensor         # (B, S, D) compute type: attention values
    enc_proj: torch.Tensor    # (B, S, H) compute type: precomputed keys
    enc_scale: torch.Tensor   # (0,) placeholder of the int8 memory's scale
    proj_scale: torch.Tensor  # (0,) placeholder


def _lstm_cell(x, h, c, w_ih, b_ih, w_hh, b_hh):
    """torch.nn.LSTMCell math on ``(in, 4H)`` kernels (gate order i, f, g, o)."""
    gates = (x @ w_ih + b_ih + h @ w_hh + b_hh).float()
    i, f, g, o = gates.chunk(4, dim=-1)
    c_new = torch.sigmoid(f) * c + torch.sigmoid(i) * torch.tanh(g)
    h_new = torch.sigmoid(o) * torch.tanh(c_new)
    return h_new, c_new


class LSTMAttentionDecoder(nn.Module):
    def __init__(self, num_classes: int, input_size: int = 256, hidden_size: int = 256,
                 embed_dim: int | None = None, kernel_size: int = 2, kernel_dim: int = 128,
                 attn_type: str = "coverage", embed_target: bool = True,
                 enc_init: bool = True, seqmodel: str = "TFM", v2: bool = True,
                 dtype: torch.dtype = torch.float32):
        super().__init__()
        if attn_type not in ("coverage", "loc_aware"):
            raise NotImplementedError(f"attn_type {attn_type!r} is not ported yet")
        if not embed_target:
            raise NotImplementedError("the one-hot (embed_target False) input is not ported yet")
        H, D, V = hidden_size, input_size, num_classes
        E = embed_dim or input_size
        self.hidden_size, self.kernel_size = hidden_size, kernel_size
        self.attn_type, self.enc_init = attn_type, enc_init
        self.seqmodel, self.v2 = seqmodel, v2
        self.dtype = dtype
        k = 2 * kernel_size + 1
        shapes = {
            "embedding": (V, E), "w_key": (D, H), "b_key": (H,), "w_query": (H, H),
            "b_query": (H,), "w_score": (H, 1), "b_score": (1,),
            "loc_conv_w": (k, 1, kernel_dim), "loc_conv_b": (kernel_dim,),
            "w_loc": (kernel_dim, H), "b_loc": (H,),
            "w_ih": (D + E, 4 * H), "b_ih": (4 * H,), "w_hh": (H, 4 * H), "b_hh": (4 * H,),
            "w_gen": (H, V), "b_gen": (V,),
        }
        if enc_init:
            shapes.update(w_init_h=(D, H), b_init_h=(H,), w_init_c=(D, H), b_init_c=(H,))
        for name, shape in shapes.items():
            p = nn.Parameter(torch.zeros(shape))
            if len(shape) >= 2:
                nn.init.trunc_normal_(p, std=0.02)
            self.register_parameter(name, p)

    def _split_enc(self, batch_h):
        """AttentionV2 cls split: attend over positions 1.., init from 0."""
        if self.v2 and self.seqmodel == "TFM":
            return batch_h[:, 1:, :], batch_h[:, 0, :]
        if self.seqmodel in ("BiLSTM", "VIG"):
            return batch_h, batch_h.mean(dim=1)
        return batch_h, batch_h[:, 0, :]

    def _embed(self, tokens):
        """Embedding with padding_idx = [GO] = 0: token 0 embeds to zeros."""
        return self.embedding[tokens] * (tokens != 0)[..., None]

    def init_state(self, batch_h, beam_size: int = 1) -> DecoderState:
        if beam_size > 1:
            batch_h = batch_h.repeat_interleave(beam_size, dim=0)
        enc, init_emb = self._split_enc(batch_h.to(self.dtype))
        enc = enc.contiguous()
        init_emb = init_emb.float()
        B, S, _ = enc.shape
        if self.enc_init:
            h = init_emb @ self.w_init_h + self.b_init_h
            c = init_emb @ self.w_init_c + self.b_init_c
        else:
            h = torch.zeros(B, self.hidden_size, device=enc.device)
            c = torch.zeros_like(h)
        enc_proj = (enc @ self.w_key.to(self.dtype) + self.b_key).to(self.dtype)
        zeros = torch.zeros(B, S, device=enc.device)
        placeholder = torch.zeros(0, device=enc.device)
        return DecoderState(h, c, zeros, zeros, enc, enc_proj, placeholder, placeholder)

    def _location(self, mem):
        """Location features (B, S, Kd) f32: the cross-correlation of the
        attention memory (B, S) with ``loc_conv_w`` (k, 1, Kd), zero-padded
        by ``kernel_size`` on each side, plus ``loc_conv_b``: the JAX
        package's ``conv_general_dilated`` (NWC, WIO).  Written as windows
        times the (k, Kd) kernel, so the result is already (B, S, Kd)."""
        k = 2 * self.kernel_size + 1
        windows = F.pad(mem, (self.kernel_size, self.kernel_size)).unfold(-1, k, 1)
        return windows @ self.loc_conv_w[:, 0, :] + self.loc_conv_b

    def step(self, state: DecoderState, tokens) -> tuple[DecoderState, torch.Tensor]:
        """One decode step: tokens (B,) -> (new state, logits (B, V) f32)."""
        if state.enc_proj.dtype == torch.int8:
            raise NotImplementedError("the int8 attention memory is not ported yet")
        emb = self._embed(tokens)
        mem = state.alpha_cum if self.attn_type == "coverage" else state.alpha_prev
        loc_feat = self._location(mem)
        q = state.h @ self.w_query + self.b_query
        # the JAX step adds b_score to every score before the softmax, which
        # does not change alpha, so the kernel is not given it
        context, alpha = fused_attention_step(
            state.enc, state.enc_proj, q, loc_feat, self.w_loc, self.b_loc, self.w_score)
        x = torch.cat([context, emb], dim=-1)
        h_new, c_new = _lstm_cell(x, state.h, state.c, self.w_ih, self.b_ih,
                                  self.w_hh, self.b_hh)
        logits = h_new @ self.w_gen + self.b_gen
        new_state = state._replace(h=h_new, c=c_new, alpha_cum=state.alpha_cum + alpha,
                                   alpha_prev=alpha)
        return new_state, logits

    def forward(self, batch_h, text):
        raise NotImplementedError("the teacher-forced pass (training) is not ported yet")
