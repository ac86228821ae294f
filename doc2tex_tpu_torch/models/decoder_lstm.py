"""Coverage-attention LSTM decoder head (counterpart of
``doc2tex_tpu.models.decoder_lstm``: ``DecoderState``, ``_lstm_cell``,
``LSTMAttentionDecoder.init_state`` and ``.step``).

The Attn / Attnv2 heads.  Parameters are flat and keep the flax names and
layouts (Dense kernels ``(in, out)``, applied as ``x @ W``; ``loc_conv_w``
``(k, 1, Kd)`` width-in-out), so the release msgpack loads leaf for leaf.

Decode, as in the JAX package, with the rows of the attention memory cut:

- ``init_state`` keeps ``enc`` and ``enc_proj = enc @ w_key + b_key`` (in
  the compute type) at sample rows, computed once per sample; the carry and
  the coverage are repeated to B*K rows (``repeat_interleave``, the row
  order of ``jnp.repeat``: row b*K + j is beam j of sample b).  The JAX
  package repeats the memory too; its K rows of a sample are equal, and
  ``lstm_gather`` leaves the memory alone, so the step reads the same
  values;
- ``step``: the coverage-attention step with the location conv over the
  coverage (``alpha_cum``) or the last alignment (``alpha_prev``) folded in
  (``ops.attention_step.coverage_attention_step``: the CUDA kernel on the
  card; on the CPU its plain version, the conv, the memory repeated per
  beam and the step as the JAX package inlines them) -> LSTM cell (gate
  order i, f, g, o) -> generator.  The carry, scores and logits are
  float32.

Training: ``forward`` is the teacher-forced pass of the JAX ``__call__``:
``init_state`` at K = 1, ``step`` over the columns of ``text`` in a Python
loop (JAX's ``lax.scan``), the logits stacked to (B, T, V), and with
``train`` one dropout at ``droprate`` over the stacked logits.  On the card
the step's attention runs B2's kernel with its hand-written backward
(``ops.attention_step.CoverageAttentionStepFn``, or
``ContentAttentionStepFn`` for bahdanau); on the CPU autograd runs through
the plain version.

int8 attention memory (the ``decoder_mem`` part in ``quant_parts``, set by
``Model.set_quantize``): ``init_state`` quantizes ``enc`` and ``enc_proj``
with one scale per sample (``ops.quant.quantize_memory``; the JAX package
quantizes its beam-repeated rows, whose scales are the sample's), and
``step`` hands them with their scales to B2's int8 form, which dequantizes
``enc_proj`` in the compute type and scales the context after its sum, as
the JAX step does.  ``decoder_kv`` is ignored, as in JAX.

The attention types, as the JAX head's ``attn_type``:

- ``coverage`` / ``loc_aware``: the step above, the location conv over
  the coverage or the last alignment (B2's coverage form);
- ``bahdanau``: no location term, ``e = tanh(enc_proj + q) @ w_score``
  (B2's content form, ``ops.attention_step.content_attention_step``; its
  memory may be int8 too).  ``enc`` may be wider than H (D != H);
- ``luong`` (``method`` dot / general / concat): the LSTM steps first on
  the embedding alone, then scores the memory against the new h, in plain
  PyTorch as the JAX package computes it in XLA (no TPU kernel computes
  it); the generator reads ``tanh([context, h])``.  Its ``enc_proj`` is a
  zero-size placeholder and its memory is never int8.

``embed_target: False`` feeds the token one-hot (V wide) instead of an
embedding.  Every type trains on the card: the coverage and bahdanau heads
through B2's forward kernel and its backward kernel (``ops.attention_step``'s
``CoverageAttentionStepFn`` and ``ContentAttentionStepFn``, at every D and
H the forward takes), the luong head through autograd of its plain
PyTorch; on the CPU autograd runs the plain version of every type.
"""

from __future__ import annotations

from typing import NamedTuple

import torch
import torch.nn as nn
import torch.nn.functional as F

from ..ops.attention_step import content_attention_step, coverage_attention_step
from ..ops.quant import quantize_memory
from .layers import dropout


class DecoderState(NamedTuple):
    """Decode state: B*K rows under beam search (B rows greedy), the
    attention memory at the B sample rows."""

    h: torch.Tensor           # (B, H) f32
    c: torch.Tensor           # (B, H) f32
    alpha_cum: torch.Tensor   # (B, S) f32: coverage, the sum of past alignments
    alpha_prev: torch.Tensor  # (B, S) f32: the last alignment
    enc: torch.Tensor         # (B, S, D) compute type (or int8): attention values, per sample
    enc_proj: torch.Tensor    # (B, S, H) compute type (or int8): precomputed keys, per sample
    enc_scale: torch.Tensor   # (B, 1, 1) f32 scale of the int8 memory; (0,) when not int8
    proj_scale: torch.Tensor  # (B, 1, 1) f32; (0,) when not int8


def _lstm_cell(x, h, c, w_ih, b_ih, w_hh, b_hh):
    """torch.nn.LSTMCell math on ``(in, 4H)`` kernels (gate order i, f, g, o)."""
    gates = (x @ w_ih + b_ih + h @ w_hh + b_hh).float()
    i, f, g, o = gates.chunk(4, dim=-1)
    c_new = torch.sigmoid(f) * c + torch.sigmoid(i) * torch.tanh(g)
    h_new = torch.sigmoid(o) * torch.tanh(c_new)
    return h_new, c_new


ATTN_TYPES = ("coverage", "loc_aware", "bahdanau", "luong")
LUONG_METHODS = ("dot", "general", "concat")


class LSTMAttentionDecoder(nn.Module):
    def __init__(self, num_classes: int, input_size: int = 256, hidden_size: int = 256,
                 embed_dim: int | None = None, kernel_size: int = 2, kernel_dim: int = 128,
                 attn_type: str = "coverage", embed_target: bool = True,
                 enc_init: bool = True, seqmodel: str = "TFM", v2: bool = True,
                 droprate: float = 0.1, dtype: torch.dtype = torch.float32,
                 method: str = "dot"):
        super().__init__()
        if attn_type not in ATTN_TYPES:
            raise ValueError(f"attn_type must be one of {ATTN_TYPES}; got {attn_type!r}")
        if attn_type == "luong" and method not in LUONG_METHODS:
            raise ValueError(f"luong method must be one of {LUONG_METHODS}; got {method!r}")
        H, D, V = hidden_size, input_size, num_classes
        E = embed_dim or input_size
        self.num_classes = num_classes
        self.hidden_size, self.kernel_size = hidden_size, kernel_size
        self.attn_type, self.method, self.enc_init = attn_type, method, enc_init
        self.embed_target = embed_target
        self.seqmodel, self.v2 = seqmodel, v2
        self.droprate, self.dtype = droprate, dtype
        self.quant_parts: tuple = ()   # "decoder_mem" (Model.set_quantize)
        luong = attn_type == "luong"
        width = E if embed_target else V
        shapes = {"embedding": (V, E)} if embed_target else {}
        if enc_init:
            shapes.update(w_init_h=(D, H), b_init_h=(H,), w_init_c=(D, H), b_init_c=(H,))
        if luong:
            if method in ("general", "concat"):
                shapes["w_luong"] = (H, H)
            if method == "concat":
                shapes["v_luong"] = (H, 1)
        else:
            shapes.update(w_key=(D, H), b_key=(H,), w_query=(H, H), b_query=(H,),
                          w_score=(H, 1), b_score=(1,))
        if attn_type in ("coverage", "loc_aware"):
            shapes.update(loc_conv_w=(2 * kernel_size + 1, 1, kernel_dim),
                          loc_conv_b=(kernel_dim,), w_loc=(kernel_dim, H), b_loc=(H,))
        shapes.update(w_ih=(width if luong else D + width, 4 * H), b_ih=(4 * H,),
                      w_hh=(H, 4 * H), b_hh=(4 * H,), w_gen=(D + H if luong else H, V),
                      b_gen=(V,))
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
        """Embedding with padding_idx = [GO] = 0: token 0 embeds to zeros;
        without ``embed_target`` the float32 one-hot of the token."""
        if not self.embed_target:
            return F.one_hot(tokens.long(), self.num_classes).float()
        return self.embedding[tokens] * (tokens != 0)[..., None]

    def init_state(self, batch_h, beam_size: int = 1) -> DecoderState:
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
        if self.attn_type == "luong":    # luong reads no keys: a zero-size placeholder
            enc_proj = enc.new_zeros(B, 0, 0)
        else:
            enc_proj = (enc @ self.w_key.to(self.dtype) + self.b_key).to(self.dtype)
        K = max(beam_size, 1)
        if K > 1:
            h, c = h.repeat_interleave(K, dim=0), c.repeat_interleave(K, dim=0)
        zeros = torch.zeros(B * K, S, device=enc.device)
        if "decoder_mem" in self.quant_parts and self.attn_type != "luong":
            enc, enc_scale = quantize_memory(enc)
            enc_proj, proj_scale = quantize_memory(enc_proj)
        else:
            enc_scale = proj_scale = torch.zeros(0, device=enc.device)
        return DecoderState(h, c, zeros, zeros, enc, enc_proj, enc_scale, proj_scale)

    def step(self, state: DecoderState, tokens) -> tuple[DecoderState, torch.Tensor]:
        """One decode step: tokens (B,) -> (new state, logits (B, V) f32)."""
        emb = self._embed(tokens)
        if self.attn_type == "luong":
            return self._luong_step(state, emb)
        q = state.h @ self.w_query + self.b_query
        # int8 memory (read from its type, as in JAX): B2's int8 form
        int8 = (dict(enc_scale=state.enc_scale, proj_scale=state.proj_scale,
                     compute_dtype=self.dtype) if state.enc_proj.dtype == torch.int8 else {})
        # the JAX step adds b_score to every score before the softmax, which
        # does not change alpha, so the kernel is not given it
        if self.attn_type == "bahdanau":
            context, alpha = content_attention_step(state.enc, state.enc_proj, q, self.w_score,
                                                    **int8)
        else:
            mem = state.alpha_cum if self.attn_type == "coverage" else state.alpha_prev
            context, alpha = coverage_attention_step(
                state.enc, state.enc_proj, q, mem, self.loc_conv_w, self.loc_conv_b,
                self.w_loc, self.b_loc, self.w_score, **int8)
        x = torch.cat([context, emb], dim=-1)
        h_new, c_new = _lstm_cell(x, state.h, state.c, self.w_ih, self.b_ih,
                                  self.w_hh, self.b_hh)
        logits = h_new @ self.w_gen + self.b_gen
        new_state = state._replace(h=h_new, c=c_new, alpha_cum=state.alpha_cum + alpha,
                                   alpha_prev=alpha)
        return new_state, logits

    def _luong_step(self, state: DecoderState, emb):
        """Luong: the LSTM on the embedding, then float32 scores of the
        memory (repeated per beam) against the new h."""
        h_new, c_new = _lstm_cell(emb, state.h, state.c, self.w_ih, self.b_ih,
                                  self.w_hh, self.b_hh)
        enc = state.enc.float()
        K = h_new.shape[0] // enc.shape[0]
        if K > 1:
            enc = enc.repeat_interleave(K, dim=0)
        if self.method == "dot":
            e = torch.einsum("bsd,bd->bs", enc, h_new)
        elif self.method == "general":
            e = torch.einsum("bsd,bd->bs", enc, h_new @ self.w_luong)
        else:
            e = (torch.tanh((h_new[:, None, :] + enc) @ self.w_luong) @ self.v_luong)[..., 0]
        alpha = torch.softmax(e, dim=-1)
        context = torch.einsum("bs,bsd->bd", alpha, enc)
        logits = torch.tanh(torch.cat([context, h_new], dim=-1)) @ self.w_gen + self.b_gen
        return state._replace(h=h_new, c=c_new, alpha_prev=alpha), logits

    def forward(self, batch_h, text, train: bool = True, generator=None):
        """Teacher-forced pass: ``text`` (B, T) the shifted input ids
        ``encoded[:, :-1]`` -> logits (B, T, V) float32, aligned with
        ``encoded[:, 1:]``.  With ``train`` and ``droprate`` > 0, one dropout
        over the stacked logits, drawn from ``generator`` (the JAX head draws
        one mask over the stacked scan output, which is distributed as the
        reference's per-step dropout)."""
        state = self.init_state(batch_h)
        logits = []
        for t in range(text.shape[1]):
            state, step_logits = self.step(state, text[:, t])
            logits.append(step_logits)
        return dropout(torch.stack(logits, dim=1), self.droprate, train, generator)
