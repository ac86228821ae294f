"""Transformer decoder head: the teacher-forced pass (``forward``, for
training and the validation loss) and KV-cache decoding (counterpart of
``doc2tex_tpu.models.decoder_tfm``: ``__call__``, ``init_state``, ``step``,
``grow_decode_state``).

A post-LN decoder (self-attn -> cross-attn -> relu FFN, LayerNorm eps 1e-5
after each residual), word embedding zeroed at ``padding_idx`` then scaled
by sqrt(d), plus the 1D sin-cos table.  ``nn.TransformerDecoderLayer`` is
not a drop-in for it.

Decode state (see ``TFMState``), as in the JAX package:

- cross-attention K/V are computed once per batch at the SHARED batch dim B
  — beams of one sample read the same encoder memory once per step;
- self-attention caches live in FIXED slots and are never reordered by the
  beam shuffle; ``sel[b, k, t', j]`` says that position t' of hypothesis
  k's prefix lives in slot j, and the step masks the attention by it;
- cache layout is position-major, flat index m = t*K + j, so the K slot
  writes of a step are one contiguous slice.

Unlike the JAX package the caches and ``sel`` are updated IN PLACE (the
step mutates and returns the state), which saves a cache copy per step.
Types follow the JAX code: the residual stream, projections and logits are
float32; queries, keys and values are cast to the compute type before the
attention kernel.  The teacher-forced pass keeps JAX's attention too
(``_mha``: plain products, float32 softmax, no fused attention call, whose
softmax and rounding would differ): there only the queries are in the
compute type, keys and values are the float32 products of the rounded
inputs, as JAX's type promotion makes them.
"""

from __future__ import annotations

import math
from dataclasses import dataclass

import torch
import torch.nn as nn
import torch.nn.functional as F

from ..ops.decode_attention import decode_attention
from .layers import dropout, word_posenc

_LAYER_PARAMS = (
    "sa_wq", "sa_wk", "sa_wv", "sa_wo", "sa_bq", "sa_bk", "sa_bv", "sa_bo",
    "ca_wq", "ca_wk", "ca_wv", "ca_wo", "ca_bq", "ca_bk", "ca_bv", "ca_bo",
    "ff_w1", "ff_b1", "ff_w2", "ff_b2",
    "n1_s", "n1_b", "n2_s", "n2_b", "n3_s", "n3_b",
)


@dataclass
class TFMState:
    k_cache: list        # L x (B, Tlive*K, nh, hd) — fixed physical slots
    v_cache: list        # L x (B, Tlive*K, nh, hd)
    k_mem: list          # L x (B, S, nh, hd) — cross-attention K (shared)
    v_mem: list          # L x (B, S, nh, hd)
    sel: torch.Tensor    # (B, K, Tmax, K) bool — ancestry slot selection
    t: int               # current step


def _mha(q, k, v, nheads: int, mask=None):
    """``doc2tex_tpu.models.decoder_tfm._mha``: q (B, Tq, d), k/v (B, Tk,
    nh, hd); scores divided by sqrt(hd), softmax in float32, probabilities
    in v's type."""
    B, Tq, d = q.shape
    hd = d // nheads
    q = q.reshape(B, Tq, nheads, hd)
    attn = torch.einsum("bqhd,bkhd->bhqk", q.to(torch.promote_types(q.dtype, k.dtype)), k)
    attn = (attn / math.sqrt(hd)).float()
    if mask is not None:
        attn = attn.masked_fill(~mask, float("-inf"))
    attn = torch.softmax(attn, dim=-1).to(v.dtype)
    return torch.einsum("bhqk,bkhd->bqhd", attn, v).reshape(B, Tq, d)


class TransformerDecoder(nn.Module):
    def __init__(self, num_classes: int, d_model: int = 256, nhead: int = 8,
                 num_decoder_layers: int = 3, dim_feedforward: int = 1024,
                 max_seq_len: int = 150, padding_idx: int = 0,
                 dtype: torch.dtype = torch.float32, dropout: float = 0.3):
        super().__init__()
        self.dropout = dropout
        self.d_model, self.nhead = d_model, nhead
        self.num_layers = num_decoder_layers
        self.padding_idx = padding_idx
        self.dtype = dtype
        d, ff = d_model, dim_feedforward
        shapes = {"ff_w1": (d, ff), "ff_b1": (ff,), "ff_w2": (ff, d)}
        for i in range(num_decoder_layers):
            for name in _LAYER_PARAMS:
                shape = shapes.get(name, (d, d) if name[3] == "w" else (d,))
                init = torch.ones if name.endswith("_s") else torch.zeros
                p = nn.Parameter(init(shape))
                if len(shape) == 2:
                    nn.init.xavier_uniform_(p)
                self.register_parameter(f"l{i}_{name}", p)
        self.word_embed = nn.Parameter(torch.empty(num_classes, d))
        nn.init.trunc_normal_(self.word_embed, std=0.02)
        self.w_proj = nn.Parameter(torch.empty(d, num_classes))
        nn.init.xavier_uniform_(self.w_proj)
        self.b_proj = nn.Parameter(torch.zeros(num_classes))
        self.register_buffer("pos_table", word_posenc(max_seq_len + 8, d), persistent=False)

    def _p(self, i: int, name: str) -> torch.Tensor:
        return getattr(self, f"l{i}_{name}")

    def _ln(self, x, i: int, n: int):
        return F.layer_norm(x.float(), (self.d_model,), self._p(i, f"n{n}_s"),
                            self._p(i, f"n{n}_b"), 1e-5)

    def _proj(self, y, i: int, name: str):
        """y @ W + b in float32 (JAX promotes compute-type @ float32)."""
        return y.float() @ self._p(i, f"{name[:3]}w{name[3:]}") + self._p(i, f"{name[:3]}b{name[3:]}")

    def _heads(self, y, i: int, name: str):
        B, T, _ = y.shape
        return self._proj(y, i, name).reshape(B, T, self.nhead, self.d_model // self.nhead)

    def forward(self, memory, tgt_ids, train: bool = True, generator=None):
        """Teacher-forced causal pass: memory (B, S, D), tgt_ids (B, T) ->
        logits (B, T, V) float32.  In training the padding positions are
        masked as keys, but key 0 always stays visible, so an all-PAD row
        cannot make a softmax over nothing (NaN) and poison the batch's
        loss; dropout (``generator``) follows each sublayer and the FF's
        hidden layer."""
        B, T = tgt_ids.shape
        dev = tgt_ids.device
        emb = self.word_embed[tgt_ids] * (tgt_ids != self.padding_idx)[..., None]
        x = emb * math.sqrt(self.d_model) + self.pos_table[:T]
        mask = torch.ones((T, T), dtype=torch.bool, device=dev).tril()[None, None]
        if train:
            not_pad = (tgt_ids != self.padding_idx)[:, None, None, :]
            first = (torch.arange(T, device=dev) == 0)[None, None, None, :]
            mask = mask & (not_pad | first)
        mem = memory.to(self.dtype)
        dt, rate = self.dtype, self.dropout

        def drop(h):
            return dropout(h, rate, train, generator)

        for i in range(self.num_layers):
            xd = x.to(dt)
            h = _mha(self._proj(x, i, "sa_q").to(dt), self._heads(xd, i, "sa_k"),
                     self._heads(xd, i, "sa_v"), self.nhead, mask)
            x = self._ln(x + drop(self._proj(h, i, "sa_o")), i, 1)
            h = _mha(self._proj(x, i, "ca_q").to(dt), self._heads(mem, i, "ca_k"),
                     self._heads(mem, i, "ca_v"), self.nhead)
            x = self._ln(x + drop(self._proj(h, i, "ca_o")), i, 2)
            h = drop(F.relu(x.to(dt).float() @ self._p(i, "ff_w1") + self._p(i, "ff_b1")))
            x = self._ln(x + drop(h @ self._p(i, "ff_w2") + self._p(i, "ff_b2")), i, 3)
        return x @ self.w_proj + self.b_proj

    # ------------------------------------------------------------------
    def init_state(self, memory, max_steps: int, beam_size: int = 1,
                   live_steps: int | None = None) -> TFMState:
        """Precompute cross-attention K/V from the UNexpanded (B, S, D)
        memory and allocate the self-attention caches for B*beam_size
        hypotheses.  ``live_steps`` caps the first cache capacity for
        chunked decode (``grow_decode_state`` extends it)."""
        B, S, _ = memory.shape
        nh, hd = self.nhead, self.d_model // self.nhead
        cap = max_steps if live_steps is None else min(live_steps, max_steps)
        mem = memory.to(self.dtype)
        k_mem, v_mem, k_cache, v_cache = [], [], [], []
        for i in range(self.num_layers):
            k_mem.append(self._proj(mem, i, "ca_k").to(self.dtype).reshape(B, S, nh, hd))
            v_mem.append(self._proj(mem, i, "ca_v").to(self.dtype).reshape(B, S, nh, hd))
            k_cache.append(memory.new_zeros((B, cap * beam_size, nh, hd), dtype=self.dtype))
            v_cache.append(memory.new_zeros((B, cap * beam_size, nh, hd), dtype=self.dtype))
        sel = torch.zeros((B, beam_size, max_steps, beam_size), dtype=torch.bool,
                          device=memory.device)
        return TFMState(k_cache, v_cache, k_mem, v_mem, sel, 0)

    def step(self, state: TFMState, tokens) -> tuple[TFMState, torch.Tensor]:
        """One decode step: tokens (B*K,) -> (state, logits (B*K, V) f32)."""
        BK = tokens.shape[0]
        Bs = state.k_mem[0].shape[0]
        K = BK // Bs
        nh, hd, d = self.nhead, self.d_model // self.nhead, self.d_model
        t = state.t
        emb = self.word_embed[tokens] * (tokens != self.padding_idx)[:, None]
        x = emb * math.sqrt(d) + self.pos_table[t]                 # (BK, d) f32

        M = state.k_cache[0].shape[1]
        Tmax = M // K
        # the hypothesis in slot j writes position t of its own prefix
        state.sel[:, :, t, :] = torch.eye(K, dtype=torch.bool, device=tokens.device)
        live = torch.arange(Tmax, device=tokens.device) <= t
        sel_mask = (state.sel[:, :, :Tmax, :] & live[None, None, :, None]).reshape(Bs, K, M)

        scale = 1.0 / math.sqrt(hd)
        dt = self.dtype
        for i in range(self.num_layers):
            xq = x.to(dt)
            k_new = self._proj(xq, i, "sa_k").to(dt).reshape(Bs, K, nh, hd)
            v_new = self._proj(xq, i, "sa_v").to(dt).reshape(Bs, K, nh, hd)
            state.k_cache[i][:, t * K:(t + 1) * K] = k_new
            state.v_cache[i][:, t * K:(t + 1) * K] = v_new
            qh = (self._proj(xq, i, "sa_q") * scale).to(dt).reshape(Bs, K, nh, hd)
            ctx = decode_attention(qh, state.k_cache[i], state.v_cache[i], sel_mask)
            x = self._ln(x + self._proj(ctx.reshape(BK, d), i, "sa_o"), i, 1)
            qh = (self._proj(x.to(dt), i, "ca_q") * scale).to(dt).reshape(Bs, K, nh, hd)
            ctx = decode_attention(qh, state.k_mem[i], state.v_mem[i])
            x = self._ln(x + self._proj(ctx.reshape(BK, d), i, "ca_o"), i, 2)
            h = F.relu(x.to(dt).float() @ self._p(i, "ff_w1") + self._p(i, "ff_b1"))
            h = h @ self._p(i, "ff_w2") + self._p(i, "ff_b2")
            x = self._ln(x + h, i, 3)
        logits = x @ self.w_proj + self.b_proj
        state.t = t + 1
        return state, logits


def grow_decode_state(state: TFMState, new_steps: int, beam_size: int) -> TFMState:
    """Zero-pad the KV caches to ``new_steps * beam_size`` slots (chunked
    decode: early steps only stream the live prefix).  Slot m keeps its
    (position, slot) meaning, so decode results are unchanged."""
    m_new = new_steps * beam_size
    m_old = state.k_cache[0].shape[1]
    if m_new <= m_old:
        return state
    pad = (0, 0, 0, 0, 0, m_new - m_old)
    state.k_cache = [F.pad(c, pad) for c in state.k_cache]
    state.v_cache = [F.pad(c, pad) for c in state.v_cache]
    return state
