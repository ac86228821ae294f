"""Batched beam search on the device (counterpart of
``doc2tex_tpu.decode.beam``).

Beams are an array axis: state leaves carry a flattened (B*K) leading dim,
candidate expansion is one ``topk`` over K*V scores, and finished
hypotheses are frozen in place (they emit exactly one pad-continuation
candidate with unchanged score).  A running store keeps the best
length-normalized finished hypothesis per row (normalized by emitted
tokens + ``length_offset``); the final pick merges it with the finished
slots and falls back to beam 0 when nothing finished.

The step loop is a Python loop; it reads ``finished.all()`` every
``POLL_EVERY`` steps instead of every step.  Steps after every beam has
finished only re-emit the frozen pad-continuations, so the result equals
the JAX ``while_loop`` that stops at once.
"""

from __future__ import annotations

from typing import Callable

import torch

from .greedy import POLL_EVERY

NEG_INF = -1e9


def _gather_beams(x, beam_idx, batch_size, k):
    """x: (B*K, ...) -> its rows reordered by parent beam within each
    sample, an exact index gather.  beam_idx: (B, K)."""
    rows = torch.arange(batch_size, device=beam_idx.device)[:, None]
    shaped = x.reshape(batch_size, k, *x.shape[1:])
    return shaped[rows, beam_idx].reshape(x.shape)


def make_gather_fn(static_fields: tuple[str, ...] = ()) -> Callable:
    """A gather_fn for a NamedTuple state; ``static_fields`` are
    beam-invariant (encoder memory, scales) and left as they are."""

    def gather(state, beam_idx, batch_size, k):
        updates = {name: _gather_beams(leaf, beam_idx, batch_size, k)
                   for name, leaf in state._asdict().items() if name not in static_fields}
        return state._replace(**updates)

    return gather


# Beam-invariant fields of the LSTM head's state: the attention memory is
# the same for every beam of a sample, and so are its int8 scales (B, 1, 1)
# (or the (0,) placeholders when the memory is not int8).
LSTM_STATIC = ("enc", "enc_proj", "enc_scale", "proj_scale")
lstm_gather = make_gather_fn(LSTM_STATIC)


def tfm_gather(state, beam_idx, batch_size, k):
    """Reorder only the (B, K, T, K) ancestry selection by parent beam — an
    exact index gather; the KV caches (and int8 scales) stay in their fixed
    slots."""
    rows = torch.arange(batch_size, device=beam_idx.device)[:, None]
    state.sel = state.sel[rows, beam_idx]
    return state


def beam_decode(
    step_fn: Callable,
    init_state,
    gather_fn: Callable,
    batch_size: int,
    beam_size: int,
    max_steps: int,
    start_token: int = 1,
    end_token: int = 2,
    pad_token: int = 0,
    length_offset: int = 1,
    chunk_schedule=None,
    device="cuda",
):
    """Beam search over a (B*K)-flattened state.  Returns (tokens
    (B, max_steps) int32, scores (B,) float32) of the length-normalized
    best finished hypothesis per row (beam 0 when none finished).

    ``chunk_schedule``: optional list of ``(t_end, grow_fn)`` pairs, last
    ``t_end == max_steps``; after each non-final chunk ``grow_fn(state)``
    enlarges the KV caches so early steps stream only the live prefix."""
    B, K, T = batch_size, beam_size, max_steps
    f32 = torch.float32
    rows = torch.arange(B, device=device)

    tokens = torch.full((B, K, T), pad_token, dtype=torch.int32, device=device)
    scores = torch.full((B, K), NEG_INF, dtype=f32, device=device)
    scores[:, 0] = 0.0          # beam 0 live, the others -inf: step 0 expands beam 0 only
    finished = torch.zeros((B, K), dtype=torch.bool, device=device)
    cur = torch.full((B * K,), start_token, dtype=torch.long, device=device)
    lengths = torch.zeros((B, K), dtype=torch.int32, device=device)
    best_norm = torch.full((B,), NEG_INF, dtype=f32, device=device)
    best_tokens = torch.full((B, T), pad_token, dtype=torch.int32, device=device)
    best_scores = torch.full((B,), NEG_INF, dtype=f32, device=device)
    frozen_base = None

    grows = {t_end: fn for t_end, fn in chunk_schedule or () if fn is not None}
    state = init_state
    for t in range(max_steps):
        if t in grows:
            state = grows[t](state)
        state, logits = step_fn(state, cur)
        logp = torch.log_softmax(logits.float(), dim=-1).reshape(B, K, -1)
        V = logp.shape[-1]
        if frozen_base is None:
            frozen_base = torch.full((V,), NEG_INF, dtype=f32, device=device)
            frozen_base[pad_token] = 0.0
        live_cand = scores[..., None] + logp
        frozen_cand = frozen_base + scores[..., None]
        cand = torch.where(finished[..., None], frozen_cand, live_cand)

        top_scores, top_idx = torch.topk(cand.reshape(B, K * V), K, dim=1)
        beam_idx = torch.div(top_idx, V, rounding_mode="floor")
        tok = (top_idx % V).to(torch.int32)

        state = gather_fn(state, beam_idx, B, K)
        tokens = tokens[rows[:, None], beam_idx]
        finished = torch.gather(finished, 1, beam_idx)
        lengths = torch.gather(lengths, 1, beam_idx)

        tokens[:, :, t] = torch.where(finished, pad_token, tok)
        newly_done = ~finished & (tok == end_token)
        lengths = torch.where(finished, lengths, lengths + 1)
        finished = finished | newly_done

        cand_norm = torch.where(
            newly_done, top_scores / (lengths + length_offset).to(f32), NEG_INF)
        slot = torch.argmax(cand_norm, dim=1)
        slot_norm = cand_norm[rows, slot]
        improved = slot_norm > best_norm
        best_tokens = torch.where(improved[:, None], tokens[rows, slot], best_tokens)
        best_scores = torch.where(improved, top_scores[rows, slot], best_scores)
        best_norm = torch.maximum(best_norm, slot_norm)

        cur = torch.where(finished, pad_token, tok).reshape(B * K).long()
        scores = top_scores
        if (t + 1) % POLL_EVERY == 0 and bool(finished.all()):
            break

    norm = torch.where(finished, scores / (lengths + length_offset).to(f32), NEG_INF)
    best = torch.argmax(norm, dim=1)
    slot_norm = norm[rows, best]
    use_store = best_norm > slot_norm
    out_tokens = torch.where(use_store[:, None], best_tokens, tokens[rows, best])
    out_scores = torch.where(use_store, best_scores, scores[rows, best])

    nothing_finished = ~(finished.any(dim=1) | (best_norm > NEG_INF / 2))
    out_tokens = torch.where(nothing_finished[:, None], tokens[:, 0], out_tokens)
    out_scores = torch.where(nothing_finished, scores[:, 0], out_scores)
    return out_tokens, out_scores
