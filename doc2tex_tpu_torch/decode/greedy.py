"""Batched greedy decoding (counterpart of ``doc2tex_tpu.decode.greedy``).

A Python loop over steps on the device.  Instead of a host sync every step
(the JAX ``while_loop`` tests ``done.all()`` on the device), the loop reads
``done.all()`` every ``POLL_EVERY`` steps; steps taken after every row is
done only write pad, so the result is the same.
"""

from __future__ import annotations

from typing import Callable

import torch

POLL_EVERY = 8  # steps between host reads of "every row is done"


def greedy_decode(
    step_fn: Callable,
    init_state,
    batch_size: int,
    max_steps: int,
    start_token: int = 1,
    end_token: int = 2,
    pad_token: int = 0,
    chunk_schedule=None,
    device="cuda",
):
    """Returns (tokens (B, max_steps) int32, lengths (B,) int32).  Tokens
    after the emitted [s] are pad; the [s] itself is kept.

    ``chunk_schedule``: optional list of ``(t_end, grow_fn)`` pairs, last
    ``t_end == max_steps``; after each chunk ``grow_fn(state)`` enlarges the
    KV caches (see ``beam.beam_decode``)."""
    tokens = torch.full((batch_size, max_steps), pad_token, dtype=torch.int32, device=device)
    cur = torch.full((batch_size,), start_token, dtype=torch.long, device=device)
    done = torch.zeros((batch_size,), dtype=torch.bool, device=device)
    grows = {t_end: fn for t_end, fn in chunk_schedule or () if fn is not None}
    state = init_state
    for t in range(max_steps):
        if t in grows:
            state = grows[t](state)
        state, logits = step_fn(state, cur)
        nxt = torch.argmax(logits, dim=-1)
        nxt = torch.where(done, pad_token, nxt)
        tokens[:, t] = nxt.to(torch.int32)
        done = done | (nxt == end_token)
        cur = nxt
        if (t + 1) % POLL_EVERY == 0 and bool(done.all()):
            break
    lengths = (tokens != pad_token).sum(dim=-1).to(torch.int32)
    return tokens, lengths
