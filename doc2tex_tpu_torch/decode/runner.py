"""Images -> token ids: normalize, encode, decode (counterpart of
``doc2tex_tpu.decode.runner``).

Special-token ids: Attn (LSTM heads) GO=0 (also pad), [s]=1; TFM PAD=0,
GO=1, [s]=2.
"""

from __future__ import annotations

from typing import Callable, NamedTuple

import numpy as np
import torch

from ..models.decoder_tfm import grow_decode_state
from ..transforms.augment import normalize
from .beam import beam_decode, lstm_gather, tfm_gather
from .greedy import greedy_decode


class TokenIds(NamedTuple):
    start: int
    end: int
    pad: int


def token_ids_for(pred_name: str) -> TokenIds:
    if pred_name.startswith("Attn"):
        return TokenIds(start=0, end=1, pad=0)
    return TokenIds(start=1, end=2, pad=0)  # TFM family


def _chunk_ends(max_steps: int, n_chunks: int) -> list[int]:
    """Increasing chunk end-steps, last == max_steps; one chunk when
    max_steps is too short to be worth it."""
    if n_chunks <= 1 or max_steps < 8 * n_chunks:
        return [max_steps]
    size = -(-max_steps // n_chunks)
    return list(range(size, max_steps, size)) + [max_steps]


DECODE_CHUNKS = 5


def make_decode_fn(model, config, beam_size: int = 1, device="cuda") -> Callable:
    """Build ``fn(images_u8) -> (tokens (B, T), aux (B,))``.

    ``images_u8``: (B, H, W, 1) uint8 bucket-padded pixels (numpy or
    tensor); they are moved to ``device``, normalized and decoded there, for
    ``batch_max_length + 1`` steps at most.  ``aux`` is lengths for greedy,
    scores for beam.  The TFM head decodes in ``DECODE_CHUNKS`` chunks: the
    KV caches start at the first chunk's length and grow between chunks, so
    early steps read only the live prefix (token-exact).  The LSTM head's
    state has no step-sized leaf, so it decodes in one chunk."""
    pred_name = config["Prediction"]["name"]
    ids = token_ids_for(pred_name)
    mean, std = config.get("mean", 0.5), config.get("std", 0.5)
    max_steps = config["batch_max_length"] + 1
    is_tfm_head = pred_name in ("TFM", "MS_TFM")
    gather = tfm_gather if is_tfm_head else lstm_gather
    ends = _chunk_ends(max_steps, DECODE_CHUNKS) if is_tfm_head else [max_steps]
    k = max(beam_size, 1)
    schedule = [
        (t_end, (lambda s, _n=nxt: grow_decode_state(s, _n, k)) if nxt else None)
        for t_end, nxt in zip(ends, ends[1:] + [None])
    ]

    @torch.inference_mode()
    def run(images):
        x = torch.as_tensor(np.asarray(images) if not torch.is_tensor(images) else images)
        x = x.to(device)
        if x.dim() == 3:
            x = x[..., None]
        x = normalize(x, mean=mean, std=std)
        B = x.shape[0]
        enc = model.encode(x)
        state = model.init_decode_state(enc, max_steps, k, live_steps=ends[0])
        if beam_size <= 1:
            return greedy_decode(
                model.decode_step, state, B, max_steps,
                start_token=ids.start, end_token=ids.end, pad_token=ids.pad,
                chunk_schedule=schedule, device=device)
        return beam_decode(
            model.decode_step, state, gather, B, beam_size, max_steps,
            start_token=ids.start, end_token=ids.end, pad_token=ids.pad,
            chunk_schedule=schedule, device=device)

    return run
