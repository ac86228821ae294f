"""Attention visualisation: decoder overlays and ViT attention rollout (the
port's twin of ``doc2tex_tpu.tools.interpretation``).

- ``collect_vit_attention``: every ViT block's attention probabilities,
  captured by ``models.layers.SelfAttention``'s opt-in ``capture`` list
  (None, and so off, by default: no copy, no launch, no bit moved);
- ``attention_rollout`` (the reference's ``VITAttentionRollout``): fuse the
  heads (mean, max or min), drop the lowest ``discard_ratio`` of the
  weights (never the class column), add the identity, normalise and chain
  the blocks;
- ``decoder_attention_maps``: the LSTM head's alignment (``alpha``) at each
  decode step on the patch grid; on the card ``alpha`` comes from B2. A
  TFM head, and the luong head, give none, as in the JAX package;
- ``upsample_map``, ``saliency_overlay`` (a JET heat map over the crop),
  ``select_samples`` (the reference's condition DSL) and
  ``collect_feature_maps`` (the outputs of the ResNet and embedding
  modules by forward hooks, under the JAX package's flax paths, NHWC, and
  the blocks' attention probabilities beside them, as flax's intermediates
  hold them).

The functions take the port's ``Model`` on its device (the card or the
CPU) and a normalised (B, H, W, C) image (numpy or a tensor).
"""

from __future__ import annotations

import contextlib
from typing import Literal, Sequence

import numpy as np
import torch

from ..models.layers import SelfAttention


def _image(model, image) -> torch.Tensor:
    device = next(model.parameters()).device
    return torch.as_tensor(np.asarray(image, np.float32)).to(device)


def _numpy(t: torch.Tensor) -> np.ndarray:
    return t.detach().float().cpu().numpy()


@contextlib.contextmanager
def capture_attention(model):
    """Within the block, each of ``model``'s ``SelfAttention`` modules
    appends its attention probabilities to its ``capture`` list; yields
    ``{module name: that list}``.  Afterwards capture is off again."""
    modules = {name: m for name, m in model.named_modules() if isinstance(m, SelfAttention)}
    for m in modules.values():
        m.capture = []
    try:
        yield {name: m.capture for name, m in modules.items()}
    finally:
        for m in modules.values():
            m.capture = None


@torch.no_grad()
def collect_vit_attention(model, image) -> list[np.ndarray]:
    """The encoder's attention probabilities, block by block: a list of
    (B, heads, N, N) float32 arrays."""
    with capture_attention(model) as captured:
        model.encode(_image(model, image))
    return [_numpy(t) for probs in captured.values() for t in probs]


def attention_rollout(attentions: Sequence[np.ndarray],
                      head_fusion: Literal["mean", "max", "min"] = "mean",
                      discard_ratio: float = 0.9) -> np.ndarray:
    """The class token's rolled-out attention over the patches, (B, N - 1),
    scaled to a maximum of 1 (the reference's ``vit_visualize.py``)."""
    B, _, N, _ = attentions[0].shape
    result = np.broadcast_to(np.eye(N, dtype=np.float32), (B, N, N)).copy()
    for attn in attentions:
        if head_fusion == "mean":
            fused = attn.mean(axis=1)
        elif head_fusion == "max":
            fused = attn.max(axis=1)
        else:
            fused = attn.min(axis=1)
        flat = fused.reshape(B, -1)
        k = int(flat.shape[1] * discard_ratio)
        if k > 0:
            idx = np.argpartition(flat, k, axis=1)[:, :k]
            for b in range(B):
                cols = idx[b][idx[b] % N != 0]
                flat[b, cols] = 0.0
        fused = flat.reshape(B, N, N) + np.eye(N, dtype=np.float32)
        fused = fused / fused.sum(axis=-1, keepdims=True)
        result = np.einsum("bij,bjk->bik", fused, result)
    mask = result[:, 0, 1:]
    return mask / np.maximum(mask.max(axis=-1, keepdims=True), 1e-9)


def upsample_map(m: np.ndarray, out_hw: tuple[int, int]) -> np.ndarray:
    """Nearest-neighbour upsampling of a 2-D map to ``out_hw``."""
    h, w = m.shape
    H, W = out_hw
    yi = np.clip((np.arange(H) * h / H).astype(int), 0, h - 1)
    xi = np.clip((np.arange(W) * w / W).astype(int), 0, w - 1)
    return m[yi][:, xi]


def _jet(v: np.ndarray) -> np.ndarray:
    """A JET colour map: v in [0, 1] -> (..., 3) uint8."""
    r = np.clip(1.5 - np.abs(4 * v - 3), 0, 1)
    g = np.clip(1.5 - np.abs(4 * v - 2), 0, 1)
    b = np.clip(1.5 - np.abs(4 * v - 1), 0, 1)
    return (np.stack([r, g, b], axis=-1) * 255).astype(np.uint8)


def saliency_overlay(image: np.ndarray, attn_map: np.ndarray, alpha: float = 0.5) -> np.ndarray:
    """A saliency map blended over a grey (or RGB) image (the reference's
    ``VizTool.get_saliency_map``)."""
    H, W = image.shape[:2]
    m = upsample_map(attn_map, (H, W))
    m = (m - m.min()) / max(m.max() - m.min(), 1e-9)
    base = np.repeat(image[..., None], 3, axis=-1) if image.ndim == 2 else image
    return (alpha * _jet(m) + (1 - alpha) * base).astype(np.uint8)


@torch.no_grad()
def decoder_attention_maps(model, image, tokens: np.ndarray, grid_hw: tuple[int, int],
                           has_cls: bool = True) -> list[np.ndarray]:
    """The LSTM head's alignment at each decode step fed ``tokens`` (T,)
    (e.g. [GO] + a prediction), on the (gh, gw) patch grid: T maps of the
    first image, the class position dropped where the memory has one.  A
    head with no such alignment (TFM, luong) gives []."""
    if model.head == "TFM" or getattr(model.predicter, "attn_type", None) == "luong":
        return []
    device = next(model.parameters()).device
    enc = model.encode(_image(model, image))
    state = model.init_decode_state(enc, len(tokens))
    maps = []
    n = grid_hw[0] * grid_hw[1]
    for t in range(len(tokens)):
        step = torch.as_tensor(np.asarray(tokens[t:t + 1]), dtype=torch.long, device=device)
        state, _ = model.decode_step(state, step)
        alpha = _numpy(state.alpha_prev)[0]
        if has_cls and alpha.shape[0] == n + 1:
            alpha = alpha[1:]
        maps.append(alpha[:n].reshape(grid_hw))
    return maps


def select_samples(rows, condition: str | None = None, seed: int = 0):
    """Prediction rows (dicts with 'name', 'pred', 'label', optional
    'iscorrect') that meet a condition such as ``"(len < 50 & len > 30)
    %iscorrect: True"`` (the reference's ``get_test_sample``), shuffled by
    ``seed``."""
    import random
    import re

    rows = [dict(r, len=len(str(r.get("pred", "")).split())) for r in rows]
    if condition:
        m = re.search(r"\((.*)\)", condition)
        if m:
            ops = {"<": lambda a, b: a < b, ">": lambda a, b: a > b,
                   "<=": lambda a, b: a <= b, ">=": lambda a, b: a >= b,
                   "==": lambda a, b: a == b}
            for clause in (c.strip() for c in m.group(1).split("&")):
                cm = re.match(r"len\s*(<=|>=|<|>|==)\s*(\d+)", clause)
                if cm:
                    op, val = ops[cm.group(1)], int(cm.group(2))
                    rows = [r for r in rows if op(r["len"], val)]
        im = re.search(r"%iscorrect:\s*(\w+)", condition)
        if im:
            want = im.group(1).lower() == "true"
            rows = [r for r in rows if bool(r.get("iscorrect", False)) == want]
    random.Random(seed).shuffle(rows)
    return rows


@torch.no_grad()
def collect_feature_maps(model, image, name_filter=("ResNet", "Embed")) -> dict:
    """{flax path: float32 array} of the encoder's modules whose class name
    holds one of ``name_filter``: each module's output (the first array of
    a tuple; NHWC for a feature map) under ``<path>/__call__``, and each
    block's attention probabilities under ``<path>/attn_probs``, the keys
    JAX's ``capture_intermediates`` gives."""
    out, hooks = {}, []

    def hook(name):
        def fn(module, inputs, output):
            t = output[0] if isinstance(output, tuple) else output
            if t.dim() == 4:
                t = t.permute(0, 2, 3, 1)
            out[name.replace(".", "/") + "/__call__"] = _numpy(t)
        return fn

    for name, m in model.named_modules():
        if name and any(f in type(m).__name__ for f in name_filter):
            hooks.append(m.register_forward_hook(hook(name)))
    try:
        with capture_attention(model) as captured:
            model.encode(_image(model, image))
    finally:
        for h in hooks:
            h.remove()
    for name, probs in captured.items():
        if probs:
            out[name.replace(".", "/") + "/attn_probs"] = _numpy(probs[-1])
    return out
