"""Train state and the train and eval steps (counterpart of
``doc2tex_tpu.train.trainer``).

One train step: normalize (or augment) the uint8 batch on the device ->
teacher-forced forward on ``text[:, :-1]`` with BatchNorm batch statistics
and dropout -> loss against ``text[:, 1:]`` -> backward -> the optimizer
chain (clip, update, learning-rate schedule) -> parameters updated in
place.  The random streams of a step (augmentation, dropout) are seeded
from the caller's generator's seed and the step number, as the JAX step
folds the step into its key, so a run resumed at step k draws what the
uninterrupted run draws there.  The step's parts run inside
``torch.profiler.record_function`` ranges (``train/forward``,
``train/backward``, ``train/optimizer``), which ``tools/profile_train.py``
reads.

With a mesh (``parallel.mesh``) the step is data-parallel, as JAX's is
over a sharded batch: every rank takes the same global batch (padded to the
data axis by ``pad_batch``) and works on its rows; BatchNorm's statistics,
the loss's numerator and count and the gradients are summed over the data
ranks before the optimizer (so ``grad_norm`` and the clipping see the
global gradient), and the augmentation's and dropout's draws are the
global batch's (``parallel.mesh.batch_rows``).  The ranks of one data row
(a model axis) hold the same weights and rows: nothing is reduced over it.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Any, Callable, Optional

import numpy as np
import torch
from torch.profiler import record_function

from ..parallel.mesh import DATA_AXIS, activation_mesh, batch_rows, shard_batch
from ..transforms.augment import normalize, train_augment
from .optim import global_norm, optimizer_from_config


@dataclass
class TrainState:
    step: int          # optimizer steps taken
    model: Any         # the port's Model (its parameters and BatchNorm statistics)
    opt_state: Any     # the optimizer's state (optax's structure, ``train/optim.py``)


def model_device(model) -> torch.device:
    return next(model.parameters()).device


def named_params(model) -> dict[str, torch.Tensor]:
    """The model's parameter tree, detached (the optimizer's view)."""
    return {k: p.detach() for k, p in model.named_parameters()}


def create_train_state(model, config) -> tuple[TrainState, Any]:
    """The model as it is, step 0 and a fresh optimizer state; returns
    (state, optimizer)."""
    if model.quant_parts is not None:
        raise ValueError("training takes quantize: None (int8 is an inference mode)")
    params = named_params(model)
    tx = optimizer_from_config(config, params)
    return TrainState(0, model, tx.init(params)), tx


def param_count(model) -> int:
    return sum(p.numel() for p in model.parameters())


def step_generator(generator: torch.Generator, step: int, stream: int, device) -> torch.Generator:
    """A generator on ``device`` seeded from ``generator``'s seed, the step
    and the stream (0 augmentation, 1 dropout)."""
    seed = np.random.SeedSequence([generator.initial_seed(), step, stream]).generate_state(
        2, np.uint32)
    g = torch.Generator(device=device)
    g.manual_seed(int(seed[0]) << 31 | int(seed[1]) >> 1)
    return g


def _inputs(images, text, device):
    x = torch.as_tensor(images).to(device)
    if x.dim() == 3:
        x = x[..., None]
    return x, torch.as_tensor(text).to(device, torch.long)


def token_accuracy(logits, tgt, mesh=None):
    mask = tgt != 0
    hits = ((logits.argmax(dim=-1) == tgt) & mask).sum()
    count = mask.sum()
    if mesh is not None:
        hits, count = mesh.all_reduce(torch.stack([hits, count]), DATA_AXIS)
    return hits / torch.clamp(count, min=1)


def pad_batch(images, text, multiple: int, go_id: int):
    """A host batch padded to a multiple of the data axis, as the JAX
    engine pads it: white images, and text rows that lead with [GO] (so the
    TFM head's key mask never sees an all-PAD row) and are PAD after it,
    which the loss masks out."""
    nb = images.shape[0]
    pad = -nb % multiple
    if not pad:
        return images, text
    images = np.pad(images, ((0, pad),) + ((0, 0),) * (images.ndim - 1), constant_values=255)
    text = np.pad(text, ((0, pad), (0, 0)))
    text[nb:, 0] = go_id
    return images, text


def reduce_gradients(grads: dict, mesh) -> dict:
    """The global gradient from each rank's part of it: every leaf summed
    over the data axis (one flat all-reduce per dtype)."""
    grads = dict(grads)
    if mesh.nd == 1:
        return grads
    by_type: dict = {}
    for k, g in grads.items():
        by_type.setdefault(g.dtype, []).append(k)
    for keys in by_type.values():
        flat = mesh.all_reduce(torch.cat([grads[k].reshape(-1) for k in keys]), DATA_AXIS)
        for k, part in zip(keys, flat.split([grads[k].numel() for k in keys])):
            grads[k] = part.view_as(grads[k])
    return grads


def loss_and_grads(model, criterion, x, text, generator=None, mesh=None):
    """Teacher-forced loss on normalized images ``x`` and encoded ``text``
    and its gradient for every parameter (zeros where a parameter has
    none); returns (loss, logits, grads).  With ``mesh`` (inside its
    ``activation_mesh``; ``x`` and ``text`` this rank's rows) the loss is
    the global batch's, the sum of the ranks' numerators over the sum of
    their counts, and the gradients are the global gradient."""
    params = dict(model.named_parameters())
    with record_function("train/forward"):
        logits = model(x, text[:, :-1], train=True, generator=generator)
        if mesh is None:
            loss = objective = criterion(logits, text[:, 1:])
        else:
            num, count = criterion.terms(logits, text[:, 1:])
            count = torch.clamp(mesh.all_reduce(count.detach(), DATA_AXIS), min=1.0)
            objective = num / count
            loss = mesh.all_reduce(num.detach(), DATA_AXIS) / count
    with record_function("train/backward"):
        grads = torch.autograd.grad(objective, list(params.values()), allow_unused=True)
    grads = {k: torch.zeros_like(p) if g is None else g for (k, p), g in zip(params.items(), grads)}
    if mesh is not None:
        grads = reduce_gradients(grads, mesh)
    return loss.detach(), logits.detach(), grads


def make_train_step(model, criterion: Callable, tx, config, mesh=None) -> Callable:
    """``step(state, images_u8, text, generator) -> metrics``: one update
    of ``state`` in place.  ``images_u8`` (B, H, W, 1) uint8, ``text``
    (B, L+2) encoded labels (numpy or tensors); ``metrics`` holds 0-d
    device tensors ``loss``, ``grad_norm`` (before clipping) and
    ``token_acc``, read by the caller when it wants them.  The config's
    ``augment`` turns ``train_augment`` on.  With ``mesh`` every rank
    passes the same global batch (B a multiple of the data axis,
    ``pad_batch``), or with ``rows_of`` its own rows of a global batch of
    that many (a sharded loader's ``Batch.rows_of``), and the step is
    data-parallel (see the module's docstring); the metrics are the global
    batch's."""
    mean, std = config.get("mean", 0.5), config.get("std", 0.5)
    do_augment = config.get("augment", False)

    def step(state: TrainState, images, text, generator: torch.Generator,
             rows_of: Optional[int] = None) -> dict:
        device = model_device(state.model)
        n = rows_of or images.shape[0]
        if mesh is not None and rows_of is None:
            images, text = shard_batch((images, text), mesh)
        x, text = _inputs(images, text, device)
        with activation_mesh(mesh), batch_rows(mesh, n):
            if do_augment:
                x = train_augment(step_generator(generator, state.step, 0, device), x, mean,
                                  std)
            else:
                x = normalize(x, mean, std)
            loss, logits, grads = loss_and_grads(
                state.model, criterion, x, text,
                step_generator(generator, state.step, 1, device), mesh)
        params = named_params(state.model)
        with record_function("train/optimizer"), torch.no_grad():
            updates, state.opt_state = tx.update(grads, state.opt_state, params)
            keys = list(params)
            torch._foreach_add_([params[k] for k in keys], [updates[k] for k in keys])
        state.step += 1
        return {"loss": loss, "grad_norm": global_norm(grads),
                "token_acc": token_accuracy(logits, text[:, 1:], mesh)}

    return step


def make_eval_step(model, criterion: Callable, config) -> Callable:
    """``step(state, images_u8, text) -> dict``: teacher-forced loss and
    token accuracy with the running statistics and no dropout, the
    per-sample loss (for the worst-predictions list) and the argmax
    predictions."""
    mean, std = config.get("mean", 0.5), config.get("std", 0.5)

    @torch.no_grad()
    def step(state: TrainState, images, text) -> dict:
        x, text = _inputs(images, text, model_device(state.model))
        tgt = text[:, 1:]
        logits = state.model(normalize(x, mean, std), text[:, :-1], train=False)
        logp = torch.log_softmax(logits.float(), dim=-1)
        nll = -logp.gather(-1, tgt[..., None])[..., 0]
        mask = (tgt != 0).float()
        per_sample = (nll * mask).sum(-1) / torch.clamp(mask.sum(-1), min=1.0)
        return {"loss": criterion(logits, tgt), "token_acc": token_accuracy(logits, tgt),
                "per_sample_loss": per_sample, "pred": logits.argmax(dim=-1)}

    return step


def criterion_from_config(config) -> Callable:
    """The config's criterion with ``ignore_index`` at the pad id (0 in
    both converter families)."""
    from .loss import create_criterion

    cc = dict(config.get("criterion", {"name": "entropy"}))
    name = cc.pop("name", "entropy")
    for key in ("reduction", "weight", "loss_args", "ignore_index"):
        cc.pop(key, None)
    return create_criterion(name, 0, **{k: v for k, v in cc.items() if v is not None})
