"""The training engine: init, the iteration loop, validation and
checkpoints (counterpart of ``doc2tex_tpu.engine.training``).

``train`` runs an endless bucketed batch iterator through the train step,
logs the loss every ``logInterval`` steps, validates every
``valInterval`` steps and at the end (teacher-forced loss, greedy decode,
metrics), keeps the best checkpoints, stops early after ``early_stop``
steps without a better one, and with ``sanity_check`` stops after one step
and one validation batch.  One greedy decode function is built once and
serves every validation; on the card its attention runs the hand-written
beam decode attention kernel (B1) at beam 1.

More than one rank trains data-parallel, as the JAX engine does over its
mesh: ``train`` on a host with more than one card (and ``use_dp``, on by
default) starts one rank a card itself (``parallel.spawn``), or joins the
ranks torchrun started; ranks started by the caller (``parallel.spawn``,
the CPU tests) train in the group they are in.  The mesh is the config's
``mesh_shape`` (default: every rank on the data axis; a model axis
replicates); the train loader gives each rank its rows of every global
batch (decoding only those), padded to the data axis with white, GO-led,
loss-masked rows as ``train.trainer.pad_batch`` pads; validation decodes
over the mesh (``val_use_mesh``, default on; its tail padded with white
rows, trimmed after) and computes the teacher-forced loss on every rank;
rank 0 alone logs and writes the files.
"""

from __future__ import annotations

import contextlib
import logging
import os
import time
from dataclasses import dataclass
from typing import Any, Optional

import torch

from ..data.loader import build_loader
from ..decode.runner import make_decode_fn
from ..models import build_model
from ..parallel import mesh as meshlib
from ..tokenizer.converters import create_converter
from ..train.checkpoint import BestCheckpointKeeper, load_checkpoint, load_pretrained_params
from ..train.trainer import (TrainState, create_train_state, criterion_from_config,
                             make_eval_step, make_train_step, param_count)
from ..utils.common import Averager, cal_elapsed_time, setup_logger, update_summary
from ..utils.profiling import StepTimer
from .inferencing import validation


@dataclass
class TrainingBundle:
    config: dict
    converter: Any
    model: Any
    state: TrainState
    tx: Any
    criterion: Any
    train_step: Any
    eval_step: Any
    start_iter: int
    device: str
    resume_meta: Optional[dict] = None


def _fresh_state(config, num_classes: int, device):
    with torch.random.fork_rng(devices=[]):   # seeds the init, not the caller's RNG
        torch.manual_seed(config.get("manualSeed", 1111))
        model = build_model(config, num_classes)
    return create_train_state(model.to(device), config)


def init_training(config, device="cuda") -> TrainingBundle:
    """Converter, model (initialized from ``manualSeed``), train state,
    optimizer, criterion and steps; then ``resume_path`` (the whole state;
    on failure a warning and a fresh state) or ``pretrained_weight`` (the
    parameters whose name and shape match; BatchNorm statistics stay
    fresh, as in the JAX engine)."""
    converter = create_converter(config)
    config["num_class"] = converter.num_classes
    state, tx = _fresh_state(config, converter.num_classes, device)
    start_iter, resume_meta = 0, None
    if config.get("resume_path"):
        try:
            state, meta = load_checkpoint(config["resume_path"], state)
            start_iter = int(meta.get("iter", state.step))
            resume_meta = dict(meta)
        except Exception as e:
            logging.getLogger("doc2tex_tpu_torch").warning(f"resume failed ({e}); starting fresh")
            state, tx = _fresh_state(config, converter.num_classes, device)
    elif config.get("pretrained_weight"):
        load_pretrained_params(config["pretrained_weight"], state.model)
    criterion = criterion_from_config(config)
    model = state.model
    return TrainingBundle(config, converter, model, state, tx, criterion,
                          make_train_step(model, criterion, tx, config),
                          make_eval_step(model, criterion, config), start_iter, device,
                          resume_meta)


def _train_rank(config, log_dir: str) -> dict:
    """A rank ``train`` spawned: train in its group on its card."""
    return train(config, log_dir, device=str(meshlib.rank_device()))


def _log_placement(logger, mesh, model, config) -> None:
    """The mesh, and on a model axis how many leaves the JAX package's
    placement rule would shard there (the port replicates them)."""
    head = (f"sharded training over {mesh.nd}x{mesh.nm} (data x model) ranks "
            f"({mesh.backend})")
    if mesh.nm == 1:
        logger.info(head)
        return
    min_size = int(config.get("tp_min_size", 2**16))
    would = [k for k, p in model.named_parameters()
             if meshlib._param_spec(k, p, mesh.nm, min_size)]
    logger.info(f"{head}; model axis replicated: JAX's rule (tp_min_size {min_size}) would "
                f"shard {len(would)} leaves over it (ROADMAP A10)")


def train(config, log_dir: str = "saved_models/run", device="cuda",
          bundle: Optional[TrainingBundle] = None) -> dict:
    """The whole run; returns the last validation's metric dict.  A caller
    that passes ``bundle`` (from ``init_training``) keeps the trained state
    in it: the loop updates ``bundle.state`` in place.  On a host with more
    than one card (``use_dp``, the default) it trains one rank a card and
    returns rank 0's metrics (see the module's docstring)."""
    meshlib.join_from_env()
    if (meshlib.world_size() == 1 and bundle is None and torch.device(device).type == "cuda"
            and torch.cuda.device_count() > 1 and config.get("use_dp", True)):
        n = torch.cuda.device_count()
        print(f"training data-parallel over {n} cards, one rank a card", flush=True)
        return meshlib.spawn(_train_rank, [f"cuda:{i}" for i in range(n)],
                             (dict(config), log_dir))[0]
    if (meshlib.world_size() == 1 and torch.device(device).type == "cuda"
            and torch.cuda.device_count() > 1):
        print(f"training on one of {torch.cuda.device_count()} cards (use_dp: False, or the "
              "caller's bundle)", flush=True)
    mesh = None
    if meshlib.world_size() > 1:
        if not config.get("use_dp", True):
            raise ValueError(f"use_dp: False but this process is one of "
                             f"{meshlib.world_size()} ranks; start one process")
        shape = config.get("mesh_shape")
        mesh = meshlib.make_mesh(shape if isinstance(shape, dict) else None)
    lead = mesh is None or mesh.rank == 0
    logger = setup_logger(log_dir if lead else None,
                          name="doc2tex_tpu_torch" if lead else f"doc2tex_tpu_torch.rank{mesh.rank}")
    if not lead:
        logger.setLevel(logging.WARNING)
    b = bundle or init_training(config, device)
    if mesh is not None:
        b.train_step = make_train_step(b.model, b.criterion, b.tx, config, mesh=mesh)
        _log_placement(logger, mesh, b.model, config)
    logger.info(f"model: {param_count(b.model) / 1e6:.2f}M params, "
                f"num_class={b.converter.num_classes}")
    if lead:
        with open(os.path.join(log_dir, "config.txt"), "w") as f:
            f.write(repr(dict(config)))
    seed = config.get("manualSeed", 1111)
    train_loader, valid_loader = build_loader(
        config, b.converter, seed=seed, shard=None if mesh is None else (mesh.nd, mesh.data_index))
    logger.info(f"train: {train_loader.num_samples} samples in {len(train_loader.table)}-"
                f"shape ladder, {train_loader.batches_per_epoch()} batches/epoch; "
                f"valid: {valid_loader.num_samples}")
    if train_loader.batches_per_epoch() == 0:
        raise ValueError("train loader yields 0 batches/epoch: every sample was dropped by "
                         "bucket planning (too large for max_dimension, or no full batch "
                         "with keep_smaller_batches=False)")
    keeper = BestCheckpointKeeper(log_dir, write=lead)
    if b.resume_meta:
        keeper.seed_best(b.resume_meta)
    timer = StepTimer(device)
    val_mesh = mesh if config.get("val_use_mesh", True) else None
    decode_fn = make_decode_fn(b.model, config, beam_size=1, device=device, mesh=val_mesh)
    if val_mesh is not None:
        base_decode = decode_fn

        def decode_fn(images):
            # ragged eval tails: white rows up to the data axis, trimmed after
            nb = images.shape[0]
            tokens, aux = base_decode(meshlib.pad_rows(images, val_mesh.nd))
            return tokens[:nb], aux[:nb]

    last = _train_loop(b, config, train_loader, valid_loader, keeper, logger, log_dir, timer,
                       torch.Generator().manual_seed(seed + 1), decode_fn, lead)
    for key, row in timer.summary().items():
        logger.info(f"bucket {key}: {row}")
    return last


def _train_loop(b, config, train_loader, valid_loader, keeper, logger, log_dir, timer,
                generator, decode_fn, lead: bool = True) -> dict:
    num_iter, val_interval = config["num_iter"], config["valInterval"]
    log_interval = config.get("logInterval", 100)
    early_stop = config.get("early_stop", num_iter)
    sanity = config.get("sanity_check", False)
    state, loss_avg = b.state, Averager()
    seen: set = set()
    pending: list = []
    last: dict = {}
    best_step, it, t_start = 0, b.start_iter, time.time()
    data_iter = train_loader.infinite()
    while it < num_iter:
        batch = next(data_iter)
        # sync only on a bucket's first step and at log boundaries: a sync
        # per step would stop the host from queueing the next step's work
        first = batch.bucket not in seen
        seen.add(batch.bucket)
        sync = first or (it + 1) % log_interval == 0 or sanity
        with timer.step(batch.bucket) if sync else contextlib.nullcontext():
            # a sharded loader's batch is this rank's rows (``rows_of``)
            shard = {} if batch.rows_of is None else {"rows_of": batch.rows_of}
            metrics = b.train_step(state, batch.images, batch.text, generator, **shard)
        it += 1
        pending.append(metrics["loss"])
        if it % log_interval == 0 or sanity:
            for x in pending:
                loss_avg.add(float(x))
            pending.clear()
            logger.info(f"[{it}/{num_iter}] loss: {loss_avg.val():.5f} bucket: {batch.bucket} "
                        f"elapsed: {cal_elapsed_time(time.time() - t_start)}")
            loss_avg.reset()
        if it % val_interval == 0 or sanity or it == num_iter:
            val = validation(decode_fn, b.converter, valid_loader, config,
                             eval_step=b.eval_step, state=state,
                             max_batches=1 if sanity else None,
                             export_csv=(os.path.join(log_dir, f"preds_iter{it}.csv")
                                         if config.get("export_csv") and lead else None))
            last = val
            logger.info(f"validation @ {it}: loss {val['loss']:.4f} acc {val['accuracy']:.4f} "
                        f"bleu {val['bleu']:.4f} ED {val['ED']:.4f} "
                        f"wordED {val['word_ED']:.4f}")
            for line in val["worst"][:5]:
                logger.info(f"  worst: {line}")
            if lead:
                update_summary(it, {k: v for k, v in val.items() if isinstance(v, (int, float))},
                               os.path.join(log_dir, "summary.csv"))
            saved = keeper.update(state, it, val)
            if "best_bleu.msgpack" in saved or "best_accuracy.msgpack" in saved:
                best_step = it
            elif it - best_step >= early_stop:
                logger.info(f"early stop at {it} (no improvement since {best_step})")
                break
        if sanity:
            logger.info("sanity check complete")
            break
    return last
