"""What the ranks of ``tests/test_torch_port_mesh.py`` run.

Every function here runs in a spawned rank (``parallel.mesh.spawn``) and
returns plain data; this module imports torch, numpy and the port only, so a
rank never imports jax (each function asserts it)."""

from __future__ import annotations

import os
import sys
import time

import numpy as np
import torch

from doc2tex_tpu_torch.parallel import mesh as meshlib

MIN_GATES = 1     # the int8 gates of test_int8_recognition_flow_over_mesh
TRAIN_VOCAB = 24  # the train-step cases' classes (tests/test_torch_port_train.py)


def _no_jax() -> None:
    assert "jax" not in sys.modules, "a rank imported jax"


def variables_for(cfg, seed: int, num_class=None) -> dict:
    """numpy draws (``weights.random_variables``) for every leaf of the
    config's model (``num_class`` from its converter unless given)."""
    from doc2tex_tpu_torch.config import make_config
    from doc2tex_tpu_torch.models import build_model
    from doc2tex_tpu_torch.tokenizer.converters import create_converter
    from doc2tex_tpu_torch.weights import random_variables, to_variables

    cfg = make_config(dict(cfg))
    num_class = num_class or create_converter(cfg).num_classes
    return random_variables(to_variables(build_model(cfg, num_class)),
                            np.random.default_rng(seed))


def recognizers(cfg, variables, mesh=None, gates=None):
    """(float32 beam-2 recognizer, int8 greedy recognizer) with
    ``variables``, on the CPU; ``gates`` sets the int8 shape gates."""
    from doc2tex_tpu_torch.config import make_config
    from doc2tex_tpu_torch.ops import quant
    from doc2tex_tpu_torch.recognition import MathRecognition
    from doc2tex_tpu_torch.weights import load_variables

    if gates is not None:
        quant.MIN_CONTRACT = quant.MIN_OUT = gates
    rec = MathRecognition(make_config(dict(cfg)), beam_size=2, device="cpu", mesh=mesh)
    load_variables(rec.model, variables)
    qcfg = dict(cfg, quantize="int8")
    rec8 = MathRecognition(make_config(qcfg), device="cpu", mesh=mesh)
    load_variables(rec8.model, variables)
    return rec, rec8


def detectors(weights, mesh=None, **kw):
    """(device-window, host-window) detectors of ``weights`` on the CPU."""
    from doc2tex_tpu_torch.detection.flow import MathDetector

    return (MathDetector(weights, batch_size=2, mesh=mesh, device="cpu", **kw),
            MathDetector(weights, batch_size=2, device_windows=False, mesh=mesh, device="cpu",
                         **kw))


def inference_rank(cfg, variables, crops, int8_crop, det_weights, page, det_kw) -> dict:
    """Single controller over {"data": 2}: rank 0 recognizes and detects,
    rank 1 follows; every rank records its int8 activation scales."""
    from doc2tex_tpu_torch.ops.quant import recorded_scales

    _no_jax()
    mesh = meshlib.make_mesh({"data": 2})
    rec, rec8 = recognizers(cfg, variables, mesh, MIN_GATES)
    dev, host = detectors(det_weights, mesh, **det_kw)
    out = {"rank": mesh.rank, "batch_size": host.batch_size}
    with recorded_scales() as scales:
        if mesh.rank == 0:
            out["strings"] = rec(crops)
            out["single"] = rec(crops[0])
            out["int8"] = rec8(int8_crop)
            out["device_windows"] = dev.detect_page(page)
            out["host_windows"] = host.detect_page(page)
            mesh.stop_followers()
        else:
            mesh.follow()
    out["scales"] = list(scales)
    _no_jax()
    return out


def _model(cfg, variables):
    from doc2tex_tpu_torch.config import make_config
    from doc2tex_tpu_torch.models import build_model
    from doc2tex_tpu_torch.weights import load_variables

    cfg = make_config(dict(cfg))
    torch.manual_seed(0)
    model = build_model(cfg, TRAIN_VOCAB)
    load_variables(model, variables)
    return cfg, model


def _stats(model) -> dict:
    return {k: b.detach().numpy().copy() for k, b in model.named_buffers()
            if k.endswith((".mean", ".var"))}


def train_step_case(cfg, variables, images, text, mesh=None) -> dict:
    """One train step (``make_train_step``) and, on a fresh copy of the
    model, ``loss_and_grads`` with the same draws (the step's gradient).
    ``images``/``text`` are the global batch, padded to the data axis."""
    from doc2tex_tpu_torch.train.trainer import (create_train_state, criterion_from_config,
                                                 loss_and_grads, make_train_step,
                                                 step_generator)
    from doc2tex_tpu_torch.transforms.augment import normalize, train_augment

    cfg, model = _model(cfg, variables)
    criterion = criterion_from_config(cfg)
    gen = torch.Generator().manual_seed(5)
    n = images.shape[0]
    local_images, local_text = (images, text) if mesh is None else meshlib.shard_batch(
        (images, text), mesh)
    x = torch.from_numpy(local_images)
    with meshlib.activation_mesh(mesh), meshlib.batch_rows(mesh, n):
        if cfg.get("augment"):
            x = train_augment(step_generator(gen, 0, 0, "cpu"), x)
        else:
            x = normalize(x)
        loss, _, grads = loss_and_grads(model, criterion, x, torch.from_numpy(local_text).long(),
                                        step_generator(gen, 0, 1, "cpu"), mesh)
    out = {"grad_loss": float(loss), "grads": {k: g.numpy().copy() for k, g in grads.items()}}
    cfg, model = _model(cfg, variables)
    state, tx = create_train_state(model, cfg)
    metrics = make_train_step(model, criterion, tx, cfg, mesh=mesh)(state, images, text, gen)
    out.update({k: float(v) for k, v in metrics.items()})
    out["stats"] = _stats(model)
    out["params"] = {k: p.detach().numpy().copy() for k, p in model.named_parameters()}
    return out


def resnet_case(variables, block_variables, x64, w64, xb, wb, mesh=None) -> dict:
    """The whole FANResNet in float64 and one BasicBlock in float32, in
    training mode on this rank's rows: output rows, input-gradient rows,
    every parameter's gradient (summed over the data axis) and the
    running statistics.  The objectives are sum(y * w) over the rows."""
    from doc2tex_tpu_torch.models.resnet import BasicBlock, FANResNet
    from doc2tex_tpu_torch.train.trainer import reduce_gradients
    from doc2tex_tpu_torch.weights import load_variables

    out = {}
    for tag, net, x, w, vs in (
            ("resnet64", lambda: FANResNet(1, 64, dtype=torch.float64), x64, w64, variables),
            ("block32", lambda: BasicBlock(6, 8, torch.float32), xb, wb, block_variables)):
        module = net()
        load_variables(module, vs)
        if tag == "resnet64":
            module = module.double()
        if mesh is not None:
            x, w = meshlib.shard_batch((x, w), mesh)
        xt = torch.from_numpy(x).requires_grad_()
        with meshlib.activation_mesh(mesh):
            y = module(xt, True)
            (y * torch.from_numpy(w)).sum().backward()
        grads = {k: p.grad for k, p in module.named_parameters()}
        if mesh is not None:
            grads = reduce_gradients(grads, mesh)
        out[tag] = {"y": y.detach().numpy().copy(), "gx": xt.grad.numpy().copy(),
                    "grads": {k: g.numpy().copy() for k, g in grads.items()},
                    "stats": _stats(module)}
    return out


def train_rank(cases: dict, resnet_args: tuple) -> dict:
    """Every train-step case of ``cases`` (name -> (cfg, variables, images,
    text)) and the ResNet case, over this group's mesh ({"data": 2})."""
    _no_jax()
    mesh = meshlib.make_mesh({"data": 2})
    out = {name: train_step_case(*args, mesh=mesh) for name, args in cases.items()}
    out["resnet"] = resnet_case(*resnet_args, mesh=mesh)
    out["rank"] = mesh.rank
    _no_jax()
    return out


def mesh_loss_rank(mesh_shape, cfg, variables, images, text) -> dict:
    """The train step's metrics, gradient and result over ``mesh_shape``."""
    _no_jax()
    mesh = meshlib.make_mesh(mesh_shape)
    out = train_step_case(cfg, variables, images, text, mesh)
    return {k: out[k] for k in ("loss", "grad_norm", "token_acc", "stats", "params", "grads")
            } | {"shape": dict(mesh.shape)}


def engine_rank(cfg, log_dir) -> dict:
    """``engine.training.train`` on this rank (the group's mesh)."""
    from doc2tex_tpu_torch.engine.training import train

    _no_jax()
    return train(dict(cfg), log_dir, device="cpu")


def infer_run(cfg, crops, labels, ranks) -> dict:
    """``api.infer.run_infer`` over ``ranks`` CPU ranks (rank 0 is this
    process, the followers its children)."""
    from doc2tex_tpu_torch.api.infer import run_infer
    from doc2tex_tpu_torch.config import make_config
    from doc2tex_tpu_torch.data.loader import ArrayDataset

    _no_jax()
    result = run_infer(make_config(dict(cfg)), ArrayDataset(crops, labels), device="cpu",
                       ranks=ranks)
    return {k: result[k] for k in ("n_samples", "accuracy", "bleu", "ED", "word_ED")} | {
        "preds": [p for _, _, p in result.get("samples", [])]}


def idle_follower(mesh, seconds: float) -> None:
    """A ``lead`` follower that joins no collective after the start: only
    its watch of rank 0's process can end it early."""
    time.sleep(seconds)


def lead_then_hang(pid_path: str) -> None:
    """Rank 0 of two CPU ranks (``parallel.mesh.lead``): writes its
    follower's pid to ``pid_path`` and waits to be killed."""
    _no_jax()
    mesh = meshlib.lead(["cpu", "cpu"], idle_follower, (600,), threads=1)
    with open(pid_path + ".tmp", "w") as f:
        f.write(str(mesh._followers[0].pid))
    os.replace(pid_path + ".tmp", pid_path)
    time.sleep(600)
