"""One sharded training run over an n-rank mesh (counterpart of the
repository's ``__graft_entry__.dryrun_multichip(n)``):

    python -m doc2tex_tpu_torch.tools.dryrun_multichip [N] [--device cuda|cpu]

The mesh is ``{"data": n/2, "model": 2}`` for an even n >= 4 (the model
axis replicates), else ``{"data": n}``.  The model is the flagship at its tiny size (a ViT 128x2
over a 256-channel ResNet, the coverage-attention LSTM head at kernel_dim
64, ``batch_max_length`` 16, adamw at 3e-3, augmentation on), the batch 4
images a data rank at 64x256 with learnable labels (a fixed 4-token cycle).
Checks: 6 steps on the batch must descend, and a checkpoint saved by rank 0
and restored into a fresh state on every rank must take the same next step
as the live state (loss within 1e-4).

The ranks go on the visible cards in turn: one a card when there are n
cards (NCCL), else ranks sharing a card (gloo).  ``--device cpu`` runs n CPU
ranks over gloo, as the JAX dryrun re-execs onto virtual CPU devices; with
no card and no ``--device cpu`` it stops.  Prints one line with the losses
and each rank's kernel launches; exits non-zero when a check fails.
"""

from __future__ import annotations

import argparse
import os
import sys
import tempfile

import numpy as np
import torch

from ..parallel import mesh as meshlib

B_PER_SHARD, H, W = 4, 64, 256
STEPS = 6
RESTORE_TOL = 1e-4


def flagship_config() -> dict:
    """The flagship recipe at its tiny size (``__graft_entry__._flagship_config(tiny=True)``)."""
    from ..config import make_config
    from ..data.synthetic import SYNTH_VOCAB

    return make_config({
        "max_dimension": [64, 256],
        "min_dimension": [32, 32],
        "batch_max_length": 16,
        "character": list(SYNTH_VOCAB),
        "FeatureExtraction": {"name": "None"},
        "SequenceModeling": {"name": "ViT", "params": {
            "backbone": {"name": "resnet", "input_channel": 1, "output_channel": 256,
                         "gcb": False},
            "fix_embed": True, "input_channel": 1, "patching_style": "2d",
            "patch_size": [2, 2], "depth": 2, "num_heads": 8, "hidden_size": 128}},
        "Prediction": {"name": "Attnv2", "params": {
            "seqmodel": "TFM", "input_size": 128, "hidden_size": 128, "kernel_size": 2,
            "kernel_dim": 64, "embed_target": True, "enc_init": True,
            "attn_type": "coverage", "droprate": 0.1}},
        "criterion": {"name": "entropy"},
        "optimizer": {"opt": "adamw", "lr": 3e-3, "weight_decay": 2e-6},
        "augment": True,
        "num_iter": 1000,
        "valInterval": 100,
    })


def mesh_shape_for(n: int) -> dict:
    return {"data": n // 2, "model": 2} if n >= 4 and n % 2 == 0 else {"data": n, "model": 1}


def kernel_launches() -> dict:
    """B1's and B2's (forward, every form, and backward) launch counts."""
    from ..ops import attention_step as b2
    from ..ops.decode_attention import decode_attention

    return {"B1": decode_attention.launches + decode_attention.int8_launches,
            "B2": b2.coverage_attention_step.launches + b2.coverage_attention_step.int8_launches
            + b2.content_attention_step.launches + b2.content_attention_step.int8_launches
            + b2.fused_attention_step.launches,
            "B2_backward": b2.coverage_attention_step_backward.launches
            + b2.content_attention_step_backward.launches}


def _state(cfg, num_classes, device, seed):
    from ..models import build_model
    from ..train.trainer import create_train_state

    with torch.random.fork_rng(devices=[]):
        torch.manual_seed(seed)
        model = build_model(cfg, num_classes)
    return create_train_state(model.to(device), cfg)


def rank_run(mesh_shape: dict, ckpt_dir: str) -> dict:
    """One rank's run (every rank calls it inside its process group)."""
    from ..tokenizer.converters import AttnLabelConverter
    from ..train.checkpoint import load_checkpoint, save_checkpoint
    from ..train.trainer import criterion_from_config, make_train_step

    mesh = meshlib.make_mesh(mesh_shape)
    device = meshlib.rank_device()
    cfg = flagship_config()
    conv = AttnLabelConverter(cfg["character"])
    state, tx = _state(cfg, conv.num_classes, device, 0)
    criterion = criterion_from_config(cfg)
    step = make_train_step(state.model, criterion, tx, cfg, mesh=mesh)
    B = B_PER_SHARD * mesh.nd
    images = np.random.default_rng(0).integers(0, 255, (B, H, W, 1), dtype=np.uint8)
    width = cfg["batch_max_length"] + 2
    text = np.tile(np.arange(width, dtype=np.int32) % 4 + 2, (B, 1))
    text[:, 0] = 1
    before = kernel_launches()
    losses = [float(step(state, images, text, torch.Generator().manual_seed(1 + k))["loss"])
              for k in range(STEPS)]
    launches = {k: v - before[k] for k, v in kernel_launches().items()}

    path = os.path.join(ckpt_dir, "dryrun.msgpack")
    if mesh.rank == 0:
        save_checkpoint(path, state, {"iter": len(losses)})
    if mesh.size > 1:
        torch.distributed.barrier()   # the file is whole before any rank reads it
    loss_cont = float(step(state, images, text, torch.Generator().manual_seed(99))["loss"])
    fresh, fresh_tx = _state(cfg, conv.num_classes, device, 3)
    restored, meta = load_checkpoint(path, fresh)
    step_rest = make_train_step(restored.model, criterion, fresh_tx, cfg, mesh=mesh)
    loss_rest = float(step_rest(restored, images, text,
                                torch.Generator().manual_seed(99))["loss"])
    return {"rank": mesh.rank, "mesh": dict(mesh.shape), "backend": mesh.backend,
            "device": str(device), "losses": losses, "loss_cont": loss_cont,
            "loss_rest": loss_rest, "iter": int(meta.get("iter", -1)), "launches": launches}


def check(results: list) -> str:
    """Raise unless every rank's run passed; the summary line."""
    r0 = results[0]
    for r in results:
        losses = r["losses"]
        if not all(np.isfinite(losses)):
            raise AssertionError(f"rank {r['rank']}: non-finite losses {losses}")
        if not losses[-1] < losses[0] - 0.01:
            raise AssertionError(f"rank {r['rank']}: no descent over {STEPS} steps: {losses}")
        if abs(r["loss_cont"] - r["loss_rest"]) >= RESTORE_TOL:
            raise AssertionError(f"rank {r['rank']}: restore diverged: continue "
                                 f"{r['loss_cont']:.6f} restored {r['loss_rest']:.6f}")
        if r["losses"] != r0["losses"]:
            raise AssertionError(f"ranks 0 and {r['rank']} logged other losses")
    return (f"dryrun_multichip(n={len(results)}) ok: mesh={r0['mesh']} backend={r0['backend']} "
            f"devices={[r['device'] for r in results]} "
            f"losses={['%.4f' % v for v in r0['losses']]} restore_step={r0['loss_rest']:.4f} "
            f"(continue={r0['loss_cont']:.4f}, iter={r0['iter']}) "
            f"launches={[r['launches'] for r in results]}")


def devices_for(n: int, device: str = "cuda") -> list:
    """The n ranks' devices: the visible cards in turn, or with ``device``
    "cpu" the CPU."""
    if device == "cpu":
        return ["cpu"] * n
    have = torch.cuda.device_count() if torch.cuda.is_available() else 0
    if not have:
        raise SystemExit("no card visible: pass --device cpu to run the ranks on the CPU")
    return [f"cuda:{i % have}" for i in range(n)]


def dryrun_multichip(n: int, device: str = "cuda", time_limit: float = 1200.0) -> list:
    """Run the dryrun over n ranks; returns every rank's result after
    ``check``."""
    devices = devices_for(n, device)
    # CPU ranks share the host's cores (each at every core, they take minutes)
    threads = max(1, (os.cpu_count() or 1) // n) if devices[0] == "cpu" else None
    with tempfile.TemporaryDirectory() as ckpt_dir:
        results = meshlib.spawn(rank_run, devices, (mesh_shape_for(n), ckpt_dir),
                                time_limit=time_limit, threads=threads)
    print(check(results), flush=True)
    return results


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("n", type=int, nargs="?", default=None,
                    help="ranks (default: the visible cards, at least 2)")
    ap.add_argument("--device", default="cuda", choices=["cuda", "cpu"])
    args = ap.parse_args(argv)
    n = args.n or max(2, torch.cuda.device_count() if torch.cuda.is_available() else 0)
    dryrun_multichip(n, args.device)
    return 0


if __name__ == "__main__":
    sys.exit(main())
