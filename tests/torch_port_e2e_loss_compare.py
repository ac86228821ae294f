"""Training-loss curves of the end-to-end demo's model, the JAX package's
loop against the port's: the configuration of ``tools/e2e_demo.py``
(``--recipe e2e``: ``doc2tex_tpu_torch.tools.e2e_demo.demo_config``, its
data ``synth_dataset(4096, seed=21)``, augmentation on) or of
``tools/convergence_soak.py`` (``--recipe convergence``: the same model
overfitting ``synth_dataset(64, seed=11)`` at batch 16, augmentation off,
8,000 steps; JAX's record: loss 4.16 -> 0.26, train exact match 0.938),
each package with its own seeded init and draws.  Prints the mean loss of
every 25 steps (the curves share the data, not the draws: they agree in
trend, not in bits) and, with ``--recipe convergence``, the greedy exact
match on the 64 training samples at the end.

    PYTHONPATH=. python tests/torch_port_e2e_loss_compare.py jax|port
        [--recipe e2e|convergence] [--steps N] [--device cpu|cuda]

(the port ~1.7 s a step on this CPU, JAX longer with its compiles; JAX
runs on the CPU only; not collected by pytest).
"""

from __future__ import annotations

import argparse
import os
import sys
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)


def _report(tag, losses, it, t0):
    print(f"{tag} [{it}] mean loss {sum(losses) / len(losses):.4f} "
          f"({time.time() - t0:.0f}s)", flush=True)


def recipe(name: str, steps: int) -> tuple[dict, dict]:
    """(the configuration as a plain dict, the data's ``synth_dataset``
    arguments) of ``name``."""
    from doc2tex_tpu_torch.tools.e2e_demo import SAMPLE_KW, demo_config

    if name == "e2e":
        return dict(demo_config(3000)), dict(n=4096, seed=21, **SAMPLE_KW)
    cfg = dict(demo_config(steps))
    cfg.update(batch_size=16, augment=False, valInterval=500)
    return cfg, dict(n=64, seed=11, **SAMPLE_KW)


def run_jax(steps: int, name: str) -> None:
    import jax
    import jax.numpy as jnp

    jax.config.update("jax_platforms", "cpu")
    from doc2tex_tpu.config import make_config
    from doc2tex_tpu.data.loader import ArrayDataset, BucketLoader
    from doc2tex_tpu.data.synthetic import SYNTH_VOCAB, synth_dataset
    from doc2tex_tpu.models import build_model
    from doc2tex_tpu.tokenizer.converters import AttnLabelConverter
    from doc2tex_tpu.train.trainer import (create_train_state, criterion_from_config,
                                           make_train_step)

    raw, data = recipe(name, steps)
    cfg = make_config(raw)
    images, labels = synth_dataset(**data)
    conv = AttnLabelConverter(SYNTH_VOCAB)
    loader = BucketLoader(ArrayDataset(images, labels), conv, cfg, train=True)
    model = build_model(cfg, conv.num_classes)
    state, tx = create_train_state(model, cfg, jax.random.PRNGKey(0),
                                   (cfg["batch_size"], 64, 64, 1))
    step = make_train_step(model, criterion_from_config(cfg), tx, cfg)
    rng = jax.random.PRNGKey(7)
    t0, it, losses = time.time(), 0, []
    for batch in loader.infinite():
        state, m = step(state, jnp.asarray(batch.images), jnp.asarray(batch.text), rng)
        it += 1
        losses.append(float(m["loss"]))
        if it % 25 == 0:
            _report("jax", losses, it, t0)
            losses = []
        if it >= steps:
            break
    if name == "convergence":
        from doc2tex_tpu.engine.inferencing import validation

        res = validation(model, state, conv, BucketLoader(ArrayDataset(images, labels), conv, cfg,
                                                          train=False, prefetch=0), cfg)
        print(f"jax train-set greedy exact match {res['accuracy']:.4f} after {it} steps, "
              f"{it / (time.time() - t0):.2f} steps/s", flush=True)


def run_port(steps: int, name: str, device: str) -> None:
    import torch

    from doc2tex_tpu_torch.config import make_config
    from doc2tex_tpu_torch.data.loader import ArrayDataset, BucketLoader
    from doc2tex_tpu_torch.data.synthetic import SYNTH_VOCAB, synth_dataset
    from doc2tex_tpu_torch.decode.runner import make_decode_fn
    from doc2tex_tpu_torch.engine.inferencing import validation
    from doc2tex_tpu_torch.models import build_model
    from doc2tex_tpu_torch.tokenizer.converters import AttnLabelConverter
    from doc2tex_tpu_torch.train.trainer import (create_train_state, criterion_from_config,
                                                 make_train_step)

    raw, data = recipe(name, steps)
    cfg = make_config(raw)
    images, labels = synth_dataset(**data)
    conv = AttnLabelConverter(SYNTH_VOCAB)
    loader = BucketLoader(ArrayDataset(images, labels), cfg, conv, train=True)
    torch.manual_seed(0)
    model = build_model(cfg, conv.num_classes).to(device)
    state, tx = create_train_state(model, cfg)
    step = make_train_step(model, criterion_from_config(cfg), tx, cfg)
    generator = torch.Generator().manual_seed(7)
    t0, it, losses = time.time(), 0, []
    for batch in loader.infinite():
        m = step(state, batch.images, batch.text, generator)
        it += 1
        losses.append(float(m["loss"]))
        if it % 25 == 0:
            _report("port", losses, it, t0)
            losses = []
        if it >= steps:
            break
    if name == "convergence":
        res = validation(make_decode_fn(model, cfg, beam_size=1, device=device), conv,
                         BucketLoader(ArrayDataset(images, labels), cfg, conv), cfg)
        print(f"port train-set greedy exact match {res['accuracy']:.4f} after {it} steps, "
              f"{it / (time.time() - t0):.2f} steps/s", flush=True)


if __name__ == "__main__":
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("package", choices=["jax", "port"])
    ap.add_argument("--recipe", default="e2e", choices=["e2e", "convergence"])
    ap.add_argument("--steps", type=int, default=300)
    ap.add_argument("--device", default="cpu", help="the port's device")
    args = ap.parse_args()
    if args.package == "jax":
        run_jax(args.steps, args.recipe)
    else:
        run_port(args.steps, args.recipe, args.device)
