"""Train CLI of the port, with the flags of ``api/train.py``:

    python -m doc2tex_tpu_torch.api.train --config config/train_hard_tfm_big.yaml
    python -m doc2tex_tpu_torch.api.train --config <cfg> --resume_path <dir>/last_checkpoint.msgpack
    python -m doc2tex_tpu_torch.api.train --config <cfg> --device cpu

The run writes to ``--log_dir`` (default ``saved_models/<config stem>``):
``config.txt``, ``log_train.txt``, ``summary.csv`` and the checkpoints
(``best_bleu``, ``best_accuracy``, ``last_checkpoint`` ``.msgpack`` with
``.json`` sidecars), which the JAX package's ``load_checkpoint`` reads.
On a host with more than one card it trains data-parallel, one process a
card (``use_dp``, on by default; ``mesh_shape`` and ``tp_min_size`` as in
the JAX configs), or joins the ranks torchrun started
(``torchrun --nproc_per_node N -m doc2tex_tpu_torch.api.train ...``); rank
0 writes the logs and checkpoints.
"""

from __future__ import annotations

import argparse
import os
from pathlib import Path


def main(argv=None) -> None:
    parser = argparse.ArgumentParser()
    parser.add_argument("--config", required=True, help="Path to config yaml file")
    parser.add_argument("--resume_path", type=str, default=None,
                        help="Path to checkpoint to continue training")
    parser.add_argument("--pretrained_weight", type=str, default=None,
                        help="Checkpoint for partial (strict=False) init")
    parser.add_argument("--log_dir", type=str, default=None,
                        help="Override the derived saved_models/<config-stem> log dir")
    # accepted as the JAX CLI accepts them (the config's dtype and
    # accum_grad decide precision and accumulation)
    parser.add_argument("--amp", action="store_true", default=False)
    parser.add_argument("--accum-grad", action="store_true", default=False)
    parser.add_argument("--compile", action="store_true", default=False)
    parser.add_argument("--platform", default=None,
                        help="the JAX CLI's platform switch; the port takes --device")
    parser.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    args = parser.parse_args(argv)
    if args.platform:
        parser.error("--platform selects a JAX platform; use --device cuda|cpu")

    from doc2tex_tpu_torch.config import load_config
    from doc2tex_tpu_torch.engine.training import train

    config = load_config(args.config)
    if args.resume_path:
        config["resume_path"] = args.resume_path
    if args.pretrained_weight:
        config["pretrained_weight"] = args.pretrained_weight
    log_dir = args.log_dir or os.path.join("saved_models", Path(args.config).stem)
    os.makedirs(log_dir, exist_ok=True)
    print("LOG DIR", log_dir)
    metrics = train(config, log_dir, device=args.device)
    print("final:", {k: v for k, v in metrics.items() if isinstance(v, (int, float))})


if __name__ == "__main__":
    main()
