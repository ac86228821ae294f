"""Export a training checkpoint as shippable recognizer weights (the port's
twin of the repository's ``tools/export_demo_weights.py``).

    python -m doc2tex_tpu_torch.tools.export_demo_weights --ckpt CKPT.msgpack
        [--out saved_models/math_recog/synthetic/best_weights.msgpack]
        [--dtype float16|float32]

Takes a full TrainState checkpoint (the port's ``train/checkpoint.py`` or
the JAX package's: the same flax msgpack tree), drops the optimizer state,
casts the float32 parameters to ``--dtype`` (integer leaves such as
``step`` stay; the BatchNorm statistics stay float32) and writes a
weights-only flax msgpack that ``load_pretrained_variables`` of either
package, and so ``MathRecognition`` and ``api.infer``, restore, with a
``.json`` sidecar: the source, its sidecar, the parameter count, the dtype
and the file's size.  A relative ``--out`` is taken from the repository's
root, as the JAX tool takes it.  Host code only: no card is needed.
"""

from __future__ import annotations

import argparse
import json
import os

import numpy as np

from .. import _msgpack

_ROOT = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))


def _map(tree, fn):
    if isinstance(tree, dict):
        return {k: _map(v, fn) for k, v in tree.items()}
    return fn(tree)


def _leaves(tree):
    if isinstance(tree, dict):
        for v in tree.values():
            yield from _leaves(v)
    else:
        yield tree


def export(ckpt: str, out: str, dtype: str = "float16") -> dict:
    """Write ``ckpt``'s parameters (cast to ``dtype``) and BatchNorm
    statistics to ``out`` and its sidecar; returns the sidecar's dict."""
    payload = _msgpack.load(ckpt)
    cast = np.dtype(dtype)

    def _cast(x):
        x = np.asarray(x)
        return x.astype(cast) if x.dtype == np.float32 else x

    slim = {"step": np.asarray(payload.get("step", 0)),
            "params": _map(payload["params"], _cast),
            "batch_stats": payload.get("batch_stats", {})}
    os.makedirs(os.path.dirname(out) or ".", exist_ok=True)
    _msgpack.save(out, slim)
    meta = {}
    if os.path.exists(ckpt + ".json"):
        with open(ckpt + ".json") as f:
            meta = json.load(f)
    info = {"source": ckpt, "source_meta": meta,
            "params": sum(int(np.asarray(x).size) for x in _leaves(payload["params"])),
            "dtype": dtype, "bytes": os.path.getsize(out)}
    with open(out + ".json", "w") as f:
        json.dump(info, f, indent=2, default=float)
    return info


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--ckpt", default="/tmp/hard_soak/best.msgpack")
    ap.add_argument("--out", default="saved_models/math_recog/synthetic/best_weights.msgpack")
    ap.add_argument("--dtype", default="float16", choices=["float16", "float32"])
    args = ap.parse_args(argv)
    out = args.out if os.path.isabs(args.out) else os.path.join(_ROOT, args.out)
    print(json.dumps(export(args.ckpt, out, args.dtype), indent=2, default=float))


if __name__ == "__main__":
    main()
