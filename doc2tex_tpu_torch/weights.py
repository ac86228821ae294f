"""Carry the JAX package's variables into the port's modules.

Input: the nested dict flax keeps (``{"params": ..., "batch_stats": ...,
"step": ...}``) of numpy arrays — read from a release msgpack by
``_msgpack.load`` or handed over by a test.  The port's modules are named
after the flax modules, so a flax leaf ``<collection>/a/b/leaf`` becomes the
state-dict key ``a.b.leaf``:

- conv kernels (4-D ``kernel``) turn from HWIO to OIHW;
- Dense kernels stay ``(in, out)`` (the port applies them as ``x @ W``);
- ``batch_stats`` ``mean``/``var`` are the BatchNorm running statistics.

Every leaf but ``step`` must be consumed and every state-dict entry
filled; anything left over or missing raises.  Values are stored as
float32 (the release files hold float16).
"""

from __future__ import annotations

import numpy as np
import torch

from . import _msgpack


def _flatten(tree: dict, prefix: tuple = ()) -> dict:
    out = {}
    for k, v in tree.items():
        if isinstance(v, dict):
            out.update(_flatten(v, prefix + (k,)))
        else:
            out[prefix + (k,)] = v
    return out


def convert_variables(variables: dict) -> dict[str, torch.Tensor]:
    """flax variables -> {state-dict key: float32 tensor}."""
    extra = set(variables) - {"params", "batch_stats", "step"}
    if extra:
        raise ValueError(f"unexpected top-level collections {sorted(extra)}")
    out: dict[str, torch.Tensor] = {}
    for collection in ("params", "batch_stats"):
        for path, leaf in _flatten(variables.get(collection, {})).items():
            key = ".".join(path)
            if key in out:
                raise ValueError(f"{collection}/{'/'.join(path)} collides with another leaf")
            arr = np.array(leaf, dtype=np.float32)  # copies: the source may be read-only
            if path[-1] == "kernel" and arr.ndim == 4:
                arr = arr.transpose(3, 2, 0, 1)      # HWIO -> OIHW
            out[key] = torch.from_numpy(np.ascontiguousarray(arr))
    return out


def load_variables(module: torch.nn.Module, variables: dict) -> int:
    """Copy flax ``variables`` into ``module``; returns the leaf count.

    Raises if a leaf has no place in the module, a module entry gets no
    leaf, or a shape differs."""
    converted = convert_variables(variables)
    target = module.state_dict()
    missing = sorted(set(target) - set(converted))
    unused = sorted(set(converted) - set(target))
    if missing or unused:
        raise ValueError(f"weights do not fit the model: missing {missing[:8]} "
                         f"({len(missing)}), unused {unused[:8]} ({len(unused)})")
    for key, value in converted.items():
        if tuple(target[key].shape) != tuple(value.shape):
            raise ValueError(f"{key}: model shape {tuple(target[key].shape)}, "
                             f"weights shape {tuple(value.shape)}")
    module.load_state_dict(converted, strict=True)
    return len(converted)


def load_weights(module: torch.nn.Module, path: str) -> int:
    """Read a flax msgpack checkpoint and load it into ``module``."""
    return load_variables(module, _msgpack.load(path))
