"""Carry the JAX package's variables into the port's modules.

Input: the nested dict flax keeps (``{"params": ..., "batch_stats": ...,
"step": ...}``) of numpy arrays — read from a release msgpack by
``_msgpack.load`` or handed over by a test.  The port's modules are named
after the flax modules, so a flax leaf ``<collection>/a/b/leaf`` becomes the
state-dict key ``a.b.leaf``:

- conv kernels (4-D ``kernel``) turn from HWIO to OIHW;
- Dense kernels stay ``(in, out)`` (the port applies them as ``x @ W``);
- ``batch_stats`` ``mean``/``var`` are the BatchNorm running statistics;
- the heads' flat parameters (``predicter/<name>``) keep their names and
  layouts, the LSTM head's 3-D ``loc_conv_w`` (k, 1, Kd) included: the
  head applies it in that layout.

Every leaf but ``step`` must be consumed and every state-dict entry
filled; anything left over or missing raises.  Values are stored as
float32 (the release files hold float16).

The released detector (``saved_models/math_detect``) takes the same path:
``detection.ssd.SSD512`` names its layers as flax does (``Conv_0`` ...
``Conv_38``, ``L2Norm_0``), 79 leaves in all.

The other direction, for checkpoints the JAX package can read:
``to_variables`` gives a module's ``params`` (its parameters) and
``batch_stats`` (its persistent buffers, the BatchNorm running statistics)
as flax nested dicts of float32 numpy arrays, conv kernels back in HWIO;
``tree_to_flax``/``tree_from_flax`` do the same for any ``{state-dict key:
tensor}`` dict (an optimizer's moments).  ``convert_variables(to_variables(m))``
equals ``m.state_dict()`` bit for bit.

``random_variables`` draws a variable tree from numpy's generator, the
same with every torch: a seeded model where no weights exist.
"""

from __future__ import annotations

from collections.abc import Mapping

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


def _leaf_to_flax(path: tuple, tensor: torch.Tensor) -> np.ndarray:
    arr = tensor.detach().to("cpu", torch.float32).numpy().copy()
    if path[-1] == "kernel" and arr.ndim == 4:
        arr = np.ascontiguousarray(arr.transpose(2, 3, 1, 0))   # OIHW -> HWIO
    return arr


def tree_to_flax(named) -> dict:
    """``{state-dict key: tensor}`` -> flax nested dict of numpy arrays."""
    out: dict = {}
    for key, tensor in named.items():
        path = tuple(key.split("."))
        node = out
        for part in path[:-1]:
            node = node.setdefault(part, {})
        node[path[-1]] = _leaf_to_flax(path, tensor)
    return out


def tree_from_flax(tree: dict, like) -> dict[str, torch.Tensor]:
    """A flax nested dict back to ``{key: tensor}`` with the keys, shapes,
    types and devices of ``like``; a missing, extra or misshapen leaf raises."""
    flat = {".".join(path): leaf for path, leaf in _flatten(tree).items()}
    if set(flat) != set(like):
        raise ValueError(f"tree does not fit: missing {sorted(set(like) - set(flat))[:8]}, "
                         f"unexpected {sorted(set(flat) - set(like))[:8]}")
    out = {}
    for key, ref in like.items():
        arr = np.array(flat[key], dtype=np.float32)
        if key.split(".")[-1] == "kernel" and arr.ndim == 4:
            arr = arr.transpose(3, 2, 0, 1)          # HWIO -> OIHW
        if tuple(arr.shape) != tuple(ref.shape):
            raise ValueError(f"{key}: expected shape {tuple(ref.shape)}, got {arr.shape}")
        out[key] = torch.from_numpy(np.ascontiguousarray(arr)).to(ref.device, ref.dtype)
    return out


def to_variables(module: torch.nn.Module) -> dict:
    """``module``'s flax variables: ``{"params": ..., "batch_stats": ...}``."""
    params = dict(module.named_parameters())
    stats = {k: v for k, v in module.state_dict().items() if k not in params}
    return {"params": tree_to_flax(params), "batch_stats": tree_to_flax(stats)}


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
    """Read a flax msgpack checkpoint and load it into ``module``.  A
    training checkpoint's ``opt_state`` (``train/checkpoint.py``) is not
    part of the model and is skipped."""
    variables = _msgpack.load(path)
    variables.pop("opt_state", None)
    return load_variables(module, variables)


def random_variables(tree: dict, rng: np.random.Generator) -> dict:
    """Flax variables shaped as ``tree`` (a nested dict whose leaves have a
    ``shape``: ``to_variables``' arrays, or the JAX package's shape structs)
    with every leaf drawn from ``rng`` in the tree's order: kernels normal
    at fan-in scale (flax layout, inputs first), BatchNorm variances uniform
    in [0.5, 1.5] and scales about 1, other leaves normal of std 0.1.
    Unlike torch's seeded init, whose draws differ between torch versions,
    one seed gives the same weights everywhere."""
    out = {}
    for name, leaf in tree.items():
        shape = tuple(getattr(leaf, "shape", ()))
        if isinstance(leaf, Mapping):
            out[name] = random_variables(leaf, rng)
        elif name == "var":
            out[name] = rng.uniform(0.5, 1.5, shape).astype(np.float32)
        elif name == "scale":
            out[name] = (1.0 + rng.normal(0.0, 0.1, shape)).astype(np.float32)
        elif len(shape) >= 2 and name not in ("cls_token", "pos_embed"):
            fan_in = int(np.prod(shape[:-1]))
            out[name] = rng.normal(0.0, fan_in ** -0.5, shape).astype(np.float32)
        else:
            out[name] = rng.normal(0.0, 0.1, shape).astype(np.float32)
    return out
