"""Configuration: the JAX package's defaults and a small YAML reader.

``make_config`` layers a config mapping over the same defaults as
``doc2tex_tpu.config.make_config`` and returns a plain dict.  ``load_yaml``
reads the YAML subset the repository's configs are written in
(``demo/recog_cfg.yaml``, ``config/*.yaml``) and gives what
``yaml.safe_load`` gives on them:

- block mappings nested by indentation (``key: value`` / ``key:``);
- flow lists of scalars (``[a, b]``, ``[]``);
- single- or double-quoted and plain scalars;
- ``null``/``~``, YAML 1.1 booleans (``True``, ``false``, ``yes``, ``off``,
  ...), integers and floats;
- whole-line and trailing ``#`` comments.

Anything else (block sequences, flow mappings, anchors, tags, multi-line
scalars, tabs) raises ``ValueError``.
"""

from __future__ import annotations

import copy
import re
from typing import Any, Mapping

_DEFAULTS: dict[str, Any] = {
    "imgH": None,
    "imgW": None,
    "max_dimension": [800, 800],
    "min_dimension": [32, 32],
    "batch_max_length": 150,
    "keep_smaller_batches": True,
    "rgb": False,
    "mean": 0.5,
    "std": 0.5,
    "augment": False,
    "batch_size": 16,
    "workers": 0,
    "postprocess": False,
    "downsample": 1,
    "scale_factor": 32,
    "beam_size": 1,
    "token_level": "word",
    "accum_grad": 1,
    "pad": False,
    "sanity_check": False,
    "export_csv": False,
    "manualSeed": 1111,
    "grad_clip": 5.0,
    "valInterval": 5000,
    "logInterval": 100,
    "num_iter": 300000,
    "early_stop": 300000,
    "warmup_epochs": 5,
    "min_lr": 1e-5,
    "scheduler": True,
    "filter_bias_and_bn": True,
    "character": [],
    "dtype": "bfloat16",
    "param_dtype": "float32",
    "mesh_shape": None,
    "bucket_mode": "ladder",
    "bucket_growth": 1.5,
}


def make_config(overrides: Mapping[str, Any] | None = None) -> dict:
    cfg = copy.deepcopy(_DEFAULTS)
    if overrides:
        cfg.update(copy.deepcopy(dict(overrides)))
    return cfg


# --- YAML subset --------------------------------------------------------

_NULL = {"", "~", "null", "Null", "NULL"}
_TRUE = {"yes", "Yes", "YES", "true", "True", "TRUE", "on", "On", "ON"}
_FALSE = {"no", "No", "NO", "false", "False", "FALSE", "off", "Off", "OFF"}
# YAML 1.1 number forms as PyYAML's resolver accepts them (decimal only)
_INT = re.compile(r"[-+]?(0|[1-9][0-9_]*)$")
_FLOAT = re.compile(
    r"[-+]?([0-9][0-9_]*)?\.[0-9_]*([eE][-+][0-9]+)?$"
    r"|[-+]?[0-9][0-9_]*([eE][-+][0-9]+)$"
)
_KEY = re.compile(r"([A-Za-z_][A-Za-z0-9_.\-]*)\s*:(?:\s+|$)(.*)$")


def _strip_comment(text: str) -> str:
    """Drop a trailing ``# comment`` that lies outside quotes."""
    quote = None
    for i, c in enumerate(text):
        if quote:
            if c == quote:
                quote = None
        elif c in "'\"":
            quote = c
        elif c == "#" and (i == 0 or text[i - 1] in " \t"):
            return text[:i].rstrip()
    if quote:
        raise ValueError(f"unterminated quote in {text!r}")
    return text.rstrip()


def _scalar(text: str) -> Any:
    text = text.strip()
    if len(text) >= 2 and text[0] == text[-1] and text[0] in "'\"":
        body = text[1:-1]
        if text[0] == "'":
            if "'" in body.replace("''", ""):
                raise ValueError(f"unsupported quoted scalar {text!r}")
            return body.replace("''", "'")
        if "\\" in body or '"' in body:
            raise ValueError(f"unsupported escape in {text!r}")
        return body
    if text[:1] in ("'", '"', "[", "{", "&", "*", "!", "|", ">", "%", "@", "`"):
        raise ValueError(f"unsupported YAML scalar {text!r}")
    if text.startswith("- ") or text == "-":
        raise ValueError(f"block sequences are not supported: {text!r}")
    if text in _NULL:
        return None
    if text in _TRUE:
        return True
    if text in _FALSE:
        return False
    if _INT.match(text):
        return int(text.replace("_", ""))
    if _FLOAT.match(text) and text not in (".", "+.", "-."):
        return float(text.replace("_", ""))
    if ": " in text or " #" in text:
        raise ValueError(f"unsupported plain scalar {text!r}")
    return text


def _flow_list(text: str) -> list:
    body = text[1:-1].strip()
    if not body:
        return []
    if any(c in body for c in "[]{}"):
        raise ValueError(f"nested flow collections are not supported: {text!r}")
    items, cur, quote = [], "", None
    for c in body:
        if quote:
            cur += c
            if c == quote:
                quote = None
        elif c in "'\"":
            quote = c
            cur += c
        elif c == ",":
            items.append(cur)
            cur = ""
        else:
            cur += c
    items.append(cur)
    if items and not items[-1].strip():
        items.pop()  # trailing comma, as YAML allows
    return [_scalar(i) for i in items]


def _value(text: str) -> Any:
    if text.startswith("["):
        if not text.endswith("]"):
            raise ValueError(f"multi-line flow lists are not supported: {text!r}")
        return _flow_list(text)
    return _scalar(text)


def loads_yaml(text: str) -> Any:
    """Parse YAML text in the subset described in the module docstring."""
    lines = []
    for n, raw in enumerate(text.splitlines(), 1):
        if "\t" in raw[: len(raw) - len(raw.lstrip())]:
            raise ValueError(f"line {n}: tab indentation is not supported")
        body = _strip_comment(raw)
        if not body.strip():
            continue
        if body.strip() in ("---", "..."):
            raise ValueError(f"line {n}: multi-document YAML is not supported")
        lines.append((n, len(body) - len(body.lstrip(" ")), body.strip()))
    if not lines:
        return None

    root: dict = {}
    # stack of (indent of the keys of this mapping, mapping)
    stack: list[tuple[int, dict]] = [(lines[0][1], root)]
    pending: tuple[dict, str, int] | None = None  # mapping, key, parent indent
    for n, indent, body in lines:
        if pending is not None:
            parent, key, parent_indent = pending
            pending = None
            if indent > parent_indent:
                child: dict = {}
                parent[key] = child
                stack.append((indent, child))
            else:
                parent[key] = None
        while stack and indent < stack[-1][0]:
            stack.pop()
        if not stack or indent != stack[-1][0]:
            raise ValueError(f"line {n}: bad indentation")
        m = _KEY.match(body)
        if not m:
            raise ValueError(f"line {n}: unsupported YAML construct {body!r}")
        key, rest = m.group(1), m.group(2).strip()
        mapping = stack[-1][1]
        if key in mapping:
            raise ValueError(f"line {n}: duplicate key {key!r}")
        if rest:
            mapping[key] = _value(rest)
        else:
            pending = (mapping, key, indent)
    if pending is not None:
        pending[0][pending[1]] = None
    return root


def load_yaml(path: str) -> Any:
    with open(path, encoding="utf-8") as f:
        return loads_yaml(f.read())


def load_config(path: str, **overrides: Any) -> dict:
    """A YAML config file over the defaults, with ``overrides``; the
    min/max dimensions must be [H, W] multiples of ``scale_factor``."""
    cfg = make_config(load_yaml(path) or {})
    cfg.update(overrides)
    sf = cfg.get("scale_factor", 32)
    for key in ("max_dimension", "min_dimension"):
        dims = cfg.get(key)
        if dims is not None and len(dims) != 2:
            raise ValueError(f"{key} must be [H, W], got {dims!r}")
        if dims and any(d % sf for d in dims):
            raise ValueError(f"{key}={dims} must be divisible by scale_factor={sf}")
    return cfg
