"""Reference PyTorch checkpoints into the port (twin of
``doc2tex_tpu/tools/torch_import.py``).

Maps a reference ``Model`` state_dict (``doc2tex/modules/build_model.py``)
onto the port's modules for the architecture family the JAX importer takes:
the hybrid-ResNet ViT encoder (the FAN ResNet with its GCB blocks, the
patch conv, a fixed or a learned position table) and the Attn/Attnv2 LSTM
head (coverage, bahdanau or luong cells) or the TFM head.  The port's
state-dict keys are the flax paths joined by dots, so each reference
tensor lands on the key the JAX importer writes, in the port's layout:

  torch Conv2d (O, I, kh, kw)  -> kept (the port's convolutions are OIHW)
  torch Conv1d (O, I, k)       -> (k, I, O), the head's ``loc_conv_w``
  torch Linear (O, I)          -> (I, O), applied as ``x @ W``
  torch BatchNorm weight/bias/running_mean/running_var
                               -> scale/bias and the running mean/var

``module.`` (DataParallel) prefixes are stripped.  A parameter of the
model that the state_dict does not fill keeps its value and is reported in
``missing`` by its flax path (``a/b/leaf``), as the JAX importer reports
it; a mapped tensor with no place in the model, or of another shape,
raises.

    python -m doc2tex_tpu_torch.tools.torch_import ckpt.pth --config cfg.yaml \\
        --out weights.msgpack

writes the imported model as a msgpack that ``weights.load_weights`` (and
the JAX package) read.
"""

from __future__ import annotations

import argparse
from typing import Any, Mapping

import numpy as np
import torch


def _c2d(w):   # torch conv2d: already the port's OIHW
    return np.asarray(w)


def _c1d(w):   # torch conv1d (O, I, k) -> (k, I, O)
    return np.transpose(np.asarray(w), (2, 1, 0))


def _lin(w):   # torch linear (O, I) -> (I, O)
    return np.transpose(np.asarray(w))


def _bn(out, prefix, sd, ref):
    out[f"{prefix}.scale"] = np.asarray(sd[f"{ref}.weight"])
    out[f"{prefix}.bias"] = np.asarray(sd[f"{ref}.bias"])
    out[f"{prefix}.mean"] = np.asarray(sd[f"{ref}.running_mean"])
    out[f"{prefix}.var"] = np.asarray(sd[f"{ref}.running_var"])


# FAN ResNet: reference layer -> (the port's first BasicBlock, block count)
_RESNET_LAYERS = {"layer1": (0, 1), "layer2": (1, 2), "layer3": (3, 5), "layer4": (8, 3)}
_RESNET_CONVS = {
    "conv0_1": "ConvBN_0", "conv0_2": "ConvBN_1", "conv1": "ConvBN_2",
    "conv2": "ConvBN_3", "conv3": "ConvBN_4", "conv4_1": "ConvBN_5",
    "conv4_2": "ConvBN_6",
}


def _import_resnet(out, sd, ref_bb: str, our_bb: str) -> None:
    for ref_name, our_name in _RESNET_CONVS.items():
        out[f"{our_bb}.{our_name}.Conv_0.kernel"] = _c2d(sd[f"{ref_bb}.{ref_name}.weight"])
        _bn(out, f"{our_bb}.{our_name}.BatchNorm_0", sd, f"{ref_bb}.bn{ref_name[4:]}")
    for lname, (start, count) in _RESNET_LAYERS.items():
        for j in range(count):
            rp, op = f"{ref_bb}.{lname}.{j}", f"{our_bb}.BasicBlock_{start + j}"
            out[f"{op}.ConvBN_0.Conv_0.kernel"] = _c2d(sd[f"{rp}.conv1.weight"])
            _bn(out, f"{op}.ConvBN_0.BatchNorm_0", sd, f"{rp}.bn1")
            out[f"{op}.ConvBN_1.Conv_0.kernel"] = _c2d(sd[f"{rp}.conv2.weight"])
            _bn(out, f"{op}.ConvBN_1.BatchNorm_0", sd, f"{rp}.bn2")
            if f"{rp}.downsample.0.weight" in sd:
                out[f"{op}.Conv_0.kernel"] = _c2d(sd[f"{rp}.downsample.0.weight"])
                _bn(out, f"{op}.BatchNorm_0", sd, f"{rp}.downsample.1")
    # GlobalContext: the layer's last Sequential member, layerN.<block count>
    for gi, (lname, (_start, count)) in enumerate(_RESNET_LAYERS.items()):
        rp = f"{ref_bb}.{lname}.{count}"
        if f"{rp}.global_cxt.weight" not in sd:
            continue
        op, mlp = f"{our_bb}.GCB_{gi}", f"{rp}.bottleneck_add"
        out[f"{op}.Conv_0.kernel"] = _c2d(sd[f"{rp}.global_cxt.weight"])
        out[f"{op}.Conv_0.bias"] = np.asarray(sd[f"{rp}.global_cxt.bias"])
        out[f"{op}.Dense_0.kernel"] = np.asarray(sd[f"{mlp}.fc1.weight"])[:, :, 0, 0].T
        out[f"{op}.Dense_0.bias"] = np.asarray(sd[f"{mlp}.fc1.bias"])
        out[f"{op}.LayerNorm_0.scale"] = np.asarray(sd[f"{mlp}.norm.weight"])
        out[f"{op}.LayerNorm_0.bias"] = np.asarray(sd[f"{mlp}.norm.bias"])
        out[f"{op}.Dense_1.kernel"] = np.asarray(sd[f"{mlp}.fc2.weight"])[:, :, 0, 0].T
        out[f"{op}.Dense_1.bias"] = np.asarray(sd[f"{mlp}.fc2.bias"])


def _import_vit(out, sd, depth: int, learned_pos: bool) -> None:
    enc, ours = "seqmodeler.SequenceModeling", "seqmodeler"
    ref_bb = f"{enc}.patch_embed.backbone.ConvNet"
    if f"{ref_bb}.conv0_1.weight" in sd:
        _import_resnet(out, sd, ref_bb, f"{ours}.HybridEmbed_0.ResNetFeatureExtractor_0."
                                        "FANResNet_0")
        proj = f"{ours}.HybridEmbed_0.Conv_0"
    else:
        proj = f"{ours}.PatchEmbed_0.Conv_0"
    out[f"{proj}.kernel"] = _c2d(sd[f"{enc}.patch_embed.proj.weight"])
    out[f"{proj}.bias"] = np.asarray(sd[f"{enc}.patch_embed.proj.bias"])
    out[f"{ours}.cls_token"] = np.asarray(sd[f"{enc}.cls_token"])[0][None]
    if learned_pos and f"{enc}.pos_embed" in sd:
        out[f"{ours}.pos_embed"] = np.asarray(sd[f"{enc}.pos_embed"])[0]
    for i in range(depth):
        rb, ob = f"{enc}.blocks.{i}", f"{ours}.Block_{i}"
        for rn, on in (("norm1", "LayerNorm_0"), ("norm2", "LayerNorm_1")):
            out[f"{ob}.{on}.scale"] = np.asarray(sd[f"{rb}.{rn}.weight"])
            out[f"{ob}.{on}.bias"] = np.asarray(sd[f"{rb}.{rn}.bias"])
        for rn, on in (("attn.qkv", "SelfAttention_0.Dense_0"),
                       ("attn.proj", "SelfAttention_0.Dense_1"),
                       ("mlp.fc1", "Mlp_0.Dense_0"), ("mlp.fc2", "Mlp_0.Dense_1")):
            out[f"{ob}.{on}.kernel"] = _lin(sd[f"{rb}.{rn}.weight"])
            out[f"{ob}.{on}.bias"] = np.asarray(sd[f"{rb}.{rn}.bias"])
    out[f"{ours}.LayerNorm_0.scale"] = np.asarray(sd[f"{enc}.norm.weight"])
    out[f"{ours}.LayerNorm_0.bias"] = np.asarray(sd[f"{enc}.norm.bias"])


def _import_attn_decoder(out, sd) -> None:
    p, o = "predicter.Prediction", "predicter"
    out[f"{o}.embedding"] = np.asarray(sd[f"{p}.embedding.weight"])
    cell = f"{p}.attention_cell"
    attn = f"{cell}.attn"
    if f"{attn}.loc_conv.weight" in sd:
        out[f"{o}.loc_conv_w"] = _c1d(sd[f"{attn}.loc_conv.weight"])
        out[f"{o}.loc_conv_b"] = np.asarray(sd[f"{attn}.loc_conv.bias"])
        out[f"{o}.w_loc"] = _lin(sd[f"{attn}.loc_proj.weight"])
        out[f"{o}.b_loc"] = np.asarray(sd[f"{attn}.loc_proj.bias"])
    for rn, on in (("query_proj", "query"), ("key_proj", "key"), ("score", "score")):
        key = f"{attn}.{rn}" if f"{attn}.{rn}.weight" in sd else f"{cell}.{rn}"
        if f"{key}.weight" in sd and f"{key}.bias" in sd:   # bahdanau's have no bias
            out[f"{o}.w_{on}"] = _lin(sd[f"{key}.weight"])
            out[f"{o}.b_{on}"] = np.asarray(sd[f"{key}.bias"])
    # luong: fc (no bias) for general/concat, `weight` (1, H) the concat v
    if f"{attn}.fc.weight" in sd:
        out[f"{o}.w_luong"] = _lin(sd[f"{attn}.fc.weight"])
    if f"{attn}.weight" in sd:
        out[f"{o}.v_luong"] = np.asarray(sd[f"{attn}.weight"]).T
    # bahdanau: i2h -> key (no bias), h2h -> query, score (no bias)
    if f"{attn}.i2h.weight" in sd:
        out[f"{o}.w_key"] = _lin(sd[f"{attn}.i2h.weight"])
        out[f"{o}.b_key"] = np.zeros(sd[f"{attn}.i2h.weight"].shape[0], np.float32)
        out[f"{o}.w_query"] = _lin(sd[f"{attn}.h2h.weight"])
        out[f"{o}.b_query"] = np.asarray(sd[f"{attn}.h2h.bias"])
        out[f"{o}.w_score"] = _lin(sd[f"{attn}.score.weight"])
        out[f"{o}.b_score"] = np.zeros(1, np.float32)
    for name, ref in (("w_ih", "weight_ih"), ("w_hh", "weight_hh")):
        out[f"{o}.{name}"] = _lin(sd[f"{cell}.rnn.{ref}"])
    out[f"{o}.b_ih"] = np.asarray(sd[f"{cell}.rnn.bias_ih"])
    out[f"{o}.b_hh"] = np.asarray(sd[f"{cell}.rnn.bias_hh"])
    out[f"{o}.w_gen"] = _lin(sd[f"{cell}.generator.weight"])
    out[f"{o}.b_gen"] = np.asarray(sd[f"{cell}.generator.bias"])
    if f"{p}.proj_init_h.weight" in sd:
        for hc in "hc":
            out[f"{o}.w_init_{hc}"] = _lin(sd[f"{p}.proj_init_{hc}.weight"])
            out[f"{o}.b_init_{hc}"] = np.asarray(sd[f"{p}.proj_init_{hc}.bias"])


def _import_tfm_decoder(out, sd, num_layers: int) -> None:
    p, o = "predicter.Prediction", "predicter"
    out[f"{o}.word_embed"] = np.asarray(sd[f"{p}.word_embed.weight"])
    out[f"{o}.w_proj"] = _lin(sd[f"{p}.proj.weight"])
    out[f"{o}.b_proj"] = np.asarray(sd[f"{p}.proj.bias"])
    for i in range(num_layers):
        rl = f"{p}.model.layers.{i}"
        for ref, ours in (("self_attn", "sa"), ("multihead_attn", "ca")):
            inw = np.asarray(sd[f"{rl}.{ref}.in_proj_weight"])
            inb = np.asarray(sd[f"{rl}.{ref}.in_proj_bias"])
            d = inw.shape[0] // 3
            for j, nm in enumerate("qkv"):
                out[f"{o}.l{i}_{ours}_w{nm}"] = _lin(inw[j * d:(j + 1) * d])
                out[f"{o}.l{i}_{ours}_b{nm}"] = inb[j * d:(j + 1) * d]
            out[f"{o}.l{i}_{ours}_wo"] = _lin(sd[f"{rl}.{ref}.out_proj.weight"])
            out[f"{o}.l{i}_{ours}_bo"] = np.asarray(sd[f"{rl}.{ref}.out_proj.bias"])
        for n in (1, 2):
            out[f"{o}.l{i}_ff_w{n}"] = _lin(sd[f"{rl}.linear{n}.weight"])
            out[f"{o}.l{i}_ff_b{n}"] = np.asarray(sd[f"{rl}.linear{n}.bias"])
        for n in (1, 2, 3):
            out[f"{o}.l{i}_n{n}_s"] = np.asarray(sd[f"{rl}.norm{n}.weight"])
            out[f"{o}.l{i}_n{n}_b"] = np.asarray(sd[f"{rl}.norm{n}.bias"])


def import_torch_state_dict(state_dict: Mapping[str, Any], config, model) -> list[str]:
    """Load a reference state_dict (tensors or numpy arrays) into ``model``
    (the port's ``Model`` built from ``config``) in place.  Returns the
    flax paths of the parameters it left as they were, as the JAX
    importer's ``missing``."""
    sd = {(k[7:] if k.startswith("module.") else k):
          (v.detach().cpu().numpy() if torch.is_tensor(v) else np.asarray(v))
          for k, v in state_dict.items()}
    mapped: dict[str, np.ndarray] = {}
    if config["SequenceModeling"]["name"] == "ViT":
        smp = config["SequenceModeling"]["params"]
        _import_vit(mapped, sd, smp["depth"], learned_pos=not smp.get("fix_embed", False))
    pred = config["Prediction"]["name"]
    if pred.startswith("Attn"):
        _import_attn_decoder(mapped, sd)
    elif pred in ("TFM", "MS_TFM"):
        _import_tfm_decoder(mapped, sd, config["Prediction"]["params"].get(
            "num_decoder_layers", 3))
    target = model.state_dict()
    for key, value in mapped.items():
        if key not in target:
            raise KeyError(f"mapped key {key} has no place in the model")
        if tuple(target[key].shape) != value.shape:
            raise ValueError(f"{key}: shape {value.shape} != model {tuple(target[key].shape)}")
    with torch.no_grad():
        for key, value in mapped.items():
            target[key].copy_(torch.from_numpy(np.ascontiguousarray(value, np.float32)))
    return [k.replace(".", "/") for k, _ in model.named_parameters() if k not in mapped]


_REF_CONVS = ("conv0_1", "conv0_2", "conv1", "conv2", "conv3", "conv4_1", "conv4_2")
_REF_LAYERS = (("layer1", 0, 1), ("layer2", 1, 2), ("layer3", 3, 5), ("layer4", 8, 3))


def reference_state_dict(port, config, rng) -> dict:
    """Random tensors (numpy ``rng`` draws) under the reference ``Model``'s
    names, shaped from the port model ``port`` of ``config`` (the hybrid
    ResNet ViT, a coverage Attn/Attnv2 head or a TFM head): the state_dict
    a reference checkpoint of that architecture holds, for the importer's
    tests and the chip smoke run."""
    st = port.state_dict()
    sd = {}

    def put(key, shape):
        # fan-in scaled draws (torch layout: out first); a norm's weight
        # vector about 1, any other vector about 0
        std = float(np.prod(shape[1:])) ** -0.5 if len(shape) >= 2 else 0.1
        mean = 1.0 if len(shape) == 1 and key.endswith(".weight") else 0.0
        sd[key] = torch.from_numpy(rng.normal(mean, std, shape).astype(np.float32))

    def lin(key, ours):          # (in, out) -> torch Linear (out, in)
        put(f"{key}.weight", st[f"{ours}.kernel"].shape[::-1])
        put(f"{key}.bias", st[f"{ours}.bias"].shape)

    def bn(key, ours):
        C = st[f"{ours}.scale"].shape
        for name in ("weight", "bias", "running_mean"):
            put(f"{key}.{name}", C)
        sd[f"{key}.running_var"] = torch.from_numpy(rng.uniform(0.5, 1.5, C).astype(np.float32))

    enc, ours = "seqmodeler.SequenceModeling", "seqmodeler"
    bb, obb = (f"{enc}.patch_embed.backbone.ConvNet",
               f"{ours}.HybridEmbed_0.ResNetFeatureExtractor_0.FANResNet_0")
    for i, ref in enumerate(_REF_CONVS):
        put(f"{bb}.{ref}.weight", st[f"{obb}.ConvBN_{i}.Conv_0.kernel"].shape)
        bn(f"{bb}.bn{ref[4:]}", f"{obb}.ConvBN_{i}.BatchNorm_0")
    for gi, (layer, start, count) in enumerate(_REF_LAYERS):
        for j in range(count):
            rp, op = f"{bb}.{layer}.{j}", f"{obb}.BasicBlock_{start + j}"
            for n in (0, 1):
                put(f"{rp}.conv{n + 1}.weight", st[f"{op}.ConvBN_{n}.Conv_0.kernel"].shape)
                bn(f"{rp}.bn{n + 1}", f"{op}.ConvBN_{n}.BatchNorm_0")
            if f"{op}.Conv_0.kernel" in st:
                put(f"{rp}.downsample.0.weight", st[f"{op}.Conv_0.kernel"].shape)
                bn(f"{rp}.downsample.1", f"{op}.BatchNorm_0")
        og = f"{obb}.GCB_{gi}"
        if f"{og}.Conv_0.kernel" in st:
            rp = f"{bb}.{layer}.{count}"
            C = st[f"{og}.Dense_0.bias"].shape[0]
            put(f"{rp}.global_cxt.weight", (1, C, 1, 1))
            put(f"{rp}.global_cxt.bias", (1,))
            for fc in ("fc1", "fc2"):
                put(f"{rp}.bottleneck_add.{fc}.weight", (C, C, 1, 1))
                put(f"{rp}.bottleneck_add.{fc}.bias", (C,))
            put(f"{rp}.bottleneck_add.norm.weight", (C,))
            put(f"{rp}.bottleneck_add.norm.bias", (C,))
    put(f"{enc}.patch_embed.proj.weight", st[f"{ours}.HybridEmbed_0.Conv_0.kernel"].shape)
    put(f"{enc}.patch_embed.proj.bias", st[f"{ours}.HybridEmbed_0.Conv_0.bias"].shape)
    put(f"{enc}.cls_token", st[f"{ours}.cls_token"].shape)
    if f"{ours}.pos_embed" in st:
        put(f"{enc}.pos_embed", (1, *st[f"{ours}.pos_embed"].shape))
    for i in range(config["SequenceModeling"]["params"]["depth"]):
        rb, ob = f"{enc}.blocks.{i}", f"{ours}.Block_{i}"
        for rn, on in (("norm1", "LayerNorm_0"), ("norm2", "LayerNorm_1")):
            put(f"{rb}.{rn}.weight", st[f"{ob}.{on}.scale"].shape)
            put(f"{rb}.{rn}.bias", st[f"{ob}.{on}.bias"].shape)
        for rn, on in (("attn.qkv", "SelfAttention_0.Dense_0"),
                       ("attn.proj", "SelfAttention_0.Dense_1"),
                       ("mlp.fc1", "Mlp_0.Dense_0"), ("mlp.fc2", "Mlp_0.Dense_1")):
            lin(f"{rb}.{rn}", f"{ob}.{on}")
    put(f"{enc}.norm.weight", st[f"{ours}.LayerNorm_0.scale"].shape)
    put(f"{enc}.norm.bias", st[f"{ours}.LayerNorm_0.bias"].shape)

    p, o = "predicter.Prediction", "predicter"
    if config["Prediction"]["name"] == "TFM":
        put(f"{p}.word_embed.weight", st[f"{o}.word_embed"].shape)
        put(f"{p}.proj.weight", st[f"{o}.w_proj"].shape[::-1])
        put(f"{p}.proj.bias", st[f"{o}.b_proj"].shape)
        for i in range(config["Prediction"]["params"]["num_decoder_layers"]):
            rl = f"{p}.model.layers.{i}"
            d = st[f"{o}.l{i}_sa_wq"].shape[0]
            for ref in ("self_attn", "multihead_attn"):
                put(f"{rl}.{ref}.in_proj_weight", (3 * d, d))
                put(f"{rl}.{ref}.in_proj_bias", (3 * d,))
                put(f"{rl}.{ref}.out_proj.weight", (d, d))
                put(f"{rl}.{ref}.out_proj.bias", (d,))
            for n in (1, 2):
                put(f"{rl}.linear{n}.weight", st[f"{o}.l{i}_ff_w{n}"].shape[::-1])
                put(f"{rl}.linear{n}.bias", st[f"{o}.l{i}_ff_b{n}"].shape)
            for n in (1, 2, 3):
                put(f"{rl}.norm{n}.weight", (d,))
                put(f"{rl}.norm{n}.bias", (d,))
        return sd
    cell = f"{p}.attention_cell"
    put(f"{p}.embedding.weight", st[f"{o}.embedding"].shape)
    k, _, Kl = st[f"{o}.loc_conv_w"].shape
    put(f"{cell}.attn.loc_conv.weight", (Kl, 1, k))
    put(f"{cell}.attn.loc_conv.bias", (Kl,))
    for ref, name in (("loc_proj", "loc"), ("query_proj", "query"), ("key_proj", "key"),
                      ("score", "score")):
        put(f"{cell}.attn.{ref}.weight", st[f"{o}.w_{name}"].shape[::-1])
        put(f"{cell}.attn.{ref}.bias", st[f"{o}.b_{name}"].shape)
    for ref, name in (("weight_ih", "w_ih"), ("weight_hh", "w_hh")):
        put(f"{cell}.rnn.{ref}", st[f"{o}.{name}"].shape[::-1])
    put(f"{cell}.rnn.bias_ih", st[f"{o}.b_ih"].shape)
    put(f"{cell}.rnn.bias_hh", st[f"{o}.b_hh"].shape)
    put(f"{cell}.generator.weight", st[f"{o}.w_gen"].shape[::-1])
    put(f"{cell}.generator.bias", st[f"{o}.b_gen"].shape)
    for hc in "hc":
        put(f"{p}.proj_init_{hc}.weight", st[f"{o}.w_init_{hc}"].shape[::-1])
        put(f"{p}.proj_init_{hc}.bias", st[f"{o}.b_init_{hc}"].shape)
    return sd


def load_torch_checkpoint(path: str, config, model) -> list[str]:
    """Read a reference ``.pth`` (its ``model`` entry, or the file itself
    as the state_dict) and import it into ``model``; returns ``missing``."""
    ckpt = torch.load(path, map_location="cpu")
    sd = ckpt.get("model", ckpt) if isinstance(ckpt, dict) else ckpt
    return import_torch_state_dict(sd, config, model)


def main(argv=None) -> None:
    from .. import _msgpack
    from ..config import load_config
    from ..models import build_model
    from ..tokenizer.converters import create_converter
    from ..weights import to_variables

    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("checkpoint", help="a reference .pth")
    ap.add_argument("--config", required=True, help="the reference-format model config")
    ap.add_argument("--out", required=True, help="msgpack to write")
    args = ap.parse_args(argv)
    config = load_config(args.config)
    model = build_model(config, create_converter(config).num_classes)
    missing = load_torch_checkpoint(args.checkpoint, config, model)
    _msgpack.save(args.out, to_variables(model))
    print(f"imported {args.checkpoint} -> {args.out}; {len(missing)} parameters not in the "
          f"checkpoint{': ' + ', '.join(missing[:8]) if missing else ''}")


if __name__ == "__main__":
    main()
