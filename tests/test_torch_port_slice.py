"""The port's whole slice against the JAX package, at full width.

``tests/torch_port_golden.json`` holds, for the 16 synthetic crops that
``chip_smoke.py`` decodes on the GPU, each crop's seed, shape and sha256 and
the strings the JAX package's ``MathRecognition`` gives on the CPU with the
released ``synthetic_tfm_big`` weights in float32 (beam 10, and greedy).
``tests/torch_port_golden_synthetic.json`` holds the same for the released
coverage-LSTM ``synthetic``.  ``tests/torch_port_golden_int8.json`` and
``tests/torch_port_golden_synthetic_int8.json`` hold the strings of the
same crops with the int8 encoder (``quantize: int8``, as the releases
ship), still float32.  ``synthetic_tfm`` and ``synthetic_long`` have the
same four files (``torch_port_golden_synthetic_{tfm,long}[_int8].json``);
the long release's crops are 16 ``synth_long_sample`` displays inside
448x960.  ``synthetic_tfm_big`` and ``synthetic`` also have the strings
with decoder memory in int8 (``quantize: int8_full``: the encoder and the
attention memory), ``torch_port_golden[_synthetic]_int8_full.json``, and
``synthetic_tfm_big`` with the growing self-attention caches in int8 too
(the parts ``encoder, decoder_mem, decoder_kv``, which no ``quantize:``
mode names), ``torch_port_golden_int8_kv.json``.  Each is written once by
``write_golden`` (``PYTHONPATH=. python tests/test_torch_port_slice.py
--write-golden [version] [--quantize int8|int8_full|int8_kv]``); the tests
only read them.
"""

from __future__ import annotations

import hashlib
import json
import os
import sys

import numpy as np
import pytest
import torch

from doc2tex_tpu_torch import _msgpack
from doc2tex_tpu_torch.data.synthetic import seeded_crops, synth_hard_sample, synth_long_sample
from doc2tex_tpu_torch.recognition import MathRecognition, load_recog_config
from doc2tex_tpu_torch.weights import convert_variables, load_variables
from torch_port_threads import one_torch_thread  # noqa: F401

HERE = os.path.dirname(os.path.abspath(__file__))
GOLDEN = os.path.join(HERE, "torch_port_golden.json")
GOLDEN_FILES = {"synthetic_tfm_big": GOLDEN,
                "synthetic": os.path.join(HERE, "torch_port_golden_synthetic.json"),
                "synthetic_tfm": os.path.join(HERE, "torch_port_golden_synthetic_tfm.json"),
                "synthetic_long": os.path.join(HERE, "torch_port_golden_synthetic_long.json")}
# the same crops decoded with the int8 encoder (``quantize: int8``, as the
# releases ship), in float32
GOLDEN_INT8_FILES = {
    "synthetic_tfm_big": os.path.join(HERE, "torch_port_golden_int8.json"),
    "synthetic": os.path.join(HERE, "torch_port_golden_synthetic_int8.json"),
    "synthetic_tfm": os.path.join(HERE, "torch_port_golden_synthetic_tfm_int8.json"),
    "synthetic_long": os.path.join(HERE, "torch_port_golden_synthetic_long_int8.json")}
# the same crops with decoder memory in int8, in float32: the JAX
# package's parts of each mode (``int8_kv`` is no ``quantize:`` mode: its
# parts are set on the recognizer)
QUANT_PARTS = {"int8": ("encoder",), "int8_full": ("encoder", "decoder_mem"),
               "int8_kv": ("encoder", "decoder_mem", "decoder_kv")}
GOLDEN_QUANT_FILES = {
    "int8": GOLDEN_INT8_FILES,
    "int8_full": {v: GOLDEN_FILES[v].replace(".json", "_int8_full.json")
                  for v in ("synthetic_tfm_big", "synthetic")},
    "int8_kv": {"synthetic_tfm_big": GOLDEN.replace(".json", "_int8_kv.json")}}
VERSION = "synthetic_tfm_big"
N_CROPS = 16
CROP_MAX = (224, 704)
# each release's crops: its generator and the largest crop, the release
# config's max_dimension (the long release's 448x960 multi-line displays)
GENERATORS = {"synth_hard_sample": synth_hard_sample, "synth_long_sample": synth_long_sample}
CROPS = {"synthetic_long": ("synth_long_sample", (448, 960))}


def crop_spec(version: str = VERSION) -> tuple[str, tuple[int, int]]:
    """(generator name, crop_max) of ``version``'s golden crops."""
    return CROPS.get(version, ("synth_hard_sample", CROP_MAX))


def golden_crop_seeds(n: int = N_CROPS, version: str = VERSION) -> list[int]:
    """The first ``n`` seeds whose crop lies inside the release config's
    [min_dimension, max_dimension], so no crop reaches the resize."""
    generator, crop_max = crop_spec(version)
    if generator == "synth_hard_sample":
        return [seed for seed, _, _ in seeded_crops(n, *crop_max)]
    seeds, seed = [], 0
    while len(seeds) < n:
        img, _ = make_crop(seed, version)
        if min(img.shape) >= 32 and img.shape[0] <= crop_max[0] and img.shape[1] <= crop_max[1]:
            seeds.append(seed)
        seed += 1
    return seeds


def make_crop(seed: int, version: str = VERSION):
    generator, crop_max = crop_spec(version)
    return GENERATORS[generator](np.random.default_rng(seed), max_h=crop_max[0],
                                 max_w=crop_max[1])


def sha256(img: np.ndarray) -> str:
    return hashlib.sha256(np.ascontiguousarray(img).tobytes()).hexdigest()


def write_golden(version: str = VERSION, quantize: str | None = None) -> None:
    """Run the JAX package's MathRecognition with the released ``version``
    on the 16 crops (CPU, float32, ``quantize`` None or a key of
    QUANT_PARTS) and write its golden file.  Not part of the tests."""
    import jax

    jax.config.update("jax_platforms", "cpu")
    jax.config.update("jax_default_matmul_precision", "float32")
    from doc2tex_tpu.recognition import flow as jax_flow
    from doc2tex_tpu.recognition.flow import MathRecognition as JaxRecognition
    from doc2tex_tpu.recognition.flow import coalesce_groups
    from doc2tex_tpu.recognition.flow import load_recog_config as jax_load

    from test_torch_port_detect import exact_int8_conv

    seeds = golden_crop_seeds(version=version)
    crops = [make_crop(s, version) for s in seeds]
    cfg, weights = jax_load(version=version)
    cfg["dtype"] = "float32"
    cfg["quantize"] = "int8_full" if quantize == "int8_kv" else quantize
    if version == "synthetic_long":
        # the 16 crops share one 448x960 bucket, which the batch snap pads
        # to 64 rows; the padding rows repeat row 0, so they change neither
        # a row's decode nor the int8 encoder's per-tensor scale, and
        # leaving them out keeps the CPU run's memory to a quarter
        jax_flow._snap_batch = lambda n, cap=64: n
    outputs = {}
    for name, beam in (("beam10", 10), ("greedy", 1)):
        rec = JaxRecognition(cfg.copy(), weights, beam_size=beam)
        if quantize:
            rec.quant_parts = QUANT_PARTS[quantize]
        # XLA's int8 convolution on the CPU, in exact float32 pieces (the same
        # integers, see exact_int8_conv)
        with exact_int8_conv():
            outputs[name] = rec([img for img, _ in crops])
        buckets = [rec.bucket_key(img) for img, _ in crops]
    groups: dict = {}
    for i, b in enumerate(buckets):
        groups.setdefault(tuple(b), []).append(i)
    decode_bucket = {}
    for b, idxs in coalesce_groups(groups, float(cfg.get("coalesce_ratio") or 0)).items():
        decode_bucket.update({i: b for i in idxs})
    entries = []
    for i, (seed, (img, label)) in enumerate(zip(seeds, crops)):
        entries.append({
            "seed": seed, "shape": list(img.shape), "sha256": sha256(img),
            "native_bucket": list(buckets[i]), "decode_bucket": list(decode_bucket[i]),
            "label": label,
            "beam10": outputs["beam10"][i], "greedy": outputs["greedy"][i],
        })
    generator, crop_max = crop_spec(version)
    golden = {
        "version": version, "dtype": "float32", "quantize": quantize,
        "crop_max": list(crop_max), "coalesce_ratio": cfg.get("coalesce_ratio"),
        "crops": entries,
    }
    if generator != "synth_hard_sample":
        golden["generator"] = generator
    with open((GOLDEN_QUANT_FILES[quantize] if quantize else GOLDEN_FILES)[version], "w") as f:
        json.dump(golden, f, indent=1, ensure_ascii=False)
        f.write("\n")


def load_golden(version: str = VERSION) -> dict:
    with open(GOLDEN_FILES[version]) as f:
        return json.load(f)


def test_synthetic_crops_reproduce_golden_sha256():
    golden = load_golden()
    assert len(golden["crops"]) == N_CROPS
    assert [c["seed"] for c in golden["crops"]] == golden_crop_seeds()
    for c in golden["crops"]:
        img, label = make_crop(c["seed"])
        assert list(img.shape) == c["shape"]
        assert sha256(img) == c["sha256"]
        assert label == c["label"]


@pytest.mark.parametrize("mode,version", [(m, v) for m, files in GOLDEN_QUANT_FILES.items()
                                          for v in files])
def test_int8_goldens_hold_the_float32_crops(mode, version):
    """The int8 golden files (each mode's) were written on the same 16
    crops, decoded in the same buckets, as the float32 ones."""
    with open(GOLDEN_QUANT_FILES[mode][version]) as f:
        int8 = json.load(f)
    plain = load_golden(version)
    assert int8["version"] == version and int8["quantize"] == mode
    assert int8["dtype"] == plain["dtype"] == "float32"
    keys = ("seed", "shape", "sha256", "native_bucket", "decode_bucket", "label")
    assert [[c[k] for k in keys] for c in int8["crops"]] == \
        [[c[k] for k in keys] for c in plain["crops"]]


def _recognizer(beam: int) -> MathRecognition:
    cfg, weights = load_recog_config(version=VERSION)
    cfg["dtype"] = "float32"
    cfg["quantize"] = None
    return MathRecognition(cfg, weights, beam_size=beam, device="cpu")


def _short_crops(golden: dict, n: int) -> list[dict]:
    """The ``n`` crops with the fewest label tokens among those whose greedy
    and beam-10 strings differ (so each mode's check tells them apart)."""
    crops = [c for c in golden["crops"] if c["greedy"] != c["beam10"]]
    crops.sort(key=lambda c: (len(c["label"].split()), c["seed"]))
    return crops[:n]


@pytest.mark.parametrize("mode", ["greedy", "beam10"])
def test_full_width_release_weights_match_golden(mode):
    """The port on the CPU, release weights, full width, float32: the same
    LaTeX string as the JAX package, for one crop per decode mode, decoded
    in the bucket the JAX run decoded it in (after coalescing)."""
    golden = load_golden()
    crop = _short_crops(golden, 2)[0 if mode == "greedy" else 1]
    img, _ = make_crop(crop["seed"])
    rec = _recognizer(1 if mode == "greedy" else 10)
    assert rec.bucket_key(img) == tuple(crop["native_bucket"])
    prepped = rec._preprocess(img)
    h, w = img.shape
    assert np.array_equal(prepped[:h, :w], img)    # no resize, only the white pad
    assert rec.decode_group([prepped], tuple(crop["decode_bucket"])) == [crop[mode]]


def test_weight_converter_consumes_every_release_leaf():
    cfg, weights = load_recog_config(version=VERSION)
    variables = _msgpack.load(weights)
    leaves = convert_variables(variables)
    assert len(leaves) == 396          # 397 leaves in the file, less `step`
    rec_cfg = dict(cfg, dtype="float32", quantize=None)
    from doc2tex_tpu_torch.models import build_model
    from doc2tex_tpu_torch.tokenizer.vocab import load_vocab

    model = build_model(rec_cfg, 4 + len(load_vocab(cfg["vocab"])))
    assert load_variables(model, variables) == 396
    # a leaf left over, or one missing, raises
    extra = dict(variables, params=dict(variables["params"], stray=np.zeros(3, np.float32)))
    with pytest.raises(ValueError, match="unused"):
        load_variables(model, extra)
    pred = dict(variables["params"]["predicter"])
    pred.pop("b_proj")
    short = dict(variables, params=dict(variables["params"], predicter=pred))
    with pytest.raises(ValueError, match="missing"):
        load_variables(model, short)
    assert torch.equal(model.predicter.b_proj,
                       torch.from_numpy(variables["params"]["predicter"]["b_proj"].astype(np.float32)))


def compare_bfloat16(version: str = VERSION) -> list[dict]:
    """Decode the 16 golden crops in bfloat16 (beam 10, as one call, as
    ``chip_smoke.py`` does on the card) with the JAX package and with the
    port, both on the CPU, and return the crops where either string differs
    from the float32 golden.  Not part of the tests: a check of where
    bfloat16 differences come from."""
    import jax

    jax.config.update("jax_platforms", "cpu")
    from doc2tex_tpu.recognition.flow import MathRecognition as JaxRecognition
    from doc2tex_tpu.recognition.flow import load_recog_config as jax_load

    golden = load_golden(version)
    crops = [make_crop(c["seed"], version)[0] for c in golden["crops"]]
    jcfg, weights = jax_load(version=version)
    jcfg["dtype"] = "bfloat16"
    jcfg.pop("quantize", None)
    jax_out = JaxRecognition(jcfg, weights, beam_size=10)(crops)
    cfg, weights = load_recog_config(version=version)
    cfg["dtype"], cfg["quantize"] = "bfloat16", None
    port_out = MathRecognition(cfg, weights, beam_size=10, device="cpu")(crops)
    return [{"crop": i, "float32_golden": c["beam10"], "jax_bfloat16": j, "port_bfloat16": t}
            for i, (c, j, t) in enumerate(zip(golden["crops"], jax_out, port_out))
            if not j == t == c["beam10"]]


if __name__ == "__main__":
    if sys.argv[1:2] == ["--compare-bfloat16"] and len(sys.argv) <= 3:
        print(json.dumps(compare_bfloat16(*sys.argv[2:]), indent=1, ensure_ascii=False))
        sys.exit(0)
    args = sys.argv[2:]
    quantize = None
    if args[-2:-1] == ["--quantize"]:
        quantize, args = args[-1], args[:-2]
    if (sys.argv[1:2] != ["--write-golden"] or len(args) > 1
            or (quantize is not None and (args or [VERSION])[0] not in
                GOLDEN_QUANT_FILES.get(quantize, {}))):
        sys.exit("usage: PYTHONPATH=. python tests/test_torch_port_slice.py --write-golden "
                 f"[{'|'.join(GOLDEN_FILES)}] [--quantize {'|'.join(GOLDEN_QUANT_FILES)}] | "
                 "--compare-bfloat16 [version]")
    write_golden(*args, quantize=quantize)
