"""The port's whole slice against the JAX package, at full width.

``tests/torch_port_golden.json`` holds, for the 16 synthetic crops that
``chip_smoke.py`` decodes on the GPU, each crop's seed, shape and sha256 and
the strings the JAX package's ``MathRecognition`` gives on the CPU with the
released ``synthetic_tfm_big`` weights in float32 (beam 10, and greedy).
``tests/torch_port_golden_synthetic.json`` holds the same for the released
coverage-LSTM ``synthetic``.  Each is written once by ``write_golden``
(``PYTHONPATH=. python tests/test_torch_port_slice.py --write-golden
[version]``); the tests only read them.
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
from doc2tex_tpu_torch.data.synthetic import seeded_crops, synth_hard_sample
from doc2tex_tpu_torch.recognition import MathRecognition, load_recog_config
from doc2tex_tpu_torch.weights import convert_variables, load_variables

HERE = os.path.dirname(os.path.abspath(__file__))
GOLDEN = os.path.join(HERE, "torch_port_golden.json")
GOLDEN_FILES = {"synthetic_tfm_big": GOLDEN,
                "synthetic": os.path.join(HERE, "torch_port_golden_synthetic.json")}
VERSION = "synthetic_tfm_big"
N_CROPS = 16
CROP_MAX = (224, 704)


def golden_crop_seeds(n: int = N_CROPS) -> list[int]:
    """The first ``n`` seeds whose crop lies inside the release config's
    [min_dimension, max_dimension], so no crop reaches the resize."""
    return [seed for seed, _, _ in seeded_crops(n, *CROP_MAX)]


def make_crop(seed: int):
    return synth_hard_sample(np.random.default_rng(seed), max_h=CROP_MAX[0],
                             max_w=CROP_MAX[1])


def sha256(img: np.ndarray) -> str:
    return hashlib.sha256(np.ascontiguousarray(img).tobytes()).hexdigest()


def write_golden(version: str = VERSION) -> None:
    """Run the JAX package's MathRecognition with the released ``version``
    on the 16 crops (CPU, float32, no quantization) and write its golden
    file.  Not part of the tests."""
    import jax

    jax.config.update("jax_platforms", "cpu")
    jax.config.update("jax_default_matmul_precision", "float32")
    from doc2tex_tpu.recognition.flow import MathRecognition as JaxRecognition
    from doc2tex_tpu.recognition.flow import coalesce_groups
    from doc2tex_tpu.recognition.flow import load_recog_config as jax_load

    seeds = golden_crop_seeds()
    crops = [make_crop(s) for s in seeds]
    cfg, weights = jax_load(version=version)
    cfg["dtype"] = "float32"
    cfg.pop("quantize", None)
    outputs = {}
    for name, beam in (("beam10", 10), ("greedy", 1)):
        rec = JaxRecognition(cfg.copy(), weights, beam_size=beam)
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
    golden = {
        "version": version, "dtype": "float32", "quantize": None,
        "crop_max": list(CROP_MAX), "coalesce_ratio": cfg.get("coalesce_ratio"),
        "crops": entries,
    }
    with open(GOLDEN_FILES[version], "w") as f:
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
    crops = [make_crop(c["seed"])[0] for c in golden["crops"]]
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
    if sys.argv[1:2] != ["--write-golden"] or len(sys.argv) > 3:
        sys.exit("usage: PYTHONPATH=. python tests/test_torch_port_slice.py --write-golden "
                 f"[{'|'.join(GOLDEN_FILES)}] | --compare-bfloat16 [version]")
    write_golden(*sys.argv[2:])
