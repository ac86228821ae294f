"""The shipped recognizers the port added last against the JAX package:
``synthetic_tfm``, ``synthetic_long`` (448x960, decodes of up to 500
tokens) and the CLAHE blocks ``version1``/``version2``.

- ``transforms.preprocess.clahe`` byte-equal to JAX's on seeded sizes:
  odd sizes, sizes below the 2x2 grid, a constant, a black and a white
  image;
- ``synth_long_sample`` bytes and labels equal to JAX's;
- every version block's merged config, and its bucket ladder (growth 4.0
  for ``synthetic_long``), equal to JAX's;
- every leaf of the ``synthetic_tfm`` and ``synthetic_long`` weights read;
- B1's ``launch_plan`` valid at the long decode's shapes; the 500-step
  chunk ends equal to JAX's;
- a tiny ``version``-style coverage model with CLAHE on, JAX's initialised
  parameters carried into the port: the same preprocessed bytes and beam
  strings through ``MathRecognition``;
- a tiny TFM head decoding all 501 steps of ``batch_max_length`` 500 over
  the 5-chunk cache schedule (and rows that stop early): tokens equal to
  JAX's, the cache grown to 501 x K slots;
- the new golden files' crops regenerate to their sha256 and labels, and
  one ``synthetic_tfm`` golden crop per decode mode at full width on the
  CPU.

The file imports JAX only inside its tests, and holds torch to one thread.
"""

from __future__ import annotations

import os
import sys

import numpy as np
import pytest
import torch

from doc2tex_tpu_torch import _msgpack
from doc2tex_tpu_torch.config import make_config
from doc2tex_tpu_torch.data.buckets import make_ladder
from doc2tex_tpu_torch.data.synthetic import HARD_VOCAB_PATH, synth_hard_sample, synth_long_sample
from doc2tex_tpu_torch.decode.runner import DECODE_CHUNKS, _chunk_ends, make_decode_fn
from doc2tex_tpu_torch.models import build_model
from doc2tex_tpu_torch.ops.decode_attention import MAX_CLUSTER, SMEM_LIMIT, TILE, launch_plan
from doc2tex_tpu_torch.recognition import MathRecognition, load_recog_config
from doc2tex_tpu_torch.tokenizer.vocab import load_vocab
from doc2tex_tpu_torch.transforms.preprocess import clahe
from doc2tex_tpu_torch.weights import convert_variables, load_variables

HERE = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, HERE)
sys.path.insert(0, os.path.dirname(HERE))
from test_torch_port_slice import (  # noqa: E402
    _short_crops, crop_spec, golden_crop_seeds, load_golden, make_crop, sha256)
from torch_port_threads import one_torch_thread  # noqa: E402,F401

VERSIONS = ("version1", "version2", "synthetic", "synthetic_tfm", "synthetic_tfm_big",
            "synthetic_tfm_big_pad", "synthetic_long")


def _jax():
    import jax

    jax.config.update("jax_platforms", "cpu")
    return jax


# ---- CLAHE, the long generator, configs -------------------------------------

CLAHE_CASES = [
    ("noise", (37, 53)), ("noise", (224, 704)), ("noise", (101, 7)), ("noise", (1, 1)),
    ("noise", (1, 40)), ("noise", (3, 2)), ("noise", (448, 960)), ("noise", (33, 1)),
    ("constant", (30, 50)), ("black", (64, 64)), ("white", (31, 97)), ("crop", None),
]


def _clahe_input(kind, shape, seed):
    rng = np.random.default_rng(seed)
    if kind == "noise":
        return rng.integers(0, 256, shape, dtype=np.uint8)
    if kind == "crop":
        return synth_hard_sample(rng)[0]
    return np.full(shape, {"constant": 137, "black": 0, "white": 255}[kind], np.uint8)


@pytest.mark.parametrize("case", range(len(CLAHE_CASES)))
def test_clahe_is_byte_equal_to_jax(case):
    from doc2tex_tpu.transforms.preprocess import clahe as jax_clahe

    kind, shape = CLAHE_CASES[case]
    img = _clahe_input(kind, shape, seed=case)
    got = clahe(img)
    assert got.dtype == np.uint8 and got.shape == img.shape
    np.testing.assert_array_equal(got, jax_clahe(img))


@pytest.mark.parametrize("seed", [0, 5, 33])
def test_synth_long_sample_equals_jax(seed):
    from doc2tex_tpu.data.synthetic import synth_long_sample as jax_long

    img, label = synth_long_sample(np.random.default_rng(seed))
    want_img, want_label = jax_long(np.random.default_rng(seed))
    assert label == want_label and len(label.split()) > 120
    np.testing.assert_array_equal(img, want_img)
    assert img.shape[0] <= 448 and img.shape[1] <= 960


@pytest.mark.parametrize("version", VERSIONS)
def test_version_config_and_ladder_equal_jax(version):
    from doc2tex_tpu.data.buckets import make_ladder as jax_ladder
    from doc2tex_tpu.recognition.flow import load_recog_config as jax_load

    cfg, weights = load_recog_config(version=version)
    jcfg, jweights = jax_load(version=version)
    assert dict(cfg) == dict(jcfg) and weights == jweights
    args = (cfg["min_dimension"], cfg["max_dimension"], cfg.get("scale_factor", 32))
    growth = float(cfg.get("bucket_growth", 1.5))
    ours, theirs = make_ladder(*args, growth=growth), jax_ladder(*args, growth=growth)
    assert [tuple(s) for s in ours.shapes] == [tuple(s) for s in theirs.shapes]
    if version == "synthetic_long":
        assert growth == 4.0 and len(ours.shapes) == 12 and ours.shapes[-1] == (448, 960)
        assert cfg["batch_max_length"] == 500 and not cfg["clahe"]
    if version.startswith("version"):
        assert weights is None and cfg.get("clahe", True)


def test_tfm_big_pad_weights_are_tfm_big_weights():
    _, pad = load_recog_config(version="synthetic_tfm_big_pad")
    _, big = load_recog_config(version="synthetic_tfm_big")
    with open(pad, "rb") as a, open(big, "rb") as b:
        assert a.read() == b.read()


@pytest.mark.parametrize("version,n_leaves", [("synthetic_tfm", 282), ("synthetic_long", 396)])
def test_weight_converter_consumes_every_leaf(version, n_leaves):
    cfg, weights = load_recog_config(version=version)
    variables = _msgpack.load(weights)
    assert len(convert_variables(variables)) == n_leaves
    model = build_model(dict(cfg, dtype="float32", quantize=None),
                        4 + len(load_vocab(cfg["vocab"])))
    assert load_variables(model, variables) == n_leaves


# ---- the long decode's shapes --------------------------------------------------

@pytest.mark.parametrize("max_steps", [151, 201, 501])
def test_chunk_ends_equal_jax(max_steps):
    from doc2tex_tpu.decode.runner import _chunk_ends as jax_chunk_ends

    ends = _chunk_ends(max_steps, DECODE_CHUNKS)
    assert ends == jax_chunk_ends(max_steps, DECODE_CHUNKS)
    if max_steps == 501:
        assert ends == [101, 202, 303, 404, 501]


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
def test_launch_plan_covers_the_long_shapes(dtype):
    """Every plan at the long release's self M (the chunk ends x K, up to
    5010) and cross M (the 448x960 grid and its cls token, 1695), and at
    the small TFM release's, fits MAX_CLUSTER blocks of at most 227 KB and
    covers M exactly once."""
    shapes = [(nh, K, M) for nh, K in ((8, 10), (8, 5), (8, 1), (4, 10))
              for M in [e * K for e in _chunk_ends(501, DECODE_CHUNKS)] + [1694, 1695]]
    shapes += [(4, 10, e * 10) for e in _chunk_ends(151, DECODE_CHUNKS)] + [(4, 10, 624)]
    for B in (1, 8, 16, 64):
        for nh, K, M in shapes:
            plan = launch_plan(B, K, M, nh, 32, dtype)
            assert 1 <= plan.cluster <= MAX_CLUSTER and plan.smem_bytes <= SMEM_LIMIT
            assert plan.chunk % TILE == 0 and plan.stages in (2, 3)
            assert (plan.cluster - 1) * plan.chunk < M <= plan.cluster * plan.chunk


# ---- a tiny coverage model with CLAHE on ---------------------------------------

def _tiny_version_config() -> dict:
    """The ``common`` block's head (Attnv2 coverage, kernel_dim half the
    width) and CLAHE left on, at width 64 and depth 1."""
    return dict(
        max_dimension=[64, 256], min_dimension=[32, 32], batch_max_length=12,
        dtype="float32", vocab=HARD_VOCAB_PATH, beam_size=3,
        FeatureExtraction={"name": "None"},
        SequenceModeling={"name": "ViT", "params": {
            "backbone": {"name": "resnet", "input_channel": 1, "output_channel": 64,
                         "gcb": False},
            "fix_embed": True, "input_channel": 1, "patching_style": "2d",
            "patch_size": [2, 2], "depth": 1, "num_heads": 2, "hidden_size": 64}},
        Prediction={"name": "Attnv2", "params": {
            "seqmodel": "TFM", "input_size": 64, "hidden_size": 64, "kernel_size": 2,
            "kernel_dim": 32, "embed_target": True, "enc_init": True,
            "attn_type": "coverage", "method": "concat", "droprate": 0.0}},
    )


def test_clahe_coverage_model_strings_equal_jax():
    """MathRecognition with CLAHE on (the config's default), JAX's random
    init (seed 0) carried into the port: equal preprocessed bytes, and
    equal beam-3 strings on two crops of one bucket (one JAX compile)."""
    jax = _jax()
    from doc2tex_tpu.config import make_config as jax_make_config
    from doc2tex_tpu.recognition.flow import MathRecognition as JaxRecognition

    crops = [synth_hard_sample(np.random.default_rng(s), min_len=3, max_len=12, max_h=64,
                               max_w=256)[0] for s in (0, 2)]
    jrec = JaxRecognition(jax_make_config(_tiny_version_config()), None, seed=0)
    rec = MathRecognition(make_config(_tiny_version_config()), None, device="cpu")
    assert jrec.use_clahe and rec.use_clahe
    variables = jax.tree_util.tree_map(np.asarray, jrec.variables)
    assert load_variables(rec.model, variables) == len(jax.tree_util.tree_leaves(variables))
    for crop in crops:
        prepped = rec._preprocess(crop)
        np.testing.assert_array_equal(prepped, jrec._preprocess(crop))
        off = MathRecognition(make_config(_tiny_version_config()), None, use_clahe=False,
                              device="cpu")._preprocess(crop)
        assert not np.array_equal(prepped, off)       # CLAHE changed the pixels
    assert len({rec.bucket_key(c) for c in crops}) == 1
    assert rec(crops) == jrec(crops)


# ---- a tiny TFM head over 501 steps ----------------------------------------------

V = 24
END = 2    # TFM: PAD 0, GO 1, [s] 2
BUCKET = (32, 64)


def _tiny_tfm_config() -> dict:
    return dict(
        max_dimension=[32, 64], min_dimension=[32, 32], batch_max_length=500,
        dtype="float32",
        FeatureExtraction={"name": "None"},
        SequenceModeling={"name": "ViT", "params": {
            "backbone": {"name": "resnet", "input_channel": 1, "output_channel": 16,
                         "gcb": False},
            "fix_embed": True, "input_channel": 1, "patching_style": "2d",
            "patch_size": [2, 2], "depth": 1, "num_heads": 1, "hidden_size": 16}},
        Prediction={"name": "TFM", "params": {
            "d_model": 16, "nhead": 1, "num_decoder_layers": 1, "dim_feedforward": 16,
            "dropout": 0.0}},
    )


@pytest.fixture(scope="module")
def tfm_pair():
    jax = _jax()
    import jax.numpy as jnp
    from doc2tex_tpu.config import make_config as jax_make_config
    from doc2tex_tpu.models import build_model as jax_build_model
    from test_torch_port_model import _random_variables

    jmodel = jax_build_model(jax_make_config(_tiny_tfm_config()), V)
    shapes = jax.eval_shape(
        lambda: jmodel.init(jax.random.PRNGKey(0), jnp.zeros((1, *BUCKET, 1)),
                            jnp.zeros((1, 502), jnp.int32), train=False))
    variables = _random_variables(dict(shapes), np.random.default_rng(11))
    return jmodel, variables


@pytest.mark.parametrize("beam,end_bias", [(3, -1e4), (3, 0.45), (1, -1e4)])
def test_tfm_decode_over_all_chunks_equals_jax(tfm_pair, beam, end_bias):
    """``batch_max_length`` 500: 501 steps over the chunk schedule (101,
    202, 303, 404, 501); with the end token's bias at -1e4 no row stops and
    every chunk is reached (the self-attention cache grows to 501 x K
    slots); at 0.45 the rows (a white, a black, a half-white and a noise
    image) stop at other steps, one in the fourth chunk, and one runs on.
    Tokens equal to JAX's."""
    jax = _jax()
    import jax.numpy as jnp
    import chip_smoke
    from doc2tex_tpu.config import make_config as jax_make_config
    from doc2tex_tpu.decode.runner import make_decode_fn as jax_make_decode_fn

    jmodel, variables = tfm_pair
    pred = dict(variables["params"]["predicter"])
    pred["b_proj"] = pred["b_proj"].copy()
    pred["b_proj"][END] = end_bias
    variables = dict(variables, params=dict(variables["params"], predicter=pred))
    port = build_model(make_config(_tiny_tfm_config()), V).eval()
    load_variables(port, variables)
    rng = np.random.default_rng(4)
    images = rng.integers(0, 256, (4, *BUCKET, 1)).astype(np.uint8)
    images[0], images[1], images[2, :, :32] = 255, 0, 255
    cfg = _tiny_tfm_config()
    jfn = jax_make_decode_fn(jmodel, jax_make_config(cfg), beam_size=beam)
    jtok = np.asarray(jfn(jax.tree_util.tree_map(jnp.asarray, variables),
                          jnp.asarray(images))[0])
    with chip_smoke.recorded_launches() as seen:
        ptok = make_decode_fn(port, make_config(cfg), beam_size=beam, device="cpu")(images)[0]
    np.testing.assert_array_equal(ptok.numpy(), jtok)
    assert jtok.shape == (4, 501)
    self_m = sorted(M for _, _, M, kind in seen["b1"] if kind == "self")
    finished = (jtok == END).any(axis=1)
    if end_bias < 0:
        assert not finished.any()
        assert self_m == [e * beam for e in (101, 202, 303, 404, 501)]
    else:
        assert finished.any() and not finished.all(), finished


# ---- the new golden files ---------------------------------------------------------

@pytest.mark.parametrize("version", ["synthetic_tfm", "synthetic_long"])
def test_new_golden_crops_reproduce_sha256(version):
    golden = load_golden(version)
    generator, crop_max = crop_spec(version)
    assert golden["version"] == version and golden["dtype"] == "float32"
    assert golden.get("generator", "synth_hard_sample") == generator
    assert golden["crop_max"] == list(crop_max) and len(golden["crops"]) == 16
    assert [c["seed"] for c in golden["crops"]] == golden_crop_seeds(version=version)
    for c in golden["crops"]:
        img, label = make_crop(c["seed"], version)
        assert list(img.shape) == c["shape"] and sha256(img) == c["sha256"]
        assert label == c["label"]
    if version == "synthetic_long":     # all in the 448x960 bucket, as the card decodes them
        assert {tuple(c["decode_bucket"]) for c in golden["crops"]} == {(448, 960)}


@pytest.mark.parametrize("mode", ["greedy", "beam10"])
def test_synthetic_tfm_weights_match_golden(mode):
    """The port on the CPU, the released ``synthetic_tfm`` weights, full
    width, float32: the JAX package's string for one crop per mode."""
    golden = load_golden("synthetic_tfm")
    crop = _short_crops(golden, 2)[0 if mode == "greedy" else 1]
    img, _ = make_crop(crop["seed"], "synthetic_tfm")
    cfg, weights = load_recog_config(version="synthetic_tfm")
    cfg["dtype"], cfg["quantize"] = "float32", None
    rec = MathRecognition(cfg, weights, beam_size=1 if mode == "greedy" else 10, device="cpu")
    assert rec.bucket_key(img) == tuple(crop["native_bucket"])
    prepped = rec._preprocess(img)
    assert rec.decode_group([prepped], tuple(crop["decode_bucket"])) == [crop[mode]]
