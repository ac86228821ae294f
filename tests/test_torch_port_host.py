"""The port's host-side copies against the JAX package's originals: the
YAML reader, the msgpack reader, the bucket ladder, coalescing, the
converter, postprocessing and the PIL-free resize."""

from __future__ import annotations

import glob
import os

import numpy as np
import pytest
import yaml
from flax import serialization, traverse_util

from doc2tex_tpu.data import buckets as jax_buckets
from doc2tex_tpu.recognition import flow as jax_flow
from doc2tex_tpu.tokenizer.converters import TFMLabelConverter as JaxConverter
from doc2tex_tpu.tokenizer.vocab import load_vocab as jax_load_vocab
from doc2tex_tpu.transforms.preprocess import _resize_area as jax_resize
from doc2tex_tpu_torch import _msgpack
from doc2tex_tpu_torch.config import loads_yaml, load_yaml
from doc2tex_tpu_torch.data.buckets import make_ladder, pad_to_bucket
from doc2tex_tpu_torch.data.synthetic import synth_hard_sample
from doc2tex_tpu_torch.recognition import flow
from doc2tex_tpu_torch.tokenizer.converters import TFMLabelConverter
from doc2tex_tpu_torch.tokenizer.vocab import load_vocab
from doc2tex_tpu_torch.transforms.preprocess import _resize_area

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
YAML_FILES = ["demo/recog_cfg.yaml"] + sorted(
    os.path.relpath(p, ROOT) for p in glob.glob(os.path.join(ROOT, "config", "*.yaml")))


@pytest.mark.parametrize("path", YAML_FILES)
def test_yaml_reader_equals_safe_load(path):
    with open(os.path.join(ROOT, path)) as f:
        ref = yaml.safe_load(f)
    assert load_yaml(os.path.join(ROOT, path)) == ref


@pytest.mark.parametrize("text", [
    "a:\n  - 1\n", "a: {b: 1}\n", "a: &x 1\n", "a: !!int 1\n", "a: |\n  x\n",
    "a: [1, [2]]\n", "a:\n\tb: 1\n", "- 1\n",
])
def test_yaml_reader_raises_outside_its_subset(text):
    with pytest.raises(ValueError):
        loads_yaml(text)


def test_msgpack_reader_equals_flax():
    path = os.path.join(ROOT, "saved_models/math_recog/synthetic_tfm/best_weights.msgpack")
    with open(path, "rb") as f:
        ref = traverse_util.flatten_dict(serialization.msgpack_restore(f.read()))
    ours = traverse_util.flatten_dict(_msgpack.load(path))
    assert ours.keys() == ref.keys()
    for key, value in ref.items():
        got = ours[key]
        assert np.asarray(got).dtype == np.asarray(value).dtype, key
        np.testing.assert_array_equal(got, value)


def test_msgpack_reader_raises_on_unknown_ext():
    # fixext1 (0xd4) with ext code 5
    with pytest.raises(ValueError, match="ext code 5"):
        _msgpack.unpackb(bytes([0x81, 0xA1, 0x61, 0xD4, 0x05, 0x00]))


@pytest.mark.parametrize("growth", [1.5, 2.2])
def test_ladder_and_padding_equal_jax(growth):
    ours = make_ladder([32, 32], [224, 704], 32, growth)
    ref = jax_buckets.make_ladder([32, 32], [224, 704], 32, growth)
    assert ours.shapes == ref.shapes
    for h, w in [(32, 32), (50, 300), (224, 704), (300, 10)]:
        assert ours.lookup(h, w) == ref.lookup(h, w)
    img = np.random.default_rng(0).integers(0, 256, (40, 70)).astype(np.uint8)
    np.testing.assert_array_equal(pad_to_bucket(img, (96, 96)),
                                  jax_buckets.pad_to_bucket(img, (96, 96)))


def test_recognition_helpers_equal_jax():
    cfg, weights = flow.load_recog_config(version="synthetic_tfm_big")
    jcfg, jweights = jax_flow.load_recog_config(version="synthetic_tfm_big")
    assert dict(cfg) == dict(jcfg) and weights == jweights
    assert cfg["bucket_growth"] == 2.2 and cfg["coalesce_ratio"] == 8
    groups = {(96, 352): [0, 3], (160, 704): [1], (32, 96): [2], (224, 704): [4]}
    for ratio in (0, 4, 8, 16):
        assert flow.coalesce_groups(dict(groups), ratio) == jax_flow.coalesce_groups(
            dict(groups), ratio)
    assert [flow._snap_batch(n) for n in (1, 2, 8, 9, 64, 65)] == [
        jax_flow._snap_batch(n) for n in (1, 2, 8, 9, 64, 65)]


def test_converter_and_postprocess_equal_jax():
    path = os.path.join(ROOT, "saved_models/math_recog/version2/vocab.txt")
    vocab = load_vocab(path)
    assert vocab == jax_load_vocab(path)
    ours, ref = TFMLabelConverter(vocab), JaxConverter(vocab)
    assert ours.character == ref.character
    ids = np.random.default_rng(0).integers(0, len(vocab) + 4, (6, 30))
    ids[2, 5] = 2
    assert ours.detokenize(ids) == ref.detokenize(ids)
    for row in ref.detokenize(ids):
        s = " ".join(row) + " \\hspace { 1 em } x"
        assert flow.postprocess_prediction(s) == jax_flow.postprocess_prediction(s)


def test_resize_without_pil_stays_near_pil():
    """The port resizes with F.interpolate, the JAX package with PIL.
    Upscaling (bilinear) is equal; downscaling (antialiased bilinear vs
    LANCZOS) is not bit-equal and stays within 8 gray levels on average."""
    img, _ = synth_hard_sample(np.random.default_rng(3), max_h=448, max_w=960)
    h, w = img.shape
    up = (_resize_area(img, 2 * h, 2 * w), jax_resize(img, 2 * h, 2 * w))
    np.testing.assert_array_equal(*up)
    for size in ((h // 2, w // 2), (40, 300)):
        ours, ref = _resize_area(img, *size), jax_resize(img, *size)
        assert ours.shape == ref.shape == size and ours.dtype == np.uint8
        assert np.abs(ours.astype(int) - ref.astype(int)).mean() < 8.0
