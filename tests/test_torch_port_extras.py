"""The demo fork's extra components, the learned resizer's loop and
``api.infer --resizer`` against the JAX package, on the CPU.

Each module of ``doc2tex_tpu_torch.models.extras`` gets the JAX module's
``init`` variables (the BatchNorm statistics redrawn at random, so they
matter) through ``weights.py``, and the inputs of
``tests/test_recognition_extras.py`` (random where that file feeds
zeros): float32 outputs within 1e-5, in eval and (where a module has
BatchNorm) in training with flax's batch statistics and momentum.
``learned_resize`` follows JAX's loop with the same width predictor, and
the CLI's ``--resizer`` decodes a manifest with the same predictions.csv as
JAX's CLI, both reading one resizer weights file written by the port.
"""

from __future__ import annotations

import csv

import jax
import numpy as np
import pytest
import torch

from doc2tex_tpu.models import extras as jax_extras
from doc2tex_tpu_torch.models import extras
from doc2tex_tpu_torch.weights import load_variables, to_variables
from torch_port_threads import one_torch_thread  # noqa: F401

RNG = np.random.default_rng(0)


def _rand(*shape):
    return RNG.normal(0.0, 1.0, shape).astype(np.float32)


def _variables(jmod, *args):
    """``jmod.init`` variables with the BatchNorm statistics redrawn."""
    v = jax.tree_util.tree_map(np.asarray, dict(jmod.init(jax.random.PRNGKey(0), *args)))

    def redraw(path, leaf):
        name = path[-1].key
        if name == "var":
            return RNG.uniform(0.5, 1.5, leaf.shape).astype(np.float32)
        if name == "mean":
            return RNG.normal(0.0, 0.3, leaf.shape).astype(np.float32)
        return leaf

    return jax.tree_util.tree_map_with_path(redraw, v)


def _port(module, variables):
    assert load_variables(module, variables) == len(jax.tree_util.tree_leaves(variables))
    return module.eval()


def _close(got, want, atol=1e-5):
    np.testing.assert_allclose(np.asarray(got), np.asarray(want), atol=atol, rtol=0)


CASES = {
    "depthwise": (lambda: jax_extras.DepthwiseSeparableConv(features=8),
                  lambda: extras.DepthwiseSeparableConv(4, 8), [(1, 16, 16, 4)]),
    "aspp": (lambda: jax_extras.ASPP(features=16), lambda: extras.ASPP(32, 16),
             [(1, 8, 8, 32)]),
    "conv_module": (lambda: jax_extras.ConvModule(features=8, strides=(2, 2)),
                    lambda: extras.ConvModule(3, 8, strides=(2, 2)), [(2, 9, 11, 3)]),
    "clova_resnet": (lambda: jax_extras.ClovaResNetFeatureExtractor(output_channel=64),
                     lambda: extras.ClovaResNetFeatureExtractor(1, 64), [(1, 32, 64, 1)]),
    "configurable_vgg": (
        lambda: jax_extras.ConfigurableVGG(stages=((16,), (32,)), down_sample=((2, 2), (2, 1))),
        lambda: extras.ConfigurableVGG(1, ((16,), (32,)), ((2, 2), (2, 1))), [(1, 32, 63, 1)]),
    "learned_resizer": (lambda: jax_extras.LearnedResizer(num_buckets=21, width=16),
                        lambda: extras.LearnedResizer(21, 16), [(2, 64, 64, 1)]),
}


@pytest.mark.parametrize("case", sorted(CASES))
def test_extra_module_matches_jax(case):
    make_jax, make_port, shapes = CASES[case]
    jmod = make_jax()
    args = [_rand(*s) for s in shapes]
    variables = _variables(jmod, *args)
    port = _port(make_port(), variables)
    want = jmod.apply(variables, *args)
    with torch.no_grad():
        got = port(*map(torch.from_numpy, args))
    _close(got, want)
    if "batch_stats" in variables and case != "aspp":
        # training: flax's batch statistics, folded in at flax's momentum 0.99
        want, updates = jmod.apply(variables, *args, train=True, mutable=["batch_stats"])
        with torch.no_grad():
            got = port(*map(torch.from_numpy, args), train=True)
        _close(got, want, atol=1e-4)
        ported = to_variables(port)["batch_stats"]
        jax.tree_util.tree_map(lambda a, b: _close(a, b), ported,
                               jax.tree_util.tree_map(np.asarray, dict(updates["batch_stats"])))


def test_maxout_and_2d_cells_match_jax():
    x = _rand(2, 6)
    _close(extras.Maxout(2)(torch.from_numpy(x)), jax_extras.Maxout(pool_size=2)(x))

    jcell = jax_extras.LocationAwareAttention2DCell(hidden_dim=32)
    hidden, enc, align = _rand(2, 32), _rand(2, 4, 8, 16), np.abs(_rand(2, 4, 8))
    variables = _variables(jcell, hidden, enc, align)
    cell = _port(extras.LocationAwareAttention2DCell(32, 16, 32), variables)
    want = jcell.apply(variables, hidden, enc, align)
    with torch.no_grad():
        got = cell(*map(torch.from_numpy, (hidden, enc, align)))
    for a, b in zip(got, want):
        _close(a, b)

    jsar = jax_extras.SARDecoderCell(input_size=32, attention_size=16)
    feat, inp = _rand(2, 4, 8, 24), _rand(2, 12)
    carry = ((_rand(2, 32), _rand(2, 32)), (_rand(2, 32), _rand(2, 32)))
    variables = _variables(jsar, inp, feat, carry)
    sar = _port(extras.SARDecoderCell(12, 24, 32, 16), variables)
    want = jsar.apply(variables, inp, feat, carry)
    with torch.no_grad():
        got = sar(torch.from_numpy(inp), torch.from_numpy(feat),
                  jax.tree_util.tree_map(torch.from_numpy, carry))
    jax.tree_util.tree_map(lambda a, b: _close(a, b), jax.tree_util.tree_map(np.asarray, got),
                           jax.tree_util.tree_map(np.asarray, want))


@pytest.mark.parametrize("stride", [1, 2])
def test_position_layers_match_jax(stride):
    """``models.layers``: ``posenc_2d_hw`` and ``posenc_1d`` within 1e-6
    of JAX's tables (sin and cos differ in the last bit); ``Adaptive2DPositionalEncoding`` (NCHW in the port, NHWC in
    JAX) and ``PosConv`` (a depthwise SAME conv at strides 1 and 2) within
    1e-5; ``GatedSum`` in the BiLSTM stage's cases
    (``tests/test_torch_port_zoo.py``)."""
    from doc2tex_tpu.models import layers as jax_layers
    from doc2tex_tpu_torch.models import layers

    _close(layers.posenc_2d_hw(5, 7, 12), jax_layers.posenc_2d_hw(5, 7, 12), atol=1e-6)
    _close(layers.posenc_1d(9, 16), jax_layers.posenc_1d(9, 16), atol=1e-6)
    jad = jax_layers.Adaptive2DPositionalEncoding(d_model=16, max_h=8, max_w=12)
    x = _rand(2, 4, 6, 16)
    variables = _variables(jad, x)
    ad = _port(layers.Adaptive2DPositionalEncoding(16, 8, 12), variables)
    with torch.no_grad():
        got = ad(torch.from_numpy(x).permute(0, 3, 1, 2)).permute(0, 2, 3, 1)
    _close(got, jad.apply(variables, x))
    jpc = jax_layers.PosConv(dim=16, stride=stride)
    tokens = _rand(2, 24, 16)
    variables = _variables(jpc, tokens, (4, 6))
    pc = _port(layers.PosConv(16, stride), variables)
    with torch.no_grad():
        got = pc(torch.from_numpy(tokens), (4, 6))
    _close(got, jpc.apply(variables, tokens, (4, 6)))


def test_learned_resize_follows_jax_loop():
    """The same width predictor (a fixed sequence of bucket choices) drives
    both loops to the same bytes."""
    from doc2tex_tpu.transforms.preprocess import learned_resize as jax_learned_resize
    from doc2tex_tpu_torch.transforms.preprocess import learned_resize

    img = RNG.integers(0, 256, (40, 150)).astype(np.uint8)
    for answers in ([3, 3], [9, 2, 2, 2], [4, 6, 8, 10, 12, 14, 16, 18, 20, 1]):
        outs = []
        for fn in (jax_learned_resize, learned_resize):
            it = iter(answers * 2)
            outs.append(fn(img, lambda _img: next(it)))
        assert outs[0].shape == outs[1].shape
        np.testing.assert_array_equal(outs[1], outs[0])


def _manifest(tmp_path):
    from PIL import Image

    img_dir = tmp_path / "imgs"
    img_dir.mkdir()
    rows = []
    rng = np.random.default_rng(5)
    for i in range(4):
        img = np.full((36, 60 + 30 * i), 255, np.uint8)
        img[8:28, 6:-6] = rng.integers(0, 120, (20, 48 + 30 * i))
        Image.fromarray(img).save(img_dir / f"{i}.png")
        rows.append((f"{i}.png", "x + 1"))
    csv_path = tmp_path / "labels.tsv"
    with open(csv_path, "w", newline="") as f:
        csv.writer(f, delimiter="\t").writerows(rows)
    return str(csv_path), str(img_dir)


def test_seeded_resizer_is_drawn_by_numpy():
    """Without ``resizer_weights`` the resizer's weights are
    ``random_variables`` of numpy's seed 0, whatever torch's generator
    holds, so every torch version builds the same resizer."""
    from doc2tex_tpu_torch.api.infer import make_resizer_hook
    from doc2tex_tpu_torch.weights import random_variables

    states = []
    for seed in (0, 1):
        torch.manual_seed(seed)
        states.append(make_resizer_hook({}, device="cpu").model.state_dict())
    want = extras.LearnedResizer(num_buckets=21)
    load_variables(want, random_variables(to_variables(want), np.random.default_rng(0)))
    for state in states:
        assert state.keys() == want.state_dict().keys()
        assert all(torch.equal(v, want.state_dict()[k]) for k, v in state.items())


def test_infer_resizer_matches_jax_cli(tmp_path, capsys):
    """``api.infer --resizer`` on a tiny config: the port's seeded resizer
    and recognizer, written as weights files that both CLIs read
    (``resizer_weights``, ``saved_model``), give JAX's predictions.csv row
    for row."""
    import sys

    import api.infer as jax_infer
    from doc2tex_tpu_torch import _msgpack
    from doc2tex_tpu_torch.api import infer
    from doc2tex_tpu_torch.api.infer import make_resizer_hook
    from doc2tex_tpu_torch.config import load_config
    from doc2tex_tpu_torch.models import build_model
    from doc2tex_tpu_torch.tokenizer.converters import create_converter

    csv_path, img_dir = _manifest(tmp_path)
    resizer, model = tmp_path / "resizer.msgpack", tmp_path / "model.msgpack"
    _msgpack.save(str(resizer), to_variables(make_resizer_hook({}, device="cpu").model))
    cfg = tmp_path / "tiny.yaml"
    cfg.write_text(TINY_YAML.format(resizer=resizer, model=model))
    config = load_config(str(cfg))
    torch.manual_seed(3)
    _msgpack.save(str(model), to_variables(build_model(
        config, create_converter(config).num_classes)))
    argv = ["--config", str(cfg), "--csv_dir", csv_path, "--data_dir", img_dir, "--resizer"]
    old = sys.argv
    try:
        sys.argv = ["infer.py", *argv, "--log_path", str(tmp_path / "jax")]
        jax_infer.main()
    finally:
        sys.argv = old
    infer.main(argv + ["--device", "cpu", "--log_path", str(tmp_path / "port")])
    capsys.readouterr()
    rows = {}
    for side in ("jax", "port"):
        with open(tmp_path / side / "predictions.csv", newline="") as f:
            rows[side] = list(csv.reader(f))
    assert rows["port"] == rows["jax"] and len(rows["port"]) == 5


TINY_YAML = """\
max_dimension: [64, 256]
min_dimension: [32, 32]
batch_max_length: 6
dtype: float32
beam_size: 1
synthetic_data: 1
resizer_weights: {resizer}
saved_model: {model}
FeatureExtraction:
  name: 'None'
SequenceModeling:
  name: ViT
  params:
    backbone:
      name: resnet
      input_channel: 1
      output_channel: 32
      gcb: False
    fix_embed: True
    input_channel: 1
    patching_style: 2d
    patch_size: [2, 2]
    depth: 1
    num_heads: 2
    hidden_size: 32
Prediction:
  name: TFM
  params:
    d_model: 32
    nhead: 2
    num_decoder_layers: 1
    dim_feedforward: 64
    dropout: 0.0
"""
