"""The port's release-eval path against the JAX package's, on the CPU.

- ``eval/metrics.py``: exact match, the character and word match scores
  and corpus BLEU equal JAX's on random token strings (and empty ones).
- ``data/loader.BucketLoader``: the eval batches of 96 hard samples equal
  JAX's ``BucketLoader(train=False)`` in bucket, image bytes, labels, names
  and order (the int8 encoder's activation scale is per batch, so the
  batching is part of the function).
- ``engine/inferencing.validation`` on a tiny float32 model gives JAX's
  metric dict.
- ``data/synthetic.hard_vocab`` and the eval set equal JAX's, and
  ``tools/release_eval.soak_config`` equals what
  ``tools/structured_soak.py::build`` gives the releases.
"""

from __future__ import annotations

import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest

import doc2tex_tpu.data.synthetic as jsyn
import doc2tex_tpu.eval.metrics as jmetrics
from doc2tex_tpu.config import make_config as jax_make_config
from doc2tex_tpu.data.loader import ArrayDataset as JaxArrayDataset
from doc2tex_tpu.data.loader import BucketLoader as JaxBucketLoader
from doc2tex_tpu.decode.runner import make_decode_fn as jax_make_decode_fn
from doc2tex_tpu.engine.inferencing import validation as jax_validation
from doc2tex_tpu.models import build_model as jax_build_model
from doc2tex_tpu.tokenizer.converters import AttnLabelConverter as JaxAttnConverter
from doc2tex_tpu.tokenizer.converters import TFMLabelConverter as JaxTFMConverter
from doc2tex_tpu_torch.config import make_config
from doc2tex_tpu_torch.data import synthetic
from doc2tex_tpu_torch.data.loader import ArrayDataset, BucketLoader
from doc2tex_tpu_torch.decode.runner import make_decode_fn
from doc2tex_tpu_torch.engine.inferencing import validation
from doc2tex_tpu_torch.eval import metrics
from doc2tex_tpu_torch.tokenizer.converters import TFMLabelConverter
from doc2tex_tpu_torch.models import build_model
from doc2tex_tpu_torch.tools.release_eval import GENERATOR, soak_config
from doc2tex_tpu_torch.weights import load_variables
from test_torch_port_model import _random_variables, tiny_config

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
TOKENS = [f"t{i}" for i in range(20)]   # the tiny model's 20 tokens after 4 specials


def _random_strings(rng, n, vocab):
    return [" ".join(rng.choice(vocab, size=int(rng.integers(0, 9)))) for _ in range(n)]


def test_metrics_equal_jax_on_random_strings():
    rng = np.random.default_rng(0)
    vocab = ["a", "b", "\\frac", "{", "}", "x", "^"]
    gts = _random_strings(rng, 60, vocab)
    preds = [g if i % 3 == 0 else s for i, (g, s) in
             enumerate(zip(gts, _random_strings(rng, 60, vocab)))]
    preds[1], gts[2] = "", ""
    assert metrics.exact_match(preds, gts) == jmetrics.exact_match(preds, gts)
    for g, p in zip(gts, preds):
        assert metrics.get_single_ED(g, p) == jmetrics.get_single_ED(g, p)
        assert metrics.levenshtein(g, p) == jmetrics.levenshtein(g, p)
        assert metrics.levenshtein(g.split(), p.split()) == jmetrics._lev_py(g.split(), p.split())
    assert metrics.get_word_NED(preds, gts) == jmetrics.get_word_NED(preds, gts)
    cand, refs = [p.split() for p in preds], [[g.split()] for g in gts]
    assert metrics.bleu_score(cand, refs) == jmetrics.bleu_score(cand, refs) > 0


def test_hard_vocab_and_eval_set_equal_jax():
    assert synthetic.hard_vocab() == jsyn.hard_vocab()
    images, labels = synthetic.synth_hard_dataset(12, seed=33, **GENERATOR)
    jimages, jlabels = jsyn.synth_hard_dataset(12, seed=33, **GENERATOR)
    assert labels == jlabels
    assert all(np.array_equal(a, b) for a, b in zip(images, jimages))


@pytest.mark.parametrize("family,big", [("attn", False), ("tfm", True)])
def test_soak_config_is_the_release_training_config(family, big, monkeypatch):
    """The twin's copy of the soak configuration against
    ``structured_soak.build(..., hard=True)`` on every key it keeps (the
    JAX-only compile-cache settings of ``build`` switched off)."""
    monkeypatch.setattr(jax.config, "update", lambda *a, **k: None)
    monkeypatch.syspath_prepend(os.path.join(ROOT, "tools"))
    from structured_soak import build

    want = build(100000, hard=True, family=family, big=big)
    got = soak_config(family, big)
    for key in ("max_dimension", "min_dimension", "batch_max_length", "batch_size",
                "keep_smaller_batches", "bucket_growth", "bucket_mode", "downsample",
                "scale_factor", "token_level", "dtype", "mean", "std", "beam_size",
                "FeatureExtraction", "SequenceModeling", "Prediction"):
        assert got[key] == want[key], key


def test_eval_batches_equal_jax():
    images, labels = synthetic.synth_hard_dataset(96, seed=33, **GENERATOR)
    cfg = dict(soak_config(), batch_size=8)
    names = [f"s{i}" for i in range(96)]
    got = list(BucketLoader(ArrayDataset(images, labels, names), make_config(cfg)))
    want = list(JaxBucketLoader(JaxArrayDataset(images, labels, names),
                                JaxAttnConverter(jsyn.hard_vocab()), jax_make_config(cfg),
                                train=False, prefetch=0))
    assert len(got) == len(want) >= 6
    for g, w in zip(got, want):
        assert g.bucket == w.bucket and g.labels == w.labels and g.names == w.names
        assert g.images.dtype == np.uint8 and np.array_equal(g.images, w.images)
    kept = sum(len(b.labels) for b in got)
    assert kept % 8 == 0 and kept < 96       # ragged tails dropped, as JAX does


def test_validation_equals_jax_dict():
    """A tiny float32 TFM model (greedy; random weights, the end token's
    bias at 1.5 so that predictions end at 20 to 31 tokens): the same
    metric dict, on labels of which every other one is the model's own
    prediction, so exact match is neither 0 nor 1."""
    jmodel = jax_build_model(jax_make_config(tiny_config()), 24)
    shapes = jax.eval_shape(
        lambda: jmodel.init(jax.random.PRNGKey(0), jnp.zeros((1, 32, 64, 1)),
                            jnp.zeros((1, 41), jnp.int32), train=False))
    variables = _random_variables(dict(shapes), np.random.default_rng(0))
    variables["params"]["predicter"]["b_proj"][2] = 1.5
    port = build_model(make_config(tiny_config()), 24).eval()
    load_variables(port, variables)
    variables = jax.tree_util.tree_map(jnp.asarray, variables)
    cfg = dict(tiny_config(), batch_size=4, keep_smaller_batches=False)
    rng = np.random.default_rng(2)
    # one bucket, (32, 64), so each package compiles one decode
    images = [rng.integers(0, 256, (int(rng.integers(20, 33)), int(rng.integers(33, 65))))
              .astype(np.uint8) for _ in range(20)]
    labels = _random_strings(rng, 20, TOKENS)
    pconv, jconv = TFMLabelConverter(TOKENS), JaxTFMConverter(TOKENS)
    decode = make_decode_fn(port, make_config(cfg), beam_size=1, device="cpu")
    first = validation(decode, pconv, BucketLoader(ArrayDataset(images, labels),
                                                   make_config(cfg)), cfg)
    own = {name: pred for name, _, pred in first["samples"]}
    labels = [own.get(str(i), lb) if i % 2 == 0 else lb for i, lb in enumerate(labels)]

    class State:
        params = variables["params"]
        batch_stats = variables["batch_stats"]

    jcfg = jax_make_config(cfg)
    want = jax_validation(jmodel, State(), jconv,
                          JaxBucketLoader(JaxArrayDataset(images, labels), jconv, jcfg,
                                          train=False, prefetch=0), jcfg,
                          decode_fn=jax_make_decode_fn(jmodel, jcfg, beam_size=1))
    got = validation(decode, pconv, BucketLoader(ArrayDataset(images, labels),
                                                 make_config(cfg)), cfg)
    assert got["samples"] == want["samples"]
    for key in ("accuracy", "bleu", "ED", "word_ED", "n_samples"):
        assert got[key] == want[key], key
    assert 0 < got["accuracy"] < 1 and got["n_samples"] == 20
