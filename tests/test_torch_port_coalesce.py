"""The coalescing gate's twin (``doc2tex_tpu_torch/tools/coalesce_eval.py``)
against the JAX tool's loop (``tools/coalesce_eval.py``), re-run here with
the same spy on JAX's ``_decode_fn``: a tiny TFM recognizer (float32, beam
3, the growth-2.2 ladder over three buckets), JAX's random init carried
into the port.  Predictions, exact match, identity and invocation counts
equal, with coalescing off and at ratios 2 and 16.

The file imports JAX only inside its tests, and holds torch to one thread.
"""

from __future__ import annotations

import os
import sys

import numpy as np

from doc2tex_tpu_torch.config import make_config
from doc2tex_tpu_torch.data.synthetic import HARD_VOCAB_PATH, synth_hard_dataset
from doc2tex_tpu_torch.recognition.flow import MathRecognition, postprocess_prediction
from doc2tex_tpu_torch.tools import coalesce_eval
from doc2tex_tpu_torch.weights import load_variables

HERE = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, HERE)
from torch_port_threads import one_torch_thread  # noqa: E402,F401

RATIOS = (2, 16)
CHUNK = 6


def _tiny_config() -> dict:
    return dict(
        max_dimension=[64, 256], min_dimension=[32, 32], batch_max_length=10,
        dtype="float32", vocab=HARD_VOCAB_PATH, beam_size=3, bucket_growth=2.2, clahe=False,
        FeatureExtraction={"name": "None"},
        SequenceModeling={"name": "ViT", "params": {
            "backbone": {"name": "resnet", "input_channel": 1, "output_channel": 16,
                         "gcb": False},
            "fix_embed": True, "input_channel": 1, "patching_style": "2d",
            "patch_size": [2, 2], "depth": 1, "num_heads": 2, "hidden_size": 16}},
        Prediction={"name": "TFM", "params": {
            "d_model": 16, "nhead": 2, "num_decoder_layers": 1, "dim_feedforward": 32,
            "dropout": 0.0}},
    )


def _jax_tool_loop(recog, images, labels, ratios, chunk):
    """The body of ``tools/coalesce_eval.py``'s ``main`` after the model is
    built (its spy, chunks, passes and rows; no warm-up pass)."""
    gts = [postprocess_prediction(label) for label in labels]
    n_calls = [0]
    real = recog._decode_fn()

    def spy(variables, batch):
        n_calls[0] += 1
        return real(variables, batch)

    recog._decode_cache[recog.beam_size] = spy
    chunks = [images[i:i + chunk] for i in range(0, len(images), chunk)]

    def run(ratio):
        recog.coalesce_ratio = float(ratio)
        n_calls[0] = 0
        preds = []
        for ch in chunks:
            preds.extend(recog(list(ch)))
        em = sum(p == g for p, g in zip(preds, gts)) / len(gts)
        return preds, {"em": round(em, 4), "invocations": n_calls[0]}

    base_preds, base_row = run(0.0)
    rows, preds = {"off": dict(base_row, identity=1.0)}, {"off": base_preds}
    for r in ratios:
        got, row = run(float(r))
        row["identity"] = round(sum(p == b for p, b in zip(got, base_preds)) / len(got), 4)
        rows[f"ratio_{r}"], preds[f"ratio_{r}"] = row, got
    return rows, preds


def test_evaluate_equals_jax_tool_loop():
    import jax

    jax.config.update("jax_platforms", "cpu")
    from doc2tex_tpu.config import make_config as jax_make_config
    from doc2tex_tpu.recognition.flow import MathRecognition as JaxRecognition

    images, labels = synth_hard_dataset(12, seed=coalesce_eval.EVAL_SEED, min_len=3,
                                        max_len=10, max_h=64, max_w=256, scale_range=(2, 3))
    jrec = JaxRecognition(jax_make_config(_tiny_config()), None, seed=0)
    rec = MathRecognition(make_config(_tiny_config()), None, device="cpu")
    load_variables(rec.model, jax.tree_util.tree_map(np.asarray, jrec.variables))
    buckets = {rec.bucket_key(im) for im in images}
    assert len(buckets) == 3, buckets      # three groups, which ratios 2 and 16 merge

    rows, preds = coalesce_eval.evaluate(rec, images, labels, RATIOS, CHUNK, warmup=False)
    jrows, jpreds = _jax_tool_loop(jrec, images, labels, RATIOS, CHUNK)
    assert preds == jpreds
    for key, jrow in jrows.items():
        assert {k: rows[key][k] for k in jrow} == jrow, key
    calls = [rows[k]["invocations"] for k in ("off", *(f"ratio_{r}" for r in RATIOS))]
    assert calls[0] > calls[1] > calls[2], calls      # coalescing merges invocations
    assert rec.coalesce_ratio == 0.0 and "decode_group" not in vars(rec)
