"""Write ``tests/torch_port_golden_coalesce.json``: the JAX package's strings
and decode invocations for ``chip_smoke.py``'s coalesce phase.

The released ``synthetic_tfm_big`` in float32 (``quantize`` off), beam 10,
on the first ``chip_smoke.COALESCE_N`` crops of the coalescing gate's set
(``synth_hard_dataset(n, seed=34)`` at the soak's operating point, as
``tools/coalesce_eval.py`` draws it), decoded by the JAX package's
``MathRecognition`` in one chunk of ``chip_smoke.COALESCE_N`` with
coalescing off and at ratio 8, the invocations counted by the JAX tool's
spy on ``_decode_fn``.

    PYTHONPATH=. python tests/torch_port_coalesce_golden.py

(JAX on the CPU, several minutes; not collected by pytest).
"""

from __future__ import annotations

import hashlib
import json
import os
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)
import chip_smoke  # noqa: E402  (the phase's sizes and the golden's path)


def write() -> None:
    import jax

    jax.config.update("jax_platforms", "cpu")
    jax.config.update("jax_default_matmul_precision", "float32")
    from doc2tex_tpu.data.synthetic import synth_hard_dataset
    from doc2tex_tpu.recognition.flow import MathRecognition, load_recog_config
    from doc2tex_tpu.recognition.flow import postprocess_prediction
    from doc2tex_tpu_torch.tools.coalesce_eval import EVAL_SEED
    from doc2tex_tpu_torch.tools.release_eval import GENERATOR

    n = chip_smoke.COALESCE_N
    cfg, weights = load_recog_config(version="synthetic_tfm_big")
    cfg["dtype"], cfg["quantize"] = "float32", None
    images, labels = synth_hard_dataset(n, seed=EVAL_SEED, **GENERATOR)
    recog = MathRecognition(cfg, weights_path=weights, beam_size=chip_smoke.COALESCE_BEAM)
    calls = [0]
    real = recog._decode_fn()

    def spy(variables, batch):
        calls[0] += 1
        return real(variables, batch)

    recog._decode_cache[recog.beam_size] = spy
    gts = [postprocess_prediction(label) for label in labels]
    rows = {}
    for ratio in chip_smoke.COALESCE_RATIOS:
        recog.coalesce_ratio = float(ratio)
        calls[0] = 0
        preds = recog(list(images))
        key = "off" if not ratio else f"ratio_{ratio}"
        rows[key] = {"strings": preds, "invocations": calls[0],
                     "em": sum(p == g for p, g in zip(preds, gts)) / n}
        print(key, rows[key]["invocations"], rows[key]["em"], flush=True)
    golden = {"version": "synthetic_tfm_big", "dtype": "float32", "quantize": None,
              "beam": chip_smoke.COALESCE_BEAM, "chunk": n, "n": n, "seed": EVAL_SEED,
              "generator": {k: list(v) if isinstance(v, tuple) else v
                            for k, v in GENERATOR.items()},
              "sha256": [hashlib.sha256(im.tobytes()).hexdigest() for im in images],
              "labels": gts, "rows": rows}
    with open(chip_smoke.GOLDEN_COALESCE, "w") as f:
        json.dump(golden, f, indent=1)
        f.write("\n")


if __name__ == "__main__":
    write()
