"""Write ``tests/torch_port_golden_zoo.json``: the JAX package's strings for
the zoo blocks of ``tests/torch_port_zoo.yaml``, which ``chip_smoke.py``'s
zoo phase holds the card to.

For each block: the port's model with every leaf drawn from numpy's seed
0 (``chip_smoke.zoo_recognizer``, as the phase builds it) is carried into
the JAX package through a msgpack of ``weights.to_variables``; the JAX package's
``MathRecognition`` then decodes the first ``chip_smoke.ZOO_N_CROPS`` crops of
``tests/torch_port_golden_synthetic.json`` on the CPU in float32, beam 10,
``batch_max_length`` cut to ``chip_smoke.VERSION_CUT_STEPS``; and the JAX
model's teacher-forced float32 logits of the first crop for
``chip_smoke.zoo_logit_inputs`` (``jax_logits``, ``ZOO_LOGIT_STEPS`` x the
classes, rounded to 9 significant digits).  The port's own CPU strings are
written beside them (not gated here).

    PYTHONPATH=. python tests/torch_port_zoo_golden.py [block ...]

(a few minutes a block on the CPU; not collected by pytest).
"""

from __future__ import annotations

import json
import os
import sys
import tempfile

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)
import chip_smoke  # noqa: E402  (the phase's blocks, cut, crops and weights)


def write(blocks=chip_smoke.ZOO_BLOCKS) -> None:
    import jax
    import jax.numpy as jnp
    import numpy as np

    jax.config.update("jax_platforms", "cpu")
    jax.config.update("jax_default_matmul_precision", "float32")
    from doc2tex_tpu.recognition.flow import MathRecognition as JaxRecognition
    from doc2tex_tpu.recognition.flow import load_recog_config as jax_load
    from doc2tex_tpu_torch import _msgpack
    from doc2tex_tpu_torch.recognition import load_recog_config
    from doc2tex_tpu_torch.weights import to_variables

    golden_src, crops = chip_smoke.golden_crops("synthetic")
    n = chip_smoke.ZOO_N_CROPS
    crops = crops[:n]
    golden = {"config": os.path.relpath(chip_smoke.ZOO_CONFIG, ROOT), "dtype": "float32",
              "beam": 10, "batch_max_length": chip_smoke.VERSION_CUT_STEPS,
              "weights": "chip_smoke.zoo_variables, seed 0",
              "crops": {"file": "tests/torch_port_golden_synthetic.json",
                        "seeds": [c["seed"] for c in golden_src["crops"][:n]]},
              "blocks": {}}
    if os.path.exists(chip_smoke.GOLDEN_ZOO):
        with open(chip_smoke.GOLDEN_ZOO) as f:
            golden["blocks"] = json.load(f).get("blocks", {})
    for block in blocks:
        cfg, weights = load_recog_config(chip_smoke.ZOO_CONFIG, version=block)
        assert weights is None, block
        port = chip_smoke.zoo_recognizer(chip_smoke.cut_config(cfg), "cpu")
        port_out = port(crops)
        with tempfile.TemporaryDirectory() as tmp:
            path = os.path.join(tmp, "zoo.msgpack")
            _msgpack.save(path, to_variables(port.model))
            jcfg, _ = jax_load(chip_smoke.ZOO_CONFIG, version=block)
            jrec = JaxRecognition(chip_smoke.cut_config(jcfg), path, beam_size=10)
            jax_out = jrec(crops)
        x, text = chip_smoke.zoo_logit_inputs(port, crops[0])
        variables = jax.tree_util.tree_map(jnp.asarray, jrec.variables)
        logits = np.asarray(jrec.model.apply(variables, jnp.asarray(x),
                                             jnp.asarray(text.astype(np.int32)), False))[0]
        golden["blocks"][block] = {
            "jax": jax_out, "port_cpu": port_out,
            "jax_logits": [[float(f"{v:.9g}") for v in row] for row in logits.tolist()]}
        same = sum(a == b for a, b in zip(jax_out, port_out))
        print(f"{block}: port CPU equals JAX on {same}/{len(crops)}", flush=True)
        with open(chip_smoke.GOLDEN_ZOO, "w") as f:
            json.dump(golden, f, indent=1, ensure_ascii=False)
            f.write("\n")


if __name__ == "__main__":
    write(tuple(sys.argv[1:]) or chip_smoke.ZOO_BLOCKS)
