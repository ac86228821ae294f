"""Guards for the port's run on the GPU machine, checked on the CPU.

- the port and ``chip_smoke.py`` import with jax, flax, yaml, msgpack, PIL,
  cv2, lmdb and the JAX package blocked (none is on the GPU machine);
- ``chip_smoke.py`` exits non-zero, and never prints ``"ok": true``, on a
  machine without a card and from a directory without the repository;
- chip_smoke's slice phase runs end to end on the CPU at a tiny size, for
  the TFM head and for the coverage-LSTM head, and its B2 kernel phase
  checks the shapes the ``synthetic`` slice launches.
"""

from __future__ import annotations

import os
import shutil
import subprocess
import sys
import textwrap

import numpy as np

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
BLOCKED = ("jax", "jaxlib", "flax", "yaml", "msgpack", "PIL", "cv2", "lmdb", "doc2tex_tpu")

GUARD = textwrap.dedent(f"""
    import importlib, pkgutil, sys
    BLOCKED = {BLOCKED!r}
    for name in list(sys.modules):
        if name.split(".")[0] in BLOCKED:
            del sys.modules[name]

    class Block:
        def find_spec(self, name, path=None, target=None):
            if name.split(".")[0] in BLOCKED:
                raise ImportError("blocked import: " + name)
            return None

    sys.meta_path.insert(0, Block())
    import doc2tex_tpu_torch
    names = [m.name for m in pkgutil.walk_packages(doc2tex_tpu_torch.__path__,
                                                   "doc2tex_tpu_torch.")]
    for name in names:
        importlib.import_module(name)
    import chip_smoke
    leaked = sorted(n for n in sys.modules if n.split(".")[0] in BLOCKED)
    assert not leaked, leaked
    print("imported", len(names))
""")


def _env(**extra):
    env = dict(os.environ, PYTHONPATH=ROOT, CUDA_VISIBLE_DEVICES="")
    env.update(extra)
    return env


def test_port_imports_nothing_the_gpu_machine_lacks():
    out = subprocess.run([sys.executable, "-c", GUARD], cwd=ROOT, env=_env(),
                         capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stderr
    assert int(out.stdout.split()[-1]) >= 22


def test_chip_smoke_fails_without_a_card(tmp_path):
    for cwd, script in ((ROOT, os.path.join(ROOT, "chip_smoke.py")),
                        (tmp_path, shutil.copy(os.path.join(ROOT, "chip_smoke.py"), tmp_path))):
        env = _env(PYTHONPATH="") if cwd == tmp_path else _env()
        out = subprocess.run([sys.executable, script], cwd=cwd, env=env,
                             capture_output=True, text=True, timeout=300)
        assert out.returncode != 0
        assert '"ok": true' not in out.stdout


def test_chip_smoke_slice_phase_runs_on_cpu():
    """chip_smoke.run_slice at a tiny size with random weights: the main
    path's shapes and control flow, without the card."""
    sys.path.insert(0, ROOT)
    import chip_smoke
    from doc2tex_tpu_torch.config import make_config
    from doc2tex_tpu_torch.data.synthetic import HARD_VOCAB_PATH, synth_hard_sample

    cfg = make_config(dict(
        max_dimension=[64, 256], min_dimension=[32, 32], batch_max_length=10,
        dtype="float32", quantize=None, clahe=False, bucket_growth=2.2, coalesce_ratio=8,
        vocab=HARD_VOCAB_PATH,
        FeatureExtraction={"name": "None"},
        SequenceModeling={"name": "ViT", "params": {
            "backbone": {"name": "resnet", "input_channel": 1, "output_channel": 32},
            "fix_embed": True, "patching_style": "2d", "patch_size": [2, 2],
            "depth": 1, "num_heads": 2, "hidden_size": 64}},
        Prediction={"name": "TFM", "params": {
            "d_model": 64, "nhead": 2, "num_decoder_layers": 1, "dim_feedforward": 64}},
    ))
    crops = [synth_hard_sample(np.random.default_rng(s), min_len=3, max_len=12,
                               max_h=64, max_w=256)[0] for s in range(3)]
    out, launches, steps, seconds = chip_smoke.run_slice(cfg, None, crops, 3, "cpu")
    assert len(out) == 3 and all(isinstance(s, str) for s in out)
    assert launches == 0 and steps == 0 and seconds > 0  # CPU: the plain version, no kernel


def test_chip_smoke_lstm_slice_runs_on_cpu():
    """chip_smoke.run_slice with a tiny Attnv2 coverage model (random
    weights), beam 3: the LSTM path's shapes and control flow."""
    sys.path.insert(0, ROOT)
    import chip_smoke
    from doc2tex_tpu_torch.config import make_config
    from doc2tex_tpu_torch.data.synthetic import HARD_VOCAB_PATH, synth_hard_sample

    cfg = make_config(dict(
        max_dimension=[64, 256], min_dimension=[32, 32], batch_max_length=10,
        dtype="float32", quantize=None, clahe=False, bucket_growth=2.2,
        vocab=HARD_VOCAB_PATH,
        FeatureExtraction={"name": "None"},
        SequenceModeling={"name": "ViT", "params": {
            "backbone": {"name": "resnet", "input_channel": 1, "output_channel": 32},
            "fix_embed": True, "patching_style": "2d", "patch_size": [2, 2],
            "depth": 1, "num_heads": 2, "hidden_size": 64}},
        Prediction={"name": "Attnv2", "params": {
            "seqmodel": "TFM", "input_size": 64, "hidden_size": 64, "kernel_size": 2,
            "kernel_dim": 16, "enc_init": True, "attn_type": "coverage"}},
    ))
    crops = [synth_hard_sample(np.random.default_rng(s), min_len=3, max_len=12,
                               max_h=64, max_w=256)[0] for s in range(3)]
    out, launches, steps, seconds = chip_smoke.run_slice(cfg, None, crops, 3, "cpu")
    assert len(out) == 3 and all(isinstance(s, str) for s in out)
    assert launches == 0 and steps == 0 and seconds > 0  # CPU: the plain version, no kernel


def test_chip_smoke_lstm_launch_shapes_are_the_slice_shapes(monkeypatch):
    """chip_smoke.lstm_launch_shapes (the shapes its B2 kernel phase checks
    and times) equals the set of shapes the ``synthetic`` slice gives the
    attention step, recorded on the CPU with decoding cut to 2 steps (the
    shapes do not depend on the step count)."""
    sys.path.insert(0, ROOT)
    import chip_smoke
    from doc2tex_tpu_torch.models import decoder_lstm
    from doc2tex_tpu_torch.recognition import MathRecognition, load_recog_config

    seen = set()
    step = decoder_lstm.fused_attention_step

    def recording(enc, enc_proj, q, loc_feat, *args, **kwargs):
        seen.add((enc.shape[0], enc.shape[1], enc.shape[2], enc_proj.shape[2], loc_feat.shape[2]))
        return step(enc, enc_proj, q, loc_feat, *args, **kwargs)

    monkeypatch.setattr(decoder_lstm, "fused_attention_step", recording)
    _, crops = chip_smoke.golden_crops("synthetic")
    cfg, weights = load_recog_config(version="synthetic")
    cfg["quantize"], cfg["batch_max_length"] = None, 1
    MathRecognition(cfg, weights, beam_size=10, device="cpu")(crops)
    assert sorted(seen) == chip_smoke.lstm_launch_shapes()
