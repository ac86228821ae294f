"""Guards for the port's run on the GPU machine, checked on the CPU.

- the port and ``chip_smoke.py`` import with jax, flax, yaml, msgpack, PIL,
  cv2, lmdb, scipy and the JAX package blocked (none is on the GPU
  machine), the int8, serving, release-eval, detection, page-app,
  page-eval, training, eval-CLI, detector-training, stitch, int8-eval,
  data-chain modules, the JPEG decoder and the reference's gates and tools
  (coalescing, PDF stitch, image metrics, interpretation, rendering,
  weight export, the end-to-end demo, the resizer's trainer) and the mesh
  (``parallel/``, ``tools/dryrun_multichip.py``) among them;
- ``api.serve --data_parallel 2 --device cpu --selftest 8`` (rank 0 and a
  follower process) answers every crop with the single process's strings;
- ``chip_smoke.py`` exits non-zero, and never prints ``"ok": true``, on a
  machine without a card and from a directory without the repository;
- chip_smoke's slice phase runs end to end on the CPU at a tiny size, for
  the TFM head and for the coverage-LSTM head, and its B2 kernel phase
  checks the shapes the ``synthetic`` slice launches;
- its zoo phase (phase 20) runs on the CPU with a tiny bahdanau block, and
  ``tests/torch_port_golden_zoo.json`` holds JAX's strings for every block of
  ``tests/torch_port_zoo.yaml``.
"""

from __future__ import annotations

import json
import os
import shutil
import subprocess
import sys
import textwrap

import numpy as np
import pytest
from torch_port_threads import one_torch_thread  # noqa: F401

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
BLOCKED = ("jax", "jaxlib", "flax", "yaml", "msgpack", "PIL", "cv2", "lmdb", "scipy",
           "doc2tex_tpu")
# the modules of the int8 encoder, the server, the release eval, detection,
# the page app, the page eval, training, the eval CLI, the device pools, the
# soak twins, the detector's losses and data, the voting stitch, the int8
# accuracy twin, the data chain (LMDB stores, the native scorer and
# tokenizer, the LaTeX pipeline, the dataset tools and the realdata twin)
# and the model zoo (VGG, BiLSTM, the extras, the reference importer),
# which the walk below must reach
REQUIRED = ("ops.quant", "serving", "api.serve", "utils.png", "data.loader", "eval.metrics",
            "engine.inferencing", "tools.release_eval", "tools.bench_int8", "detection",
            "detection.priors", "detection.windows", "detection.ssd", "detection.boxes",
            "detection.flow", "detection.evaluate", "app", "tools.page_eval",
            "tools.profile_page", "train", "train.loss", "train.schedule", "train.optim",
            "train.trainer", "train.checkpoint", "engine.training", "api.train",
            "utils.common", "utils.profiling", "transforms.geometry", "api.infer",
            "data.device_pool", "tools.structured_soak", "detection.loss", "detection.data",
            "detection.stitch", "tools.detection_soak", "tools.int8_accuracy_eval",
            "data.pylmdb", "data.lmdb_reader", "native", "latex.pytok", "latex._katex_tables",
            "latex.validate", "latex.normalize", "latex.demacro", "latex.extract",
            "tools.vocab_tools", "tools.label_tools", "tools.lmdb_builder", "tools.arxiv",
            "tools.realdata", "models.vgg", "models.bilstm", "models.extras",
            "tools.torch_import", "utils.jpeg", "tools.coalesce_eval", "tools.stitch_pdf",
            "tools.image_eval", "tools.evaluate_images", "tools.inspect_images",
            "tools.interpretation", "tools.render", "tools.export_demo_weights",
            "tools.e2e_demo", "tools.train_resizer", "tools.bench_host_tools", "parallel",
            "parallel.mesh", "tools.dryrun_multichip")

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
    missing = [r for r in {REQUIRED!r} if "doc2tex_tpu_torch." + r not in names]
    assert not missing, missing
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
    assert int(out.stdout.split()[-1]) >= 85


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
    step = decoder_lstm.coverage_attention_step

    def recording(enc, enc_proj, q, mem, loc_conv_w, *args, **kwargs):
        seen.add((enc.shape[0], q.shape[0] // enc.shape[0], enc.shape[1], enc.shape[2],
                  enc_proj.shape[2], loc_conv_w.shape[2]))
        return step(enc, enc_proj, q, mem, loc_conv_w, *args, **kwargs)

    monkeypatch.setattr(decoder_lstm, "coverage_attention_step", recording)
    _, crops = chip_smoke.golden_crops("synthetic")
    cfg, weights = load_recog_config(version="synthetic")
    cfg["quantize"], cfg["batch_max_length"] = None, 1
    MathRecognition(cfg, weights, beam_size=10, device="cpu")(crops)
    assert sorted(seen) == chip_smoke.lstm_launch_shapes()


def test_chip_smoke_tfm_launch_shapes_are_the_slice_shapes(monkeypatch):
    """chip_smoke.tfm_launch_shapes (the shapes its B1 kernel phase checks
    and times) equals the (B, K, M, last live step) of the decode_attention
    launches that the ``synthetic_tfm_big`` slice makes on the golden crops,
    recorded on the CPU.  The release config is cut to one narrow layer
    with random weights: the launch shapes follow from the crops, buckets,
    batch snap, beam, chunk schedule and patch grid, which the cut keeps.
    The random head ends no hypothesis, so the decode runs every step and
    reaches every cache chunk."""
    sys.path.insert(0, ROOT)
    import chip_smoke
    from doc2tex_tpu_torch.models import decoder_tfm
    from doc2tex_tpu_torch.recognition import MathRecognition, load_recog_config

    seen = {}
    attend = decoder_tfm.decode_attention

    def recording(q, k, v, mask=None):
        B, K, M = q.shape[0], q.shape[1], k.shape[1]
        t = None  # the last step a hypothesis attends: its slot position // K
        if mask is not None:
            t = int(mask.any(dim=(0, 1)).nonzero().max()) // K
            t = max(t, seen.get((B, K, M), -1))
        seen[(B, K, M)] = t
        return attend(q, k, v, mask)

    monkeypatch.setattr(decoder_tfm, "decode_attention", recording)
    cfg, _ = load_recog_config(version="synthetic_tfm_big")
    cfg["quantize"] = None
    vit, head = cfg["SequenceModeling"]["params"], cfg["Prediction"]["params"]
    vit["backbone"]["output_channel"] = 16
    vit.update(depth=1, num_heads=1, hidden_size=16)
    head.update(d_model=16, nhead=1, num_decoder_layers=1, dim_feedforward=16)
    _, crops = chip_smoke.golden_crops("synthetic_tfm_big")
    MathRecognition(cfg, None, beam_size=10, device="cpu")(crops)
    steps = max(t for t in seen.values() if t is not None) + 1
    assert steps == cfg["batch_max_length"] + 1
    recorded = sorted(((B, K, M, t) for (B, K, M), t in seen.items()),
                      key=lambda s: (s[3] is None, s))
    assert recorded == chip_smoke.tfm_launch_shapes(steps, config=cfg)
    assert recorded[0][:3] == (64, 10, 310) and recorded[-1] == (64, 10, 624, None)


def test_chip_smoke_page_gates():
    """chip_smoke's detect and page gates on the golden pages: boxes within
    0.5 px and scores within 1e-3 pass; a box moved further, or a missing
    box scored far from the threshold, fails; one string miss passes, two
    fail."""
    import pytest

    sys.path.insert(0, ROOT)
    import chip_smoke

    golden, pages = chip_smoke.golden_pages()
    assert len(pages) == 3 and all(p.shape == (1024, 1280) for p in pages)
    near = [(np.asarray(g["boxes"]) + 0.3, np.asarray(g["scores"]) - 5e-4)
            for g in golden["pages"]]
    n_pairs, worst_px, _, unmatched = chip_smoke.check_detections(golden, near, 0.5)
    assert n_pairs == sum(len(g["boxes"]) for g in golden["pages"]) and not unmatched
    assert abs(worst_px - 0.3) < 1e-6
    moved = [(b.copy(), s) for b, s in near]
    moved[1][0][2, 0] += 0.3                  # 0.6 px from the golden box
    with pytest.raises(AssertionError, match="unmatched"):
        chip_smoke.check_detections(golden, moved, 0.5)
    dropped = [(b[1:], s[1:]) if i == 0 else (b, s) for i, (b, s) in enumerate(near)]
    with pytest.raises(AssertionError, match="unmatched"):
        chip_smoke.check_detections(golden, dropped, 0.5)
    assert len(chip_smoke.check_detections(golden, dropped, golden["pages"][0]["scores"][0])[3]) == 1
    regions = [[(tuple(r["box"]), r["latex"]) for r in g["regions"]] for g in golden["pages"]]
    compared, misses = chip_smoke.check_page_strings(golden, regions)
    assert compared == sum(len(g["regions"]) for g in golden["pages"]) and not misses
    regions[0][0] = (regions[0][0][0], "x")
    assert len(chip_smoke.check_page_strings(golden, regions)[1]) == 1
    regions[2][1] = (regions[2][1][0], "y")
    with pytest.raises(AssertionError, match="page strings"):
        chip_smoke.check_page_strings(golden, regions)


def test_chip_smoke_version_phase_runs_on_cpu(monkeypatch):
    """chip_smoke.version_phase on the CPU with a tiny coverage block in
    place of ``version1`` (no weights, CLAHE left on, random init): crops of
    two buckets decode, the B2 launch shapes are recorded, and the cut
    decode runs (here the CPU against itself)."""
    sys.path.insert(0, ROOT)
    import chip_smoke
    import doc2tex_tpu_torch.recognition as recognition
    from doc2tex_tpu_torch.config import make_config
    from doc2tex_tpu_torch.data.synthetic import HARD_VOCAB_PATH, synth_hard_sample
    from doc2tex_tpu_torch.models.vit import grid_size_for

    cfg = make_config(dict(
        max_dimension=[64, 256], min_dimension=[32, 32], batch_max_length=6,
        vocab=HARD_VOCAB_PATH, beam_size=10,
        FeatureExtraction={"name": "None"},
        SequenceModeling={"name": "ViT", "params": {
            "backbone": {"name": "resnet", "input_channel": 1, "output_channel": 32},
            "fix_embed": True, "patching_style": "2d", "patch_size": [2, 2],
            "depth": 1, "num_heads": 2, "hidden_size": 64}},
        Prediction={"name": "Attnv2", "params": {
            "seqmodel": "TFM", "input_size": 64, "hidden_size": 64, "kernel_size": 2,
            "kernel_dim": 32, "enc_init": True, "attn_type": "coverage"}},
    ))
    monkeypatch.setattr(recognition, "load_recog_config", lambda version: (cfg, None))
    monkeypatch.setattr(chip_smoke, "VERSION_CUT_STEPS", 4)
    crops = [synth_hard_sample(np.random.default_rng(s), min_len=3, max_len=12, max_h=64,
                               max_w=256)[0] for s in (0, 1)]
    launches, shapes = chip_smoke.version_phase(0.0, "version1", crops, device="cpu")
    assert launches == 0     # the CPU runs the plain version
    grids = [grid_size_for(b, (2, 2)) for b in ((64, 64), (64, 192))]
    assert sorted(shapes) == [(1, 10, gh * gw, 64, 64, 32) for gh, gw in grids]


def test_chip_smoke_zoo_phase_runs_on_cpu(monkeypatch):
    """chip_smoke.zoo_phase on the CPU with a tiny VGG + bahdanau block (no
    weights, CLAHE left on, random init): the float32 cut decode against
    its golden strings and first-crop logits (here the CPU's own), card ==
    CPU (the CPU against itself), and the block's full-length decode with
    the content form's launch shapes recorded."""
    sys.path.insert(0, ROOT)
    import chip_smoke
    import doc2tex_tpu_torch.recognition as recognition
    from doc2tex_tpu_torch.config import make_config
    from doc2tex_tpu_torch.data.synthetic import HARD_VOCAB_PATH, synth_hard_sample

    cfg = make_config(dict(
        max_dimension=[64, 256], min_dimension=[32, 32], batch_max_length=6,
        vocab=HARD_VOCAB_PATH, beam_size=10, dtype="bfloat16",
        FeatureExtraction={"name": "VGG", "params": {"input_channel": 1,
                                                     "output_channel": 64}},
        SequenceModeling={"name": "None"},
        Prediction={"name": "Attn", "params": {
            "seqmodel": "None", "input_size": 64, "hidden_size": 32, "enc_init": True,
            "attn_type": "bahdanau"}},
    ))
    monkeypatch.setattr(recognition, "load_recog_config",
                        lambda path=None, version=None: (dict(cfg), None))
    monkeypatch.setattr(chip_smoke, "VERSION_CUT_STEPS", 4)
    crops = [synth_hard_sample(np.random.default_rng(s), min_len=3, max_len=12, max_h=64,
                               max_w=256)[0] for s in (0, 1)]
    rec = chip_smoke.zoo_recognizer(chip_smoke.cut_config(cfg), "cpu")
    want = {"jax": rec(crops), "jax_logits": chip_smoke.zoo_logits(rec, crops[0]).tolist()}
    records = chip_smoke.zoo_phase(0.0, device="cpu", blocks=("tiny",),
                                   golden={"blocks": {"tiny": want}}, crops=crops)
    assert records == []     # the kernel records need the card


def test_chip_smoke_zoo_train_phase_runs_on_cpu(monkeypatch):
    """chip_smoke.zoo_train_phase on the CPU with a tiny VGG block, its
    bahdanau head and the same block with the coverage head at D 64 != H
    32 (leaves drawn from numpy, the reference's recipe): the float32 step
    against the CPU's own (the card's check, rehearsed), bf16 steps whose
    loss falls, and the launch counts and backward shapes recorded."""
    sys.path.insert(0, ROOT)
    import chip_smoke
    import doc2tex_tpu_torch.recognition as recognition
    from doc2tex_tpu_torch.config import make_config
    from doc2tex_tpu_torch.data.synthetic import HARD_VOCAB_PATH

    cfg = make_config(dict(
        max_dimension=[64, 256], min_dimension=[32, 32], batch_max_length=6,
        vocab=HARD_VOCAB_PATH, beam_size=10, dtype="bfloat16",
        FeatureExtraction={"name": "VGG", "params": {"input_channel": 1,
                                                     "output_channel": 64}},
        SequenceModeling={"name": "None"},
        Prediction={"name": "Attn", "params": {
            "seqmodel": "None", "input_size": 64, "hidden_size": 32, "enc_init": True,
            "kernel_size": 2, "kernel_dim": 8, "attn_type": "bahdanau", "droprate": 0.1}},
    ))
    monkeypatch.setattr(recognition, "load_recog_config",
                        lambda path=None, version=None: (dict(cfg), None))
    records = chip_smoke.zoo_train_phase(
        0.0, device="cpu", blocks=(("tiny", "bahdanau"), ("tiny", "coverage")), n=2,
        bucket=(64, 256), steps=3)
    assert records == []     # the kernel records need the card


def test_zoo_golden_names_the_yaml_blocks():
    """``tests/torch_port_golden_zoo.json`` holds JAX's float32 strings (8
    crops) and first-crop logits (ZOO_LOGIT_STEPS x the classes) for every
    block of ``tests/torch_port_zoo.yaml``, which loads through
    ``load_recog_config`` without weights."""
    sys.path.insert(0, ROOT)
    import chip_smoke
    from doc2tex_tpu_torch.config import load_yaml
    from doc2tex_tpu_torch.recognition import load_recog_config

    blocks = [k for k in load_yaml(chip_smoke.ZOO_CONFIG) if k != "common"]
    assert tuple(blocks) == chip_smoke.ZOO_BLOCKS
    golden = chip_smoke.zoo_golden()
    assert set(golden["blocks"]) == set(blocks)
    assert golden["batch_max_length"] == chip_smoke.VERSION_CUT_STEPS
    assert len(golden["crops"]["seeds"]) == chip_smoke.ZOO_N_CROPS
    for block in blocks:
        assert len(golden["blocks"][block]["jax"]) == chip_smoke.ZOO_N_CROPS
        logits = np.asarray(golden["blocks"][block]["jax_logits"])
        assert logits.shape[0] == chip_smoke.ZOO_LOGIT_STEPS and np.isfinite(logits).all()
        cfg, weights = load_recog_config(chip_smoke.ZOO_CONFIG, version=block)
        assert weights is None and cfg["max_dimension"] == [224, 960]


@pytest.mark.parametrize("block", ["zoo_cnn_tfm", "zoo_cnn_bilstm_attn", "zoo_vgg_bahdanau",
                                   "zoo_vit_gcb_learned"])
def test_zoo_golden_logits_match_port_cpu(block):
    """The port's CPU logits for the zoo phase's logit checks (the block at
    full width, numpy-drawn weights, the first golden crop, teacher-forced)
    lie within the phase's tolerances of JAX's golden logits: float32 within
    ZOO_LOGIT_TOL, far below the logits' spread, and the block's bfloat16
    within ZOO_BF16_LOGIT_TOL, which another crop's float32 logits exceed,
    so both checks on the card tell a wrong model path from a right one."""
    sys.path.insert(0, ROOT)
    import chip_smoke
    from doc2tex_tpu_torch.recognition import load_recog_config

    cfg, _ = load_recog_config(chip_smoke.ZOO_CONFIG, version=block)
    rec = chip_smoke.zoo_recognizer(chip_smoke.cut_config(cfg), "cpu")
    _, crops = chip_smoke.golden_crops("synthetic")
    ref = np.asarray(chip_smoke.zoo_golden()["blocks"][block]["jax_logits"], dtype=np.float32)
    got = chip_smoke.zoo_logits(rec, crops[0])
    assert got.shape == ref.shape == (chip_smoke.ZOO_LOGIT_STEPS, rec.converter.num_classes)
    err, tol, spread, _ = chip_smoke.logit_check(got, ref)
    assert err <= tol < spread / 100, (err, tol, spread)
    other, bf16_tol, _, _ = chip_smoke.logit_check(chip_smoke.zoo_logits(rec, crops[3]), ref,
                                                   chip_smoke.ZOO_BF16_LOGIT_TOL)
    assert cfg["dtype"] == "bfloat16" and other > bf16_tol, (other, bf16_tol)
    bf16 = chip_smoke.zoo_recognizer(dict(chip_smoke.cut_config(cfg), dtype="bfloat16"), "cpu")
    err, _, _, _ = chip_smoke.logit_check(chip_smoke.zoo_logits(bf16, crops[0]), ref)
    assert err <= bf16_tol / 2, (err, bf16_tol)


SERVE_YAML = """common:
  vocab: '{vocab}'
  clahe: False
tiny:
  max_dimension: [64, 256]
  min_dimension: [32, 32]
  batch_max_length: 8
  dtype: 'float32'
  bucket_growth: 2.2
  FeatureExtraction:
    name: 'None'
  SequenceModeling:
    name: 'ViT'
    params:
      backbone:
        name: 'resnet'
        input_channel: 1
        output_channel: 16
      fix_embed: True
      patching_style: '2d'
      patch_size: [2, 2]
      depth: 1
      num_heads: 1
      hidden_size: 16
  Prediction:
    name: 'TFM'
    params:
      d_model: 16
      nhead: 1
      num_decoder_layers: 1
      dim_feedforward: 16
  quantize: int8
"""


def test_serve_data_parallel_selftest_on_cpu(tmp_path):
    """``--data_parallel 2`` on the CPU: rank 0 serves, a follower process
    decodes its rows; every crop is answered, with the single process's
    strings (the selftest's digest of its answers), int8 as the block
    ships (the activation scale is the global batch's)."""
    cfg = tmp_path / "recog.yaml"
    from doc2tex_tpu_torch.data.synthetic import HARD_VOCAB_PATH

    cfg.write_text(SERVE_YAML.format(vocab=HARD_VOCAB_PATH))
    base = [sys.executable, "-m", "doc2tex_tpu_torch.api.serve", "--recog_config", str(cfg),
            "--model_version", "tiny", "--device", "cpu", "--selftest", "8", "--beam_size", "2"]
    outs = []
    for extra in ([], ["--data_parallel", "2"]):
        out = subprocess.run(base + extra, cwd=ROOT, env=_env(OMP_NUM_THREADS="1"),
                             capture_output=True, text=True, timeout=300)
        assert out.returncode == 0, out.stderr[-3000:]
        outs.append(json.loads(out.stdout.strip().splitlines()[-1]))
    single, sharded = outs
    assert sharded["data_parallel"] == 2 and "2 ranks over gloo" in out.stderr
    assert sharded["completed"] == single["completed"] == 8 and sharded["errors"] == 0
    assert sharded["answers_sha1"] == single["answers_sha1"]
