"""The port's eval CLI (``doc2tex_tpu_torch.api.infer``) against the JAX
package's ``api/infer.py``.

- On the manifest of ``tests/test_infer_cli.py`` (10 flat synthetic crops
  saved as PNGs by PIL, a TSV manifest) with that file's ``small_config``
  (the coverage-LSTM head), greedy, float32, both CLIs' ``main`` reading
  one checkpoint of numpy draws for every leaf: the same images from
  ``load_csv_dataset``, the same ``predictions.csv`` rows and the same
  metric lines.
- Each refusal raises by name: ``--resizer`` (A6), ``--int8-full`` and
  ``quantize: int8_full`` (A5), an LMDB ``eval_data`` folder (A11),
  ``--platform``; a missing ``saved_model`` or vocabulary raises as JAX's
  CLI does.
- ``tests/torch_port_golden_infer.json`` (the JAX CLI's predictions over the
  ``synthetic_long`` golden crops, which ``chip_smoke.py``'s infer phase
  holds the card to) names those crops and their labels, and the PNG
  manifest round-trips their bytes.

The golden is written once by the JAX package on the CPU:
``PYTHONPATH=. python tests/test_torch_port_infer.py --write-golden``.
The file imports JAX only inside its tests, and holds torch to one thread.
"""

from __future__ import annotations

import csv
import json
import os
import sys

import numpy as np
import pytest
import torch

from doc2tex_tpu_torch.api import infer
from doc2tex_tpu_torch.config import load_config
from doc2tex_tpu_torch.data.synthetic import SYNTH_VOCAB, synth_dataset
from doc2tex_tpu_torch.transforms.preprocess import resize_for_inference

HERE = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(HERE)
sys.path.insert(0, HERE)
sys.path.insert(0, ROOT)
import chip_smoke  # noqa: E402  (the manifest writer and the infer phase's files)

METRIC_LINES = ("samples:", "exact match:", "BLEU-4:", "char NED match:", "word NED match:")


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def manifest(tmp_path_factory):
    """tests/test_infer_cli.py's manifest: 10 flat crops of seed 9 saved by
    PIL, a TSV manifest without a header."""
    from PIL import Image

    root = tmp_path_factory.mktemp("infer")
    img_dir = root / "imgs"
    img_dir.mkdir()
    images, labels = synth_dataset(10, seed=9, max_len=10, max_h=56)
    csv_path = root / "labels.tsv"
    with open(csv_path, "w", newline="") as f:
        w = csv.writer(f, delimiter="\t")
        for i, (img, label) in enumerate(zip(images, labels)):
            name = f"img{i:03d}.png"
            Image.fromarray(img).save(img_dir / name)
            w.writerow([name, label])
    return str(csv_path), str(img_dir), images


@pytest.fixture(scope="module")
def small(tmp_path_factory):
    """(config path, checkpoint path): test_loader_engine's small_config
    (greedy, float32) as a flat YAML, and a checkpoint of numpy draws for
    every leaf of its JAX model."""
    import jax
    import jax.numpy as jnp
    from flax import serialization

    jax.config.update("jax_platforms", "cpu")
    from doc2tex_tpu.models import build_model as jax_build_model
    from doc2tex_tpu.tokenizer.converters import create_converter as jax_converter
    from test_loader_engine import small_config
    from test_torch_port_model import _random_variables

    root = tmp_path_factory.mktemp("small")
    cfg = small_config(downsample=1)
    # a coarse ladder: 10 crops in fewer buckets, so JAX compiles fewer decodes
    cfg.update(beam_size=1, dtype="float32", bucket_growth=4.0)
    vocab = root / "vocab.txt"
    vocab.write_text("".join(t + "\n" for t in SYNTH_VOCAB))
    model = jax_build_model(cfg, jax_converter(dict(cfg)).num_classes)
    shapes = jax.eval_shape(lambda: model.init(
        jax.random.PRNGKey(0), jnp.zeros((1, 32, 32, 1)),
        jnp.zeros((1, cfg["batch_max_length"] + 1), jnp.int32), train=False))
    ckpt = root / "init.msgpack"
    ckpt.write_bytes(serialization.msgpack_serialize(
        _random_variables(dict(shapes), np.random.default_rng(3))))
    # the vocabulary from a file, and no synthetic data: the CLI reads only the manifest
    flat = {k: v for k, v in dict(cfg).items()
            if k not in ("num_class", "synthetic_data", "synthetic_kwargs")}
    flat.update(character=[], vocab=str(vocab), saved_model=str(ckpt))
    path = root / "small.yaml"
    path.write_text(_yaml(flat))
    return str(path), str(ckpt)


def _yaml(tree: dict, indent: int = 0) -> str:
    """A config as block mappings with flow lists of scalars, which both
    packages' YAML readers take."""
    def scalar(v):
        return "null" if v is None else f"'{v}'" if isinstance(v, str) else str(v)

    out = []
    for k, v in tree.items():
        if isinstance(v, dict):
            out.append(" " * indent + f"{k}:\n" + _yaml(v, indent + 2))
        elif isinstance(v, (list, tuple)):
            out.append(" " * indent + f"{k}: [{', '.join(scalar(x) for x in v)}]\n")
        else:
            out.append(" " * indent + f"{k}: {scalar(v)}\n")
    return "".join(out)


def _jax_main(argv, capsys):
    import api.infer as jax_infer

    old = sys.argv
    sys.argv = ["infer.py"] + argv
    try:
        jax_infer.main()
    finally:
        sys.argv = old
    return capsys.readouterr().out


def _metric_lines(out: str) -> list[str]:
    return [ln for ln in out.splitlines() if ln.startswith(METRIC_LINES)]


def test_load_csv_dataset_equals_jax(manifest, small):
    import api.infer as jax_infer
    from doc2tex_tpu.config import load_config as jax_load_config

    csv_path, img_dir, images = manifest
    ours = infer.load_csv_dataset(csv_path, img_dir, load_config(small[0]))
    theirs = jax_infer.load_csv_dataset(csv_path, img_dir, jax_load_config(small[0]))
    assert len(ours) == len(theirs) == 10
    for i in range(10):
        np.testing.assert_array_equal(ours.image(i), theirs.image(i))
        assert ours.label(i) == theirs.label(i) and ours.name(i) == theirs.name(i)
    np.testing.assert_array_equal(ours.image(0), resize_for_inference(images[0],
                                                                      load_config(small[0])))


def test_main_equals_jax_cli(manifest, small, tmp_path, capsys):
    """Both CLIs over the manifest with the same checkpoint, greedy, on
    the CPU: equal predictions.csv rows and metric lines."""
    csv_path, img_dir, _ = manifest
    args = ["--config", small[0], "--csv_dir", csv_path, "--data_dir", img_dir]
    jax_out = _jax_main(args + ["--log_path", str(tmp_path / "jax")], capsys)
    infer.main(args + ["--log_path", str(tmp_path / "port"), "--device", "cpu"])
    port_out = capsys.readouterr().out
    assert _metric_lines(port_out) == _metric_lines(jax_out)
    assert len(_metric_lines(port_out)) == len(METRIC_LINES)
    for label in ("images/sec:", "avg time/image:", "avg infer:", "avg postproc:",
                  "peak mem:"):
        assert label in port_out
    rows = {}
    for side in ("jax", "port"):
        with open(tmp_path / side / "predictions.csv", newline="") as f:
            rows[side] = list(csv.reader(f))
        with open(tmp_path / side / "metrics.json") as f:
            rows[side + "_metrics"] = json.load(f)
    assert rows["port"] == rows["jax"] and len(rows["port"]) == 11
    for key in ("accuracy", "bleu", "ED", "word_ED", "n_samples", "params_M"):
        assert rows["port_metrics"][key] == pytest.approx(rows["jax_metrics"][key], abs=1e-9)


@pytest.mark.parametrize("flag,item", [("--resizer", "A6"), ("--int8-full", "A5"),
                                       ("--platform", "platform")])
def test_refusals_raise_by_name(manifest, small, flag, item):
    csv_path, img_dir, _ = manifest
    argv = ["--config", small[0], "--csv_dir", csv_path, "--data_dir", img_dir,
            "--device", "cpu", flag] + (["cpu"] if flag == "--platform" else [])
    with pytest.raises(NotImplementedError, match=item):
        infer.main(argv)


def test_config_refusals_raise_by_name(manifest, small, tmp_path):
    csv_path, img_dir, _ = manifest
    cfg = load_config(small[0])
    dataset = infer.load_csv_dataset(csv_path, img_dir, cfg)
    with pytest.raises(NotImplementedError, match="A5"):
        infer.run_infer(dict(cfg, quantize="int8_full"), dataset, device="cpu")
    lmdb = tmp_path / "eval_lmdb"
    lmdb.mkdir()
    path = tmp_path / "lmdb.yaml"
    path.write_text(open(small[0]).read() + f"eval_data: {lmdb}\n")
    with pytest.raises(NotImplementedError, match="A11"):
        infer.main(["--config", str(path), "--device", "cpu"])
    with pytest.raises(SystemExit):    # no data at all: argparse's error, as JAX's CLI
        infer.main(["--config", small[0], "--device", "cpu"])


def test_missing_paths_raise_as_jax(manifest, small):
    """config/test.yaml names a vocabulary and a saved_model that are not
    in the repository: both CLIs raise FileNotFoundError for each."""
    import api.infer as jax_infer
    from doc2tex_tpu.config import load_config as jax_load_config

    from doc2tex_tpu.train.checkpoint import load_pretrained_variables as jax_load_weights

    csv_path, img_dir, _ = manifest
    missing = "saved_models/train/best_accuracy.msgpack"
    for load, run, kw in ((jax_load_config, jax_infer.run_infer, {}),
                          (load_config, infer.run_infer, {"device": "cpu"})):
        cfg = dict(load(small[0]), vocab="data/vocab.txt")
        dataset = infer.load_csv_dataset(csv_path, img_dir, cfg)
        with pytest.raises(FileNotFoundError):
            run(cfg, dataset, **kw)
    # JAX's CLI reads saved_model with this function, after an init that
    # takes the test seconds of compiling
    with pytest.raises(FileNotFoundError):
        jax_load_weights(missing, {}, {})
    cfg = dict(load_config(small[0]), saved_model=missing)
    with pytest.raises(FileNotFoundError):
        infer.run_infer(cfg, infer.load_csv_dataset(csv_path, img_dir, cfg), device="cpu")


def test_infer_golden_holds_the_long_golden_crops(tmp_path):
    """The infer golden's rows are the long golden crops by name and label;
    the manifest writer's PNGs read back to their bytes, and the flat config
    is the ``synthetic_long`` block in float32 without quantize."""
    with open(chip_smoke.GOLDEN_INFER) as f:
        golden = json.load(f)
    manifest, long = chip_smoke.infer_manifest(str(tmp_path))
    assert [r["name"] for r in golden["rows"]] == [
        f"long_{c['seed']:05d}.png" for c in long["crops"]]
    assert [r["label"] for r in golden["rows"]] == [c["label"] for c in long["crops"]]
    assert golden["metrics"]["n_samples"] == 16 and golden["beam_size"] == 10
    _, crops = chip_smoke.golden_crops("synthetic_long")
    cfg = load_config(chip_smoke.INFER_CONFIG)
    dataset = infer.load_csv_dataset(manifest, str(tmp_path), cfg)
    assert len(dataset) == 16
    for i, crop in enumerate(crops):
        np.testing.assert_array_equal(dataset.image(i), resize_for_inference(crop, cfg))
    assert cfg["dtype"] == "float32" and not cfg.get("quantize") and cfg["beam_size"] == 10
    assert cfg["max_dimension"] == [448, 960] and cfg["batch_max_length"] == 500


def write_golden() -> None:
    """The JAX package's CLI (``api/infer.py``, CPU) over the long golden
    crops written by ``chip_smoke.infer_manifest``, with
    ``chip_smoke.INFER_CONFIG`` and the CLI's default batch size: its
    predictions.csv rows and metrics to ``chip_smoke.GOLDEN_INFER``.  Run
    from the repository root.  Not part of the tests."""
    import tempfile

    import jax

    jax.config.update("jax_platforms", "cpu")
    jax.config.update("jax_default_matmul_precision", "float32")
    import api.infer as jax_infer
    from doc2tex_tpu.config import load_config as jax_load_config

    with tempfile.TemporaryDirectory() as tmp:
        manifest, _ = chip_smoke.infer_manifest(tmp)
        cfg = jax_load_config(os.path.relpath(chip_smoke.INFER_CONFIG, ROOT))
        cfg["batch_size"] = 32
        dataset = jax_infer.load_csv_dataset(manifest, tmp, cfg)
        result = jax_infer.run_infer(cfg, dataset, os.path.join(tmp, "out"))
        with open(os.path.join(tmp, "out", "predictions.csv"), newline="") as f:
            rows = list(csv.DictReader(f))
    golden = {
        "config": os.path.relpath(chip_smoke.INFER_CONFIG, ROOT), "batch_size": 32,
        "beam_size": cfg["beam_size"], "dtype": cfg["dtype"],
        "metrics": {k: result[k] for k in ("accuracy", "bleu", "ED", "word_ED", "n_samples")},
        "rows": rows,
    }
    with open(chip_smoke.GOLDEN_INFER, "w") as f:
        json.dump(golden, f, indent=1, ensure_ascii=False)
        f.write("\n")


if __name__ == "__main__":
    if sys.argv[1:] != ["--write-golden"]:
        sys.exit("usage: PYTHONPATH=. python tests/test_torch_port_infer.py --write-golden")
    write_golden()
