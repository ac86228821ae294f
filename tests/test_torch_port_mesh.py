"""The port's mesh (``doc2tex_tpu_torch/parallel/mesh.py``) on the CPU.

Ranks are spawned processes (gloo, a ``file://`` rendezvous in the test's
``tmp_path``, one torch thread each) that run ``tests/torch_port_mesh_ranks.py``
and never import jax (each rank asserts it).  Every group is joined under a
time limit of its own (``GROUP_LIMIT_S``) and its ranks are killed when it
expires or when one rank fails.

Held against the JAX package (the 8-virtual-device mesh that
``tests/test_parallel.py`` builds, in this process):

- ``_param_spec`` / ``param_shardings`` give JAX's specs on the same pytree
  (the tiny recognizer's flax parameters and that test's three leaves), and
  ``make_mesh``'s default and ``ValueError`` follow JAX's;
- the float32 strings of ``MathRecognition(mesh=make_mesh({"data": 2}))``
  (beam 2, numpy-drawn weights loaded into both packages) equal JAX's
  sharded strings on the crops of ``test_recognition_flow_over_mesh``,
  the single-crop path included (its batch of 1 rounded up to 2);
- the int8 strings with ``MIN_CONTRACT``/``MIN_OUT`` at 1 equal JAX's, as
  in ``test_int8_recognition_flow_over_mesh``;
- detection on that test's page with the released detector, device windows
  and host windows (``batch_size`` 2, rounded up to the data axis): boxes
  within 1e-3 px and scores within 1e-5 of JAX's (the tolerances of
  ``tests/test_torch_port_detect.py``);
- the int8 activation scale of every quantized layer: bit-equal across the
  two ranks of one call, and bit-equal to the port's one-process call's
  scales on the same (2-row) batch.

A follower of ``parallel.mesh.lead`` ends itself within a few seconds
of rank 0's process being killed.

Training over the mesh, ``api.infer`` over two ranks and the cross-mesh
resume are in ``tests/test_torch_port_mesh_train.py`` (a file of its own,
so that two test workers share the load).
"""

from __future__ import annotations

import multiprocessing
import os
import signal
import time

import jax
import numpy as np
import pytest
import torch

import torch_port_mesh_ranks as ranks
from doc2tex_tpu_torch.parallel import mesh as meshlib
from torch_port_threads import one_torch_thread  # noqa: F401

GROUP_LIMIT_S = 180
BOX_ATOL, SCORE_ATOL = 1e-3, 1e-5


def spawn(fn, n, args, tmp_path, tag):
    return meshlib.spawn(fn, ["cpu"] * n, args, time_limit=GROUP_LIMIT_S, threads=1,
                         init_method="file://" + str(tmp_path / f"{tag}.rendezvous"))


def _jax_mesh(shape):
    from doc2tex_tpu.parallel import make_mesh

    return make_mesh(shape)


# ---- the mesh and the placement rules -----------------------------------

def test_make_mesh_and_param_spec_match_jax():
    from doc2tex_tpu.parallel import mesh as jmesh
    from test_recognition_extras import tiny_recog_config

    mesh = meshlib.make_mesh()
    assert mesh.shape == {"data": 1, "model": 1} and mesh.size == 1
    with pytest.raises(ValueError, match="!= 1 devices"):
        meshlib.make_mesh({"data": 2, "model": 1})
    with pytest.raises(ValueError):
        jmesh.make_mesh({"data": 3, "model": 2})
    assert tuple(jmesh.batch_sharding(_jax_mesh({"data": 8})).spec) == \
        meshlib.batch_sharding(mesh).spec
    assert tuple(jmesh.replicated_sharding(_jax_mesh({"data": 8})).spec) == \
        meshlib.replicated_sharding(mesh).spec
    x = torch.zeros(8, 16, 32)
    assert meshlib.shard_activation(x, ("data", None, "model")) is x

    params = ranks.variables_for(tiny_recog_config(), 0)["params"]
    trees = [params, {"big": np.zeros((512, 512)), "small": np.zeros((4, 4)),
                      "bias": np.zeros((512,)), "rows": np.zeros((1024, 3))}]
    flat = []
    for tree in trees:
        jax.tree_util.tree_map_with_path(lambda path, p: flat.append(p), tree)
    for n_model in (2, 4):
        for min_size in (2**10, 2**16):
            n_sharded = 0
            for p in flat:
                want = jmesh._param_spec("", p, n_model, min_size)
                got = meshlib._param_spec("", p, n_model, min_size)
                assert got == tuple(want), (p.shape, n_model, min_size)
                n_sharded += bool(got)
            assert n_sharded > 0
    jm = _jax_mesh({"data": 4, "model": 2})
    want = jmesh.param_shardings(trees[1], jm, min_size=2**10)
    got = meshlib.param_shardings(trees[1], meshlib.Mesh(1, 2, 0, "cpu", None, {}), 2**10)
    assert {k: tuple(v.spec) for k, v in want.items()} == {k: v.spec for k, v in got.items()}
    assert got["big"].spec[-1] == "model" and got["rows"].spec == ("model", None)
    # each model rank's share under those specs: columns, else rows, else whole
    tree = {k: np.arange(v.size, dtype=np.float32).reshape(v.shape) for k, v in trees[1].items()}
    local = meshlib.shard_params(tree, meshlib.Mesh(1, 2, 1, "cpu", None, {}), 2**10)
    np.testing.assert_array_equal(local["big"], tree["big"][:, 256:])
    np.testing.assert_array_equal(local["rows"], tree["rows"][512:])
    assert local["small"] is tree["small"] and local["bias"] is tree["bias"]


# ---- single-controller inference -----------------------------------------

def _crops():
    rng = np.random.default_rng(7)
    return [rng.integers(0, 255, (h, w), dtype=np.uint8) for h, w in [(40, 100), (33, 60), (48, 120)]]


def _int8_crop():
    crop = np.full((40, 90), 255, np.uint8)
    crop[10:30, 10:80] = 0
    return crop


def _page():
    page = np.full((600, 700), 255, np.uint8)
    page[100:160, 50:400] = 0
    page[320:380, 200:500] = 0
    return page


DET_KW = dict(conf_thresh=0.01, stride=(512, 512))


@pytest.fixture(scope="module")
def inference(tmp_path_factory):
    """(the two ranks' results, the recognizer config, its variables)."""
    from doc2tex_tpu_torch.detection.flow import SHIPPED_WEIGHTS
    from test_recognition_extras import tiny_recog_config

    cfg = dict(tiny_recog_config())
    variables = ranks.variables_for(cfg, 0)
    out = spawn(ranks.inference_rank, 2, (cfg, variables, _crops(), _int8_crop(),
                                          SHIPPED_WEIGHTS, _page(), DET_KW),
                tmp_path_factory.mktemp("inference"), "inference")
    return out, cfg, variables


def _jax_recognizer(variables, **kw):
    from doc2tex_tpu.recognition import MathRecognition as JaxRecognition
    from test_recognition_extras import tiny_recog_config

    cfg = tiny_recog_config()
    cfg.update(kw.pop("config", {}))
    rec = JaxRecognition(config=cfg, mesh=_jax_mesh({"data": 8, "model": 1}), **kw)
    rec.variables = jax.tree_util.tree_map(np.asarray, variables)
    return rec


def test_sharded_recognition_equals_jax(inference):
    out, _, variables = inference
    jrec = _jax_recognizer(variables, beam_size=2)
    crops = _crops()
    assert out[0]["strings"] == jrec(crops)
    assert out[0]["single"] == jrec(crops[0])


def test_sharded_int8_strings_equal_jax_and_scales_are_global(inference, monkeypatch):
    import doc2tex_tpu.ops.quant as jquant
    from doc2tex_tpu_torch.ops import quant

    out, cfg, variables = inference
    monkeypatch.setattr(jquant, "MIN_CONTRACT", 1)
    monkeypatch.setattr(jquant, "MIN_OUT", 1)
    jrec = _jax_recognizer(variables, config={"quantize": "int8"})
    assert jrec.quant_parts == ("encoder",)
    assert out[0]["int8"] == jrec(_int8_crop())

    # the scales: bit-equal across the ranks of the call, and equal to the
    # one-process call's on the same 2-row batch (row 0 repeated)
    s0, s1 = out[0]["scales"], out[1]["scales"]
    assert len(s0) > 20 and s0 == s1
    monkeypatch.setattr(quant, "MIN_CONTRACT", 1)
    monkeypatch.setattr(quant, "MIN_OUT", 1)
    _, rec8 = ranks.recognizers(cfg, variables)
    prepped = [rec8._preprocess(_int8_crop())]
    bucket = rec8.table.lookup(*prepped[0].shape[:2])
    with quant.recorded_scales() as single:
        rec8._decode(rec8.make_batch(prepped, bucket, 2))
    assert single == s0


def test_sharded_detection_equals_jax(inference):
    from doc2tex_tpu_torch.detection.flow import SHIPPED_WEIGHTS
    from test_torch_port_detect_train import _jax_detector

    out = inference[0][0]
    assert out["batch_size"] == 2
    jdet = _jax_detector(SHIPPED_WEIGHTS, batch_size=2, mesh=_jax_mesh({"data": 8, "model": 1}),
                         **DET_KW)
    assert jdet.batch_size == 8
    for key, device_windows in (("device_windows", True), ("host_windows", False)):
        jdet.device_windows = device_windows
        jb, js = jdet.detect_page(_page())
        tb, ts = out[key]
        assert len(tb) >= 1 and tb.shape == jb.shape, key
        np.testing.assert_allclose(tb, jb, atol=BOX_ATOL, rtol=0, err_msg=key)
        np.testing.assert_allclose(ts, js, atol=SCORE_ATOL, rtol=0, err_msg=key)




# ---- a follower outlives no rank 0 ----------------------------------------

def _gone(pid: int) -> bool:
    """The process has ended (exited, or a zombie nobody reaps yet)."""
    try:
        with open(f"/proc/{pid}/stat") as f:
            return f.read().rsplit(") ", 1)[1][0] in "ZX"
    except (FileNotFoundError, ProcessLookupError):
        return True


def test_follower_ends_when_rank_0_is_killed(tmp_path):
    """Rank 0 of ``lead`` killed with SIGKILL (no shutdown, no closed
    collective: its follower sleeps outside any): the follower sees its
    parent gone and exits within PARENT_POLL_S and a few seconds more."""
    pid_path = str(tmp_path / "follower.pid")
    rank0 = multiprocessing.get_context("spawn").Process(target=ranks.lead_then_hang,
                                                         args=(pid_path,))
    rank0.start()
    follower = None
    try:
        deadline = time.monotonic() + GROUP_LIMIT_S
        while not os.path.exists(pid_path):
            assert rank0.is_alive() and time.monotonic() < deadline, "lead did not start"
            time.sleep(0.1)
        with open(pid_path) as f:
            follower = int(f.read())
        time.sleep(2 * meshlib.PARENT_POLL_S)
        assert not _gone(follower)
        os.kill(rank0.pid, signal.SIGKILL)
        rank0.join(10)
        deadline = time.monotonic() + 10 * meshlib.PARENT_POLL_S + 5
        while not _gone(follower) and time.monotonic() < deadline:
            time.sleep(0.1)
        assert _gone(follower), "the follower outlived rank 0"
    finally:
        if rank0.is_alive():
            rank0.kill()
        if follower is not None and not _gone(follower):
            os.kill(follower, signal.SIGKILL)
