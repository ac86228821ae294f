"""The coverage form of the attention step (B2), checked on the CPU.

- ``coverage_attention_step_reference`` (the location conv, the memory at
  sample rows repeated per beam, then the step) against the JAX package:
  ``jax.lax.conv_general_dilated`` as ``doc2tex_tpu/models/decoder_lstm.py``
  runs it, then JAX's ``attention_step_reference`` on the memory repeated K
  times.  K {1, 5}, 2 samples, S {7, 40}, kernel_size 2, float32 and
  bfloat16 memory, valid_len {None, S - 3}, coverage as a decode makes it
  (sums of softmax rows).  Tolerance 1e-5 abs (float32 sums of the same
  terms in another order).  The conv reads the coverage past valid_len: a
  case whose coverage is nonzero only there moves the scores.
- The wrapper runs the plain version on CPU tensors and raises on shapes
  that do not fit: rows of q that are not a multiple of the samples, a
  coverage of the wrong shape, an even conv.
- ``launch_plan``: over the shapes the shipped LSTM configs launch, every
  plan covers S once with at most 8 blocks a cluster, at most 16 beams a
  block, within 227 KB; at the slice's 8 samples and 1 sample it spreads
  over 64 blocks or more.  It raises on what the kernel does not take.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from doc2tex_tpu.ops.attention_step import attention_step_reference as jax_step_reference
from doc2tex_tpu_torch.ops.attention_step import (
    CONTENT, COVERAGE, FEATURE, FULL, FULL_LIMIT, MAX_BEAM, MAX_CLUSTER, SMEM_LIMIT, STAGES, TILES,
    coverage_attention_step, coverage_attention_step_reference, launch_plan, smem_bytes)
from doc2tex_tpu_torch.tools.bench_attention_step import SHAPES as BENCH_SHAPES
from torch_port_threads import one_torch_thread  # noqa: F401

KS = 2  # kernel_size of every shipped config


def _inputs(K, S, dtype, Bs=2, D=64, Kl=16, steps=3, seed=0):
    """numpy inputs of the coverage form; the memory rounded to bfloat16
    when ``dtype`` is, so both packages see the same values.  The coverage
    is the sum of ``steps`` softmax rows, as a decode makes it."""
    rng = np.random.default_rng(seed)

    def normal(*shape, scale=1.0):
        return (rng.normal(size=shape) * scale).astype(np.float32)

    enc, enc_proj = normal(Bs, S, D), normal(Bs, S, D, scale=1.5)
    if dtype == "bfloat16":
        enc, enc_proj = (torch.from_numpy(x).bfloat16().float().numpy() for x in (enc, enc_proj))
    logits = normal(steps, Bs * K, S, scale=3.0)
    e = np.exp(logits - logits.max(-1, keepdims=True))
    mem = (e / e.sum(-1, keepdims=True)).sum(0).astype(np.float32)
    return dict(enc=enc, enc_proj=enc_proj, q=normal(Bs * K, D, scale=1.5), mem=mem,
                loc_conv_w=normal(2 * KS + 1, 1, Kl, scale=0.5), loc_conv_b=normal(Kl, scale=0.1),
                w_loc=normal(Kl, D, scale=0.35), b_loc=normal(D, scale=0.17),
                w_score=normal(D, 1, scale=0.4))


def _jax(kw, K, dtype, valid_len):
    """The JAX package's decoder step math: the location conv as
    ``LSTMAttentionDecoder.step`` runs it, then ``attention_step_reference``
    on the memory repeated K times (``init_state``'s ``jnp.repeat``)."""
    jdt = jnp.bfloat16 if dtype == "bfloat16" else jnp.float32
    j = {k: jnp.asarray(v) for k, v in kw.items()}
    loc = jax.lax.conv_general_dilated(
        j["mem"][..., None], j["loc_conv_w"], window_strides=(1,), padding=[(KS, KS)],
        dimension_numbers=("NWC", "WIO", "NWC")) + j["loc_conv_b"]
    enc = jnp.repeat(j["enc"].astype(jdt), K, axis=0)
    enc_proj = jnp.repeat(j["enc_proj"].astype(jdt), K, axis=0)
    ctx, alpha = jax_step_reference(enc, enc_proj, j["q"], loc, j["w_loc"], j["b_loc"],
                                    j["w_score"], valid_len=valid_len)
    return np.asarray(ctx), np.asarray(alpha)


def _torch(kw, dtype):
    tdt = torch.bfloat16 if dtype == "bfloat16" else torch.float32
    t = {k: torch.from_numpy(v) for k, v in kw.items()}
    t["enc"], t["enc_proj"] = t["enc"].to(tdt), t["enc_proj"].to(tdt)
    return t


@pytest.mark.parametrize("valid", [None, "S-3"])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("S", [7, 40])
@pytest.mark.parametrize("K", [1, 5])
def test_coverage_step_plain_version_matches_jax(K, S, dtype, valid):
    valid_len = None if valid is None else S - 3
    kw = _inputs(K, S, dtype, seed=K * 100 + S)
    ctx, alpha = coverage_attention_step_reference(**_torch(kw, dtype), valid_len=valid_len)
    want_ctx, want_alpha = _jax(kw, K, dtype, valid_len)
    assert ctx.shape == (2 * K, 64) and alpha.shape == (2 * K, S)
    np.testing.assert_allclose(ctx.numpy(), want_ctx, atol=1e-5, rtol=0)
    np.testing.assert_allclose(alpha.numpy(), want_alpha, atol=1e-5, rtol=0)
    if valid_len is not None:
        assert alpha[:, valid_len:].max().item() == 0.0


def test_coverage_past_valid_len_is_read():
    """The conv reads the coverage at every position: coverage that is
    nonzero only at or past valid_len moves the scores of the last valid
    positions (it is in their window), the same way in both packages."""
    K, S, valid_len = 5, 40, 31
    kw = _inputs(K, S, "float32", seed=3)
    kw["mem"][:, :valid_len] = 0.0
    kw["mem"][:, valid_len:] = 2.0
    ctx, alpha = coverage_attention_step_reference(**_torch(kw, "float32"), valid_len=valid_len)
    want_ctx, want_alpha = _jax(kw, K, "float32", valid_len)
    np.testing.assert_allclose(ctx.numpy(), want_ctx, atol=1e-5, rtol=0)
    np.testing.assert_allclose(alpha.numpy(), want_alpha, atol=1e-5, rtol=0)
    cut = dict(kw, mem=np.zeros_like(kw["mem"]))
    _, alpha_cut = coverage_attention_step_reference(**_torch(cut, "float32"),
                                                     valid_len=valid_len)
    moved = (alpha - alpha_cut).abs().amax(dim=0)
    assert moved[valid_len - KS:valid_len].min().item() > 1e-4   # windows reach past valid_len
    assert moved[valid_len:].max().item() == 0.0


def test_coverage_step_wrapper_runs_plain_version_on_cpu():
    kw = _torch(_inputs(5, 40, "bfloat16"), "bfloat16")
    before = coverage_attention_step.launches
    got = coverage_attention_step(**kw, valid_len=33)
    assert coverage_attention_step.launches == before
    want = coverage_attention_step_reference(**kw, valid_len=33)
    assert all(torch.equal(a, b) for a, b in zip(got, want))


def test_coverage_step_wrapper_rejects_bad_shapes():
    kw = _torch(_inputs(5, 9, "float32"), "float32")
    with pytest.raises(ValueError, match="samples times the beams"):
        coverage_attention_step(**dict(kw, q=kw["q"][:9]))
    with pytest.raises(ValueError, match="mem must be"):
        coverage_attention_step(**dict(kw, mem=kw["mem"][:, :8]))
    with pytest.raises(ValueError, match="odd k"):
        coverage_attention_step(**dict(kw, loc_conv_w=kw["loc_conv_w"][:4]))
    with pytest.raises(ValueError, match="w_loc"):
        coverage_attention_step(**dict(kw, w_loc=kw["w_loc"][:, :3]))


# the (samples, K, S) the shipped coverage-LSTM configs launch: batches
# snapped to 1, 8 and 64 samples, greedy and beams 5 and 10, S from the
# smallest bucket's patch grid to version1's 800x800 bucket
SHIPPED = [(Bs, K, S) for Bs in (1, 8, 64) for K in (1, 5, 10)
           for S in (83, 135, 225, 267, 445, 623, 2525)]
WIDTHS = ((128, 64), (256, 128))  # (D = H, Kl): synthetic, and the common width


@pytest.mark.parametrize("form", [COVERAGE, FEATURE])
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("D,Kl", WIDTHS)
def test_launch_plan_covers_s_once_within_shared_memory(D, Kl, dtype, form):
    for Bs, K, S in SHIPPED:
        if form == FEATURE:
            Bs, K = Bs * K, 1  # the TPU kernel's contract: the memory at the rows of q
        plan = launch_plan(Bs, K, S, D, D, Kl, dtype, form)
        Kz = K // plan.zsplit
        assert K % plan.zsplit == 0 and 1 <= Kz <= MAX_BEAM, plan
        assert 1 <= plan.cluster <= MAX_CLUSTER and plan.chunk % 8 == 0, plan
        # block r owns [r * chunk, min(S, (r + 1) * chunk)): S once, none empty
        assert (plan.cluster - 1) * plan.chunk < S <= plan.cluster * plan.chunk, plan
        assert plan.tile in TILES and 2 <= plan.stages <= 8, plan
        assert plan.smem_bytes == smem_bytes(form, Kz, plan.chunk, plan.tile, plan.stages, D, Kl,
                                             dtype.itemsize) <= SMEM_LIMIT, plan


@pytest.mark.parametrize("Bs,K,S", BENCH_SHAPES[:-1])
def test_launch_plan_spreads_the_slice_over_the_card(Bs, K, S):
    """The synthetic slice's launches (8 samples or 1, beam 10) take 64
    blocks or more; the release shape's 64 samples keep the cluster
    small."""
    plan = launch_plan(Bs, K, S, 128, 128, 64, torch.bfloat16)
    assert Bs * plan.zsplit * plan.cluster >= 64, plan
    release = launch_plan(64, 10, 623, 128, 128, 64, torch.bfloat16)
    assert release.cluster <= 2, release


def test_launch_plan_raises_on_what_the_kernel_does_not_take():
    plan = launch_plan  # every argument but the one named is a shipped shape
    with pytest.raises(ValueError, match="kernel takes D in"):
        plan(8, 10, 445, 64, 64, 16, torch.bfloat16)
    with pytest.raises(ValueError, match="kernel takes D in"):
        plan(8, 10, 445, 1024, 256, 64, torch.bfloat16)
    with pytest.raises(ValueError, match="0 in the content form"):
        plan(8, 10, 239, 512, 256, 64, torch.bfloat16, CONTENT)
    # D != H within the TPU kernel's contract (D 512 on a CNN map, H 256)
    assert plan(8, 10, 445, 128, 256, 64, torch.bfloat16).smem_bytes <= SMEM_LIMIT
    assert plan(8, 10, 239, 512, 256, 0, torch.bfloat16, CONTENT).smem_bytes <= SMEM_LIMIT
    with pytest.raises(ValueError, match="taps"):
        plan(8, 10, 445, 128, 128, 64, torch.bfloat16, COVERAGE, 7)
    with pytest.raises(ValueError, match="multiple of 4"):
        plan(8, 1, 445, 128, 128, 30, torch.float32, FEATURE)
    with pytest.raises(TypeError, match="float32/bfloat16"):
        plan(8, 10, 445, 128, 128, 64, torch.float16)
    with pytest.raises(ValueError, match="does not fit"):
        plan(1, 16, 2_000_000, 128, 128, 64, torch.float32)
    # the feature form's widest instance fits: w_loc alone takes 128 KB
    wide = plan(1, 1, 2525, 256, 256, 128, torch.float32, FEATURE)
    assert wide.smem_bytes <= SMEM_LIMIT and wide.tile == 16, wide


# the rows with plan models of their own: (form, memory type, (D, H, Kl))
OWN_ROWS = [(CONTENT, torch.bfloat16, (512, 256, 0)), (CONTENT, torch.float32, (512, 256, 0)),
            (CONTENT, torch.int8, (512, 256, 0)), (COVERAGE, torch.int8, (128, 128, 64)),
            (COVERAGE, torch.int8, (256, 256, 128)), (CONTENT, torch.int8, (128, 128, 0))]


@pytest.mark.parametrize("form,dtype,widths", OWN_ROWS)
def test_launch_plan_of_the_content_and_int8_rows(form, dtype, widths):
    """The content form's and the int8 form's plans over the shipped and
    zoo shapes cover S once with at most 8 blocks a cluster and 16 beams a
    block, within 227 KB; a whole-chunk plan (stages FULL) leaves room for
    two blocks an SM and its layout is the kernel's; a ring holds STAGES
    tiles."""
    D, H, Kl = widths
    for Bs, K, S in SHIPPED + [(1, 10, S) for S in (47, 63, 95, 143, 207)] + [(8, 1, 207)]:
        plan = launch_plan(Bs, K, S, D, H, Kl, dtype, form)
        Kz = K // plan.zsplit
        assert K % plan.zsplit == 0 and 1 <= Kz <= MAX_BEAM, plan
        assert 1 <= plan.cluster <= MAX_CLUSTER and plan.chunk % 8 == 0, plan
        assert (plan.cluster - 1) * plan.chunk < S <= plan.cluster * plan.chunk, plan
        assert plan.smem_bytes == smem_bytes(form, Kz, plan.chunk, plan.tile, plan.stages, H,
                                             Kl, dtype.itemsize, D) <= SMEM_LIMIT, plan
        if plan.stages == FULL:
            assert plan.tile == 32 and plan.smem_bytes <= FULL_LIMIT, plan
        else:
            assert plan.tile in TILES and plan.stages == STAGES, plan


# (form, dtype, Bs, K, S, D, H, Kl) -> (cluster, chunk, zsplit, tile, stages):
# the plans PERF.md §6 records for the zoo's bahdanau launches, training's
# forward, int8_full's launches of synthetic, the release shape and D = H =
# 256 (the whole chunk in shared memory: stages FULL = 0)
RECORDED_PLANS = {
    **{(CONTENT, torch.bfloat16, 1, 10, S, 512, 256, 0): plan for S, plan in (
        (47, (3, 16, 10, 32, 0)), (63, (4, 16, 10, 32, 0)), (95, (6, 16, 10, 32, 0)),
        (143, (6, 24, 10, 32, 0)), (207, (7, 32, 10, 32, 0)))},
    (CONTENT, torch.bfloat16, 8, 1, 207, 512, 256, 0): (7, 32, 1, 32, 0),
    (CONTENT, torch.int8, 1, 10, 207, 512, 256, 0): (7, 32, 10, 32, 0),
    **{(COVERAGE, torch.int8, Bs, 10, S, 128, 128, 64): plan for Bs, S, plan in (
        (1, 623, (8, 80, 10, 32, 0)), (8, 135, (6, 24, 2, 32, 0)), (8, 225, (6, 40, 2, 32, 0)),
        (8, 267, (6, 48, 2, 32, 0)), (8, 445, (6, 80, 2, 32, 0)),
        (64, 623, (2, 312, 2, 32, 2)))},
    (COVERAGE, torch.int8, 8, 10, 623, 256, 256, 128): (6, 104, 2, 32, 0),
    (COVERAGE, torch.int8, 8, 10, 2525, 256, 256, 128): (8, 320, 2, 32, 2),
}


@pytest.mark.parametrize("key", list(RECORDED_PLANS),
                         ids=lambda k: f"{k[0]}-{str(k[1])[6:]}-{k[2]}x{k[3]}-S{k[4]}-D{k[5]}")
def test_launch_plan_at_the_launched_shapes_is_the_recorded_one(key):
    form, dtype, Bs, K, S, D, H, Kl = key
    assert tuple(launch_plan(Bs, K, S, D, H, Kl, dtype, form))[:5] == RECORDED_PLANS[key]


def test_smem_bytes_is_the_kernels_make_layout(tmp_path):
    """The layout code of the kernel's source (its constants, ``Layout`` and
    ``make_layout``), compiled for the host, against ``smem_bytes`` for the
    three forms over beams, chunks, tiles, rings and the whole chunk,
    widths and memory types."""
    import os
    import subprocess

    from doc2tex_tpu_torch._build import CSRC
    from doc2tex_tpu_torch.ops.attention_step import SOURCE

    with open(os.path.join(CSRC, SOURCE)) as f:
        src = f.read()
    start = src.index("constexpr int kWarps")
    end = src.index("// 4 consecutive elements of T")
    codes = {FEATURE: 0, COVERAGE: 1, CONTENT: 2}
    grid = [(form, Kz, chunk, tile, stages, D, H, Kl, elem)
            for form, Kl in ((FEATURE, 64), (COVERAGE, 64), (CONTENT, 0))
            for Kz in (1, 5, 10) for chunk in (8, 80, 312) for tile in TILES
            for stages in ((2, 4) if form == FEATURE else (FULL, 2, 4))
            for D, H in ((128, 128), (512, 256)) for elem in (1, 2, 4)
            if not (form == FEATURE and elem == 1)]
    calls = "\n".join(
        f"  std::printf(\"%d\\n\", make_layout({codes[g[0]]}, {', '.join(map(str, g[1:]))}).total);"
        for g in grid)
    code = ("#include <cstdio>\n#define __host__\n#define __device__\nnamespace {\n"
            + src[start:end] + "}\nint main() {\n" + calls + "\n}\n")
    cpp = tmp_path / "layout.cpp"
    cpp.write_text(code)
    exe = tmp_path / "layout"
    subprocess.run(["g++", "-std=c++17", "-o", str(exe), str(cpp)], check=True,
                   capture_output=True, timeout=120)
    got = [int(x) for x in subprocess.run([str(exe)], check=True, capture_output=True,
                                          text=True).stdout.split()]
    want = [smem_bytes(form, Kz, chunk, tile, stages, H, Kl, elem, D)
            for form, Kz, chunk, tile, stages, D, H, Kl, elem in grid]
    assert got == want


def test_bench_shapes_are_the_slice_shapes():
    """The bench tool's shapes are the synthetic slice's launches
    (chip_smoke.lstm_launch_shapes) and the release shape."""
    import os
    import sys

    sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
    import chip_smoke

    assert [s[:3] for s in chip_smoke.lstm_launch_shapes()] == list(BENCH_SHAPES[:-1])
    assert BENCH_SHAPES[-1] == (64, 10, 623)
