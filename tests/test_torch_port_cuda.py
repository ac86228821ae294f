"""The port on a CUDA card: both kernels, B2's backward, a decode with each
head, a coverage-LSTM train step, a detector train step and the voting
stitch.

Every test here carries the ``cuda`` marker and skips without a card (the
kernel has no CPU mode).  The file imports neither jax nor the JAX package,
so it also runs on a machine that has only PyTorch:

    python -m pytest --noconftest -m cuda tests/test_torch_port_cuda.py
"""

from __future__ import annotations

import json
import os
import sys
import time

import numpy as np
import pytest
import torch

from doc2tex_tpu_torch.config import make_config
from doc2tex_tpu_torch.decode.runner import make_decode_fn
from doc2tex_tpu_torch.models import build_model
from doc2tex_tpu_torch.ops.attention_step import (
    CONTENT, COVERAGE, attention_step_reference, content_attention_step,
    content_attention_step_int8_reference, content_attention_step_reference,
    coverage_attention_step, coverage_attention_step_reference, fused_attention_step,
    launch_plan as b2_launch_plan)
from doc2tex_tpu_torch.ops.decode_attention import (
    decode_attention, decode_attention_reference, launch_plan)

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
import chip_smoke  # noqa: E402  (the repository root: the shared input makers)


def _need_card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernel has no CPU mode")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False


@pytest.mark.cuda
@pytest.mark.parametrize("dtype,atol", [(torch.float32, 1e-5), (torch.bfloat16, 2e-2)])
def test_kernel_matches_plain_version(dtype, atol):
    """The kernel against the plain version on the card at the release
    decode shapes (nh 8, hd 32; self-attention masked, cross not), and at
    hd 64 and 128."""
    _need_card()
    g = torch.Generator().manual_seed(0)
    cases = ((1, 1, 31, 8, 32, True), (16, 5, 151 * 5, 8, 32, True), (64, 10, 623, 8, 32, False),
             (4, 16, 100, 4, 64, True), (4, 3, 70, 2, 128, False))
    for B, K, M, nh, hd, masked in cases:
        q = (torch.randn(B, K, nh, hd, generator=g) / hd ** 0.5).to("cuda", dtype)
        k = torch.randn(B, M, nh, hd, generator=g).to("cuda", dtype)
        v = torch.randn(B, M, nh, hd, generator=g).to("cuda", dtype)
        mask = None
        if masked:
            mask = torch.rand(B, K, M, generator=g) < 0.3
            mask[:, :, -1] = True
            mask = mask.cuda()
        before = decode_attention.launches
        out = decode_attention(q, k, v, mask)
        assert decode_attention.launches == before + 1
        ref = decode_attention_reference(q, k, v, mask)
        torch.cuda.synchronize()
        assert out.dtype == dtype and out.shape == q.shape
        assert (out.float() - ref.float()).abs().max().item() <= atol, (B, K, M, nh, hd)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype,atol", [(torch.float32, 1e-5), (torch.bfloat16, 2e-2)])
def test_kernel_matches_plain_version_where_m_is_split(dtype, atol):
    """Shapes where launch_plan splits M over a cluster (B 1 and 8, M 1510
    and 5010), the golden slice's self-attention shapes at the last step of
    each cache chunk (a dead tail of unattended rows), and a row masked
    everywhere (NaN, as softmax)."""
    _need_card()
    cases = ((1, 10, 1510, True, None), (8, 10, 1510, True, None), (1, 10, 5010, True, 500),
             (8, 10, 623, False, None), (64, 10, 310, True, 30), (64, 10, 930, True, 71),
             (2, 16, 4000, True, None))
    for n, (B, K, M, masked, step) in enumerate(cases):
        q, k, v, mask = chip_smoke.attention_inputs(B, K, M, 8, 32, dtype, "cuda", masked,
                                                    seed=n, step=step)
        out = decode_attention(q, k, v, mask)
        ref = decode_attention_reference(q, k, v, mask)
        torch.cuda.synchronize()
        err = (out.float() - ref.float()).abs()
        assert (err <= atol + (1e-5 if dtype == torch.float32 else 0.0) * ref.float().abs()).all(), (
            B, K, M, launch_plan(B, K, M, 8, 32, dtype), err.max().item())
    q, k, v, mask = chip_smoke.attention_inputs(1, 10, 1510, 8, 32, dtype, "cuda", True, seed=9)
    mask[0, 3] = False
    out = decode_attention(q, k, v, mask)
    torch.cuda.synchronize()
    assert out[0, 3].isnan().all() and not out[0, torch.arange(10) != 3].isnan().any()


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float16])
def test_kernel_rounds_probabilities_where_the_reference_does(dtype):
    """On inputs where rounding p = 1/n to v's type before P.V and keeping
    it in float32 give different results, the kernel equals the plain
    version bit for bit: unsplit (spread 1) and over a cluster of 8 blocks
    (spread 500, M 1500 or 3500 with every 500th position attended)."""
    _need_card()
    for n, v0 in chip_smoke.ROUNDING_POINT_CASES:
        for spread, B, K, nh in ((1, 1, 1, 1), (500, 1, 10, 8)):
            q, k, v, mask = chip_smoke.rounding_point_inputs(n, v0, dtype, "cuda", B=B, K=K,
                                                             nh=nh, spread=spread)
            out = decode_attention(q, k, v, mask)
            ref = decode_attention_reference(q, k, v, mask)
            torch.cuda.synchronize()
            assert torch.equal(out, ref), (n, v0, spread, out.flatten()[0].item(),
                                           ref.flatten()[0].item())


@pytest.mark.cuda
def test_kernel_raises_past_its_plan():
    """An M that 8 blocks cannot hold raises before any launch."""
    _need_card()
    q = torch.zeros(1, 16, 8, 32, device="cuda")
    k = torch.zeros(1, 100_000, 8, 32, device="cuda")
    before = decode_attention.launches
    with pytest.raises(ValueError, match="does not fit"):
        decode_attention(q, k, k)
    assert decode_attention.launches == before
    # the int8 form refuses a plan with fewer bytes than its layout needs
    from doc2tex_tpu_torch.ops import decode_attention as b1

    q = torch.zeros(1, 4, 8, 32, device="cuda", dtype=torch.bfloat16)
    k8 = torch.zeros(1, 300, 8, 32, device="cuda", dtype=torch.int8)
    ks = torch.ones(1, 300, 8, device="cuda")
    plan = b1.LaunchPlan(1, 384, 3, b1.smem_bytes(4, 384, 3, 32, 2, 1) - 16)
    before = decode_attention.int8_launches
    with pytest.raises(RuntimeError, match="launch failed"):
        b1.launch(q, k8, k8, None, plan, scales=(ks, ks))
    assert decode_attention.int8_launches == before


@pytest.mark.cuda
def test_beam_decode_on_card_matches_cpu():
    """A tiny random-weight model, beam 5, float32: the same tokens on the
    card (kernel) as on the CPU (plain version)."""
    _need_card()
    cfg = make_config(dict(
        max_dimension=[64, 128], min_dimension=[32, 32], batch_max_length=40, dtype="float32",
        FeatureExtraction={"name": "None"},
        SequenceModeling={"name": "ViT", "params": {
            "backbone": {"name": "resnet", "input_channel": 1, "output_channel": 64},
            "fix_embed": True, "patching_style": "2d", "patch_size": [2, 2],
            "depth": 2, "num_heads": 2, "hidden_size": 64}},
        Prediction={"name": "TFM", "params": {
            "d_model": 64, "nhead": 2, "num_decoder_layers": 2, "dim_feedforward": 128}},
    ))
    torch.manual_seed(0)
    model = build_model(cfg, 24).eval()
    images = np.random.default_rng(0).integers(0, 256, (4, 32, 64, 1)).astype(np.uint8)
    cpu_tokens, _ = make_decode_fn(model, cfg, beam_size=5, device="cpu")(images)
    model.cuda()
    before = decode_attention.launches
    gpu_tokens, _ = make_decode_fn(model, cfg, beam_size=5, device="cuda")(images)
    assert decode_attention.launches > before
    np.testing.assert_array_equal(gpu_tokens.cpu().numpy(), cpu_tokens.numpy())


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_attention_step_kernel_matches_plain_version(dtype):
    """The coverage-attention kernel against the plain version on the card,
    at the release shape, the common width, few location features, one
    row and a masked tail: within 1e-5 abs + 1e-5 rel (both sum in
    float32)."""
    _need_card()
    g = torch.Generator(device="cuda").manual_seed(0)
    cases = ((1, 83, 128, 128, 64, None), (64, 623, 128, 128, 64, 606),
             (10, 2525, 256, 256, 128, None), (4, 50, 128, 128, 16, 33), (3, 7, 256, 256, 32, 0))
    for rows, S, D, H, Kl, valid in cases:
        kw = dict(
            enc=torch.randn(rows, S, D, generator=g, device="cuda").to(dtype),
            enc_proj=torch.randn(rows, S, H, generator=g, device="cuda").to(dtype),
            q=torch.randn(rows, H, generator=g, device="cuda"),
            loc_feat=torch.randn(rows, S, Kl, generator=g, device="cuda") * 0.5,
            w_loc=torch.randn(Kl, H, generator=g, device="cuda") * Kl ** -0.5,
            b_loc=torch.randn(H, generator=g, device="cuda") * 0.1,
            w_score=torch.randn(H, 1, generator=g, device="cuda") * H ** -0.5,
        )
        before = fused_attention_step.launches
        ctx, alpha = fused_attention_step(**kw, valid_len=valid)
        assert fused_attention_step.launches == before + 1
        ref_ctx, ref_alpha = attention_step_reference(**kw, valid_len=valid)
        torch.cuda.synchronize()
        assert ctx.shape == (rows, D) and alpha.shape == (rows, S)
        for got, ref in ((ctx, ref_ctx), (alpha, ref_alpha)):
            err = (got - ref).abs()
            assert (err <= 1e-5 + 1e-5 * ref.abs()).all(), (rows, S, D, H, Kl, valid,
                                                             err.max().item())


@pytest.mark.cuda
def test_attention_step_kernel_raises_on_what_it_does_not_take():
    """A width the kernel is not built for, and an S whose scores do not
    fit in the shared memory of a cluster of 8 blocks, raise on the card;
    they never run the plain version."""
    _need_card()

    def inputs(S, D, Kl):
        z = lambda *shape: torch.zeros(*shape, device="cuda")  # noqa: E731
        return dict(enc=z(1, S, D), enc_proj=z(1, S, D), q=z(1, D), loc_feat=z(1, S, Kl),
                    w_loc=z(Kl, D), b_loc=z(D), w_score=z(D))

    for S, D, Kl in ((10, 64, 16), (1_000_000, 128, 64)):
        before = fused_attention_step.launches
        with pytest.raises((ValueError, RuntimeError)):
            fused_attention_step(**inputs(S, D, Kl))
        assert fused_attention_step.launches == before
    ctx, _ = fused_attention_step(**inputs(83, 128, 64))
    torch.cuda.synchronize()
    assert ctx.shape == (1, 128)  # the failed launch left no error behind


@pytest.mark.cuda
def test_lstm_beam_decode_on_card_matches_cpu():
    """A tiny random-weight coverage-LSTM model, beam 5, float32: the same
    tokens on the card (kernel) as on the CPU (plain version)."""
    _need_card()
    cfg = make_config(dict(
        max_dimension=[64, 128], min_dimension=[32, 32], batch_max_length=40, dtype="float32",
        FeatureExtraction={"name": "None"},
        SequenceModeling={"name": "ViT", "params": {
            "backbone": {"name": "resnet", "input_channel": 1, "output_channel": 32},
            "fix_embed": True, "patching_style": "2d", "patch_size": [2, 2],
            "depth": 1, "num_heads": 2, "hidden_size": 128}},
        Prediction={"name": "Attnv2", "params": {
            "seqmodel": "TFM", "input_size": 128, "hidden_size": 128, "kernel_size": 2,
            "kernel_dim": 16, "enc_init": True, "attn_type": "coverage"}},
    ))
    torch.manual_seed(0)
    model = build_model(cfg, 24).eval()
    with torch.no_grad():  # weights of unit fan-in scale, so logits are far from ties
        for p in model.predicter.parameters():
            p.normal_(0.0, p.shape[0] ** -0.5 if p.dim() > 1 else 0.1)
    images = np.random.default_rng(0).integers(0, 256, (4, 32, 64, 1)).astype(np.uint8)
    cpu_tokens, _ = make_decode_fn(model, cfg, beam_size=5, device="cpu")(images)
    model.cuda()
    state = model.init_decode_state(model.encode(torch.zeros(4, 32, 64, 1, device="cuda")), 41, 5)
    assert state.enc.shape[0] == state.enc_proj.shape[0] == 4     # sample rows
    assert state.h.shape[0] == state.alpha_cum.shape[0] == 20     # beam rows
    before = coverage_attention_step.launches
    gpu_tokens, _ = make_decode_fn(model, cfg, beam_size=5, device="cuda")(images)
    assert coverage_attention_step.launches > before
    np.testing.assert_array_equal(gpu_tokens.cpu().numpy(), cpu_tokens.numpy())


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_coverage_step_kernel_matches_plain_version(dtype):
    """The coverage form (location conv folded in, memory at sample rows)
    against its plain version on the card, within chip_smoke's B2_TOL, at
    plans that split S over a cluster and beams over groups and plans that
    do not: the slice's shapes, the release shape, greedy, a masked tail
    whose conv window reads coverage past valid_len, and a narrower conv."""
    _need_card()
    atol, rtol = chip_smoke.B2_TOL
    cases = ((8, 10, 445, 128, 64, None, 150), (1, 10, 623, 128, 64, 606, 1),
             (64, 10, 623, 128, 64, None, 150), (8, 1, 135, 128, 64, None, 1),
             (2, 5, 2525, 256, 128, 2508, 150), (3, 3, 50, 256, 16, 20, 7))
    for n, (Bs, K, S, D, Kl, valid, t) in enumerate(cases):
        taps = 3 if n == len(cases) - 1 else 5
        kw = chip_smoke.coverage_step_inputs(Bs, K, S, D, D, Kl, dtype, t, seed=n, taps=taps)
        plan = b2_launch_plan(Bs, K, S, D, D, Kl, dtype, COVERAGE, taps)
        before = coverage_attention_step.launches
        ctx, alpha = coverage_attention_step(**kw, valid_len=valid)
        assert coverage_attention_step.launches == before + 1
        ref_ctx, ref_alpha = coverage_attention_step_reference(**kw, valid_len=valid)
        torch.cuda.synchronize()
        assert ctx.shape == (Bs * K, D) and alpha.shape == (Bs * K, S)
        for got, ref in ((ctx, ref_ctx), (alpha, ref_alpha)):
            err = (got - ref).abs()
            assert (err <= atol + rtol * ref.abs()).all(), (Bs, K, S, D, Kl, valid, t, plan,
                                                            err.max().item())


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_d_not_h_and_content_kernels_match_plain_version(dtype):
    """The coverage form at D != H and the content form (no location term,
    the bahdanau head) against their plain versions on the card, within
    B2_TOL: the zoo's shapes (D 512 H 256 on a VGG map's 239 columns, D = H
    = 256 on 241), D < H, greedy, a masked tail, and the content form on
    int8 memory in both compute types; the feature form at D 512, H 128."""
    _need_card()
    atol, rtol = chip_smoke.B2_TOL

    def check(got, ref, *where):
        torch.cuda.synchronize()
        for a, b in zip(got, ref):
            err = (a - b).abs()
            assert (err <= atol + rtol * b.abs()).all(), (where, err.max().item())

    for n, (Bs, K, S, D, H, valid) in enumerate((
            (8, 10, 239, 512, 256, None), (8, 10, 241, 256, 256, None), (3, 5, 90, 128, 256, 77),
            (2, 1, 600, 512, 128, None), (64, 10, 239, 512, 256, 200))):
        kw = chip_smoke.coverage_step_inputs(Bs, K, S, D, H, 64, dtype, 20, seed=n)
        before = coverage_attention_step.launches
        got = coverage_attention_step(**kw, valid_len=valid)
        assert coverage_attention_step.launches == before + 1
        check(got, coverage_attention_step_reference(**kw, valid_len=valid), "coverage", n)
        content = {k: kw[k] for k in ("enc", "enc_proj", "q", "w_score")}
        plan = b2_launch_plan(Bs, K, S, D, H, 0, dtype, CONTENT)
        before = content_attention_step.launches
        got = content_attention_step(**content, valid_len=valid)
        assert content_attention_step.launches == before + 1
        check(got, content_attention_step_reference(**content, valid_len=valid), "content",
              n, plan)
        for compute in (torch.float32, torch.bfloat16):
            q8 = dict(content, enc=torch.randint(-127, 128, (Bs, S, D), device="cuda",
                                                 dtype=torch.int8),
                      enc_proj=torch.randint(-127, 128, (Bs, S, H), device="cuda",
                                             dtype=torch.int8),
                      enc_scale=torch.rand(Bs, 1, 1, device="cuda") / 64,
                      proj_scale=torch.rand(Bs, 1, 1, device="cuda") / 64, compute_dtype=compute)
            before = content_attention_step.int8_launches
            got = content_attention_step(**q8, valid_len=valid)
            assert content_attention_step.int8_launches == before + 1
            ref = content_attention_step_int8_reference(*(q8[k] for k in (
                "enc", "enc_proj", "q", "w_score")), valid, q8["enc_scale"], q8["proj_scale"],
                compute)
            check(got, ref, "content int8", n, compute)
    # the feature form (the TPU kernel's own contract) at D != H
    kw = chip_smoke.attention_step_inputs(40, 300, 512, 128, 16, dtype, seed=9)
    check(fused_attention_step(**kw, valid_len=250),
          attention_step_reference(**kw, valid_len=250), "feature", 512)


@pytest.mark.cuda
@pytest.mark.parametrize("mem,compute", [("bfloat16", None), ("float32", None),
                                         ("int8", "bfloat16"), ("int8", "float32")])
def test_content_and_int8_forms_match_plain_version_at_launched_shapes(mem, compute):
    """The content form (float and int8 memory) at the zoo's launched
    shapes (1 sample x beam 10, S 47-207, D 512, H 256, and training's K =
    1, 8 x S 207) and the int8 coverage form at ``synthetic``'s int8_full
    launches, the release shape and D = H = 256, through the wrappers (each
    call one counted launch of its form), valid_len None and S - 17, within
    B2_TOL; then (once, in the int8/bf16 case) every form at forced plans
    of a cluster of 1 and of 8 (``chip_smoke.check_b2_plans``, uncounted
    launches) and the int8 form's P bits on rounding-point inputs."""
    _need_card()
    from doc2tex_tpu_torch.ops import attention_step as b2
    from doc2tex_tpu_torch.tools.bench_attention_step import CONTENT_SHAPES, INT8_SHAPES

    cases = [("content", (Bs, K, S, 512, 256, 0)) for Bs, K, S in CONTENT_SHAPES]
    if mem == "int8":
        cases += [("coverage", (Bs, K, S, D, D, Kl)) for Bs, K, S, D, Kl in INT8_SHAPES]
    for n, (form, shape) in enumerate(cases):
        kw, q8, ref = chip_smoke.b2_case_inputs(form, mem, compute, *shape, 150, seed=n)
        step = b2.content_attention_step if form == "content" else b2.coverage_attention_step
        for valid in (None, shape[2] - 17):
            before = step.launches, step.int8_launches
            got = step(**kw, **q8, valid_len=valid)
            assert (step.launches, step.int8_launches) == (
                before[0] + (not q8), before[1] + bool(q8))
            torch.cuda.synchronize()
            chip_smoke._check_b2(f"{form} {mem}", got, ref(valid), (shape, valid))
    if (mem, compute) != ("int8", "bfloat16"):
        return
    counts = b2.content_attention_step.launches, b2.coverage_attention_step.int8_launches
    n, plans, _ = chip_smoke.check_b2_plans()
    assert n >= 2 * len(chip_smoke.B2_PLAN_CASES) * 4 and {p[2] for p in plans} == {1, 8}
    assert {p[4] for p in plans} == {b2.FULL, 2}
    assert [r[0] for r in chip_smoke.b2_int8_rounding_point_check()] == ["coverage", "content"]
    # the checks add no main-path launch
    assert (b2.content_attention_step.launches,
            b2.coverage_attention_step.int8_launches) == counts


@pytest.mark.cuda
def test_zoo_heads_refuse_a_gradient_on_the_card(monkeypatch):
    """(Named for what it checked before B2's backward took these forms.)
    A gradient through the content form (the bahdanau head, D 512, H 256)
    and through the coverage form at D 512 != H 256 now goes through the
    kernels: over a 3-step sequence each forward and backward launches
    once a step, nothing raises, the plain versions never run, and the
    gradients match autograd of the plain steps on the same inputs
    (float32, chip_smoke's B2_BWD_TOL of each gradient's largest magnitude,
    times 10 for the three steps' sums)."""
    _need_card()
    from doc2tex_tpu_torch.ops import attention_step as b2

    kw = chip_smoke.coverage_step_inputs(2, 1, 50, 512, 256, 64, torch.float32, 1, seed=0)
    names = {b2.COVERAGE: ("enc", "enc_proj", "loc_conv_w", "loc_conv_b", "w_loc", "b_loc",
                           "w_score"),
             b2.CONTENT: ("enc", "enc_proj", "w_score")}
    qs = [torch.randn(2, 256, device="cuda") for _ in range(3)]
    g = [torch.randn(2, 512, device="cuda") for _ in range(3)]

    def run(form, step):
        leaves = {k: kw[k].detach().clone().requires_grad_() for k in names[form]}
        q_leaves = [q.clone().requires_grad_() for q in qs]
        cum, loss = torch.zeros(2, 50, device="cuda"), 0.0
        for t in range(3):
            if form == b2.COVERAGE:
                ctx, alpha = step(leaves["enc"], leaves["enc_proj"], q_leaves[t], cum,
                                  leaves["loc_conv_w"], leaves["loc_conv_b"], leaves["w_loc"],
                                  leaves["b_loc"], leaves["w_score"])
            else:
                ctx, alpha = step(leaves["enc"], leaves["enc_proj"], q_leaves[t],
                                  leaves["w_score"])
            loss = loss + (ctx * g[t]).sum() + (alpha * alpha).sum()
            cum = cum + alpha
        return torch.autograd.grad(loss, list(leaves.values()) + q_leaves)

    steps = {b2.COVERAGE: (b2.coverage_attention_step, b2.coverage_attention_step_reference,
                           b2.coverage_attention_step_backward),
             b2.CONTENT: (b2.content_attention_step, b2.content_attention_step_reference,
                          b2.content_attention_step_backward)}
    want = {form: run(form, plain) for form, (_, plain, _) in steps.items()}

    def refuse(*a, **k):
        raise AssertionError("the plain version ran")

    for name in ("coverage_attention_step_reference", "coverage_attention_step_backward_reference",
                 "content_attention_step_reference", "content_attention_step_backward_reference"):
        monkeypatch.setattr(b2, name, refuse)
    for form, (step, _, backward) in steps.items():
        fwd, bwd = step.launches, backward.launches
        got = run(form, step)
        torch.cuda.synchronize()
        assert step.launches == fwd + 3 and backward.launches == bwd + 3, form
        for a, b in zip(got, want[form]):
            assert (a - b).abs().max().item() <= (10 * chip_smoke.B2_BWD_TOL
                                                  * b.abs().max().item()), form


@pytest.mark.cuda
def test_coverage_step_kernel_raises_on_what_it_does_not_take():
    """On the card the coverage form raises, before any launch, on a width
    the kernel is not built for (H 64, D 1024), a conv wider than 5 taps
    and an S no plan holds; a CUDA error is not left behind."""
    _need_card()

    def inputs(Bs, K, S, D, H, Kl, taps):
        z = lambda *shape: torch.zeros(*shape, device="cuda")  # noqa: E731
        return dict(enc=z(Bs, S, D), enc_proj=z(Bs, S, H), q=z(Bs * K, H), mem=z(Bs * K, S),
                    loc_conv_w=z(taps, 1, Kl), loc_conv_b=z(Kl), w_loc=z(Kl, H), b_loc=z(H),
                    w_score=z(H))

    for args in ((1, 5, 10, 64, 64, 16, 5), (1, 5, 10, 128, 128, 16, 7),
                 (1, 5, 10, 1024, 256, 16, 5), (1, 16, 2_000_000, 128, 128, 64, 5)):
        before = coverage_attention_step.launches
        with pytest.raises(ValueError):
            coverage_attention_step(**inputs(*args))
        assert coverage_attention_step.launches == before
    ctx, _ = coverage_attention_step(**inputs(2, 5, 83, 128, 128, 64, 5))
    torch.cuda.synchronize()
    assert ctx.shape == (10, 128)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_int8_ops_on_card_equal_cpu(dtype):
    """The int8 Dense and convolutions on the card against the CPU, bit for
    bit: at M <= 16 (the zero-row padding), at K and N that are not
    multiples of 8 (the zero-column padding), and at encoder shapes."""
    _need_card()
    from doc2tex_tpu_torch.models.layers import Dense
    from doc2tex_tpu_torch.models.resnet import Conv

    g = torch.Generator().manual_seed(3)
    cases = [(Dense(256, 128, dtype=dtype), (5, 256)), (Dense(260, 130, dtype=dtype), (3, 7, 260)),
             (Dense(256, 768, dtype=dtype), (2, 311, 256)),
             (Conv(64, 128, (3, 3), (1, 1), (1, 1), dtype=dtype), (2, 64, 14, 44)),
             (Conv(128, 128, (2, 2), (2, 1), (0, 1), dtype=dtype), (2, 128, 6, 45)),
             (Conv(256, 256, (2, 2), (2, 2), (0, 0), bias=True, dtype=dtype), (1, 256, 8, 8))]
    for layer, shape in cases:
        layer.int8 = True
        assert layer.takes_int8()
        x = torch.randn(*shape, generator=g) * 2
        with torch.inference_mode():
            want = layer(x)
            got = layer.to("cuda")(x.cuda()).cpu()
        assert torch.equal(got, want), (type(layer).__name__, shape)


@pytest.mark.cuda
def test_detector_on_card_does_not_follow_the_process_tf32_setting():
    """The released detector on the card, on the first page of the page
    eval cut to 512x768 (3 windows, formulas): the same bits with the
    process's cuDNN TF32 on (torch's default, as the app and the server
    run) as off, and the CPU's boxes within chip_smoke's tolerances."""
    _need_card()
    from doc2tex_tpu_torch.detection.flow import SHIPPED_WEIGHTS, MathDetector
    from doc2tex_tpu_torch.tools.page_eval import synth_labelled_page

    page = np.ascontiguousarray(synth_labelled_page(np.random.default_rng(35))[0][:512, :768])
    det = MathDetector(SHIPPED_WEIGHTS)
    out = {}
    try:
        for flag in (True, False):
            torch.backends.cudnn.allow_tf32 = flag
            out[flag] = det.detect_page(page)
    finally:
        torch.backends.cudnn.allow_tf32 = False
    for a, b in zip(out[True], out[False]):
        np.testing.assert_array_equal(a, b)
    boxes, scores = MathDetector(SHIPPED_WEIGHTS, device="cpu").detect_page(page)
    assert len(boxes) >= 1 and boxes.shape == out[False][0].shape
    np.testing.assert_allclose(out[False][0], boxes, atol=chip_smoke.BOX_TOL_PX, rtol=0)
    np.testing.assert_allclose(out[False][1], scores, atol=chip_smoke.SCORE_TOL, rtol=0)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype,atol", [(torch.float32, 1e-5), (torch.bfloat16, 2e-2)])
def test_kernel_matches_plain_version_at_the_long_shapes(dtype, atol):
    """The ``synthetic_long`` decode's shapes: self-attention over every
    cache chunk to M 5010 (501 steps x beam 10, the last step live) and
    cross-attention over a 448x960 bucket's 1694 patches and the cls
    token, at batch 16 (the release eval's) and 64 (a 16-crop call's
    snapped batch)."""
    _need_card()
    cases = [(B, 10, M, True, M // 10 - 1) for B in (16, 64) for M in (1010, 3030, 5010)]
    cases += [(B, 10, 1695, False, None) for B in (16, 64)]
    for n, (B, K, M, masked, step) in enumerate(cases):
        q, k, v, mask = chip_smoke.attention_inputs(B, K, M, 8, 32, dtype, "cuda", masked,
                                                    seed=n, step=step)
        out = decode_attention(q, k, v, mask)
        ref = decode_attention_reference(q, k, v, mask)
        torch.cuda.synchronize()
        err = (out.float() - ref.float()).abs()
        assert (err <= atol + (1e-5 if dtype == torch.float32 else 0.0) * ref.float().abs()).all(), (
            B, K, M, launch_plan(B, K, M, 8, 32, dtype), err.max().item())


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_coverage_step_kernel_at_the_reference_width(dtype):
    """B2's coverage form at the ``common`` block's widths (D = H = 256,
    kernel_dim 128) over an 800x800 bucket's 2525 patches and a 448x960
    bucket's 1694, 1 and 8 samples x beam 10, coverage of steps 1 and 150:
    within chip_smoke's B2 tolerance of the plain version."""
    _need_card()
    n, _ = chip_smoke.check_coverage_shapes(
        [(Bs, 10, S, 256, 256, 128) for Bs in (1, 8) for S in (1694, 2525)])
    assert n == 2 * 4 * 2 * 2


@pytest.mark.cuda
def test_long_release_decode_on_card_matches_cpu():
    """The released ``synthetic_long`` weights, float32, beam 10, one golden
    long crop in its 448x960 bucket with ``batch_max_length`` cut to 40:
    the same tokens on the card as on the CPU."""
    _need_card()
    from doc2tex_tpu_torch.recognition import MathRecognition, load_recog_config

    _, crops = chip_smoke.golden_crops("synthetic_long")
    cfg, weights = load_recog_config(version="synthetic_long")
    cfg.update(dtype="float32", quantize=None, batch_max_length=40)
    tokens = {}
    for device in ("cuda", "cpu"):
        rec = MathRecognition(dict(cfg), weights, beam_size=10, device=device)
        prepped = [rec._preprocess(crops[0])]
        (bucket, _), = rec.group(prepped).items()
        assert bucket == (448, 960)
        tokens[device] = rec._decode(rec.make_batch(prepped, bucket))[0].cpu()
    assert torch.equal(tokens["cuda"], tokens["cpu"])


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_coverage_backward_kernel_matches_plain_version(dtype):
    """B2's backward (K = 1) against its plain version, within chip_smoke's
    B2_BWD_TOL: the coverage form (coverage and loc_aware memory) and the
    content form (bahdanau), at D = H = 128 and 256 and at D != H (the zoo's
    D 512, H 256; D 512, H 128; D 128, H 256), S that the block chunks do
    not divide, S below the 5 taps and S where a cluster's last ranks own
    no positions; two runs on the same inputs give the same bits
    (``check_backward``)."""
    _need_card()
    from doc2tex_tpu_torch.ops import attention_step as b2

    cases = ((32, 623, 128, 128, 64), (3, 3, 128, 128, 64), (5, 61, 256, 256, 128),
             (2, 1000, 256, 256, 8), (7, 130, 128, 128, 16), (16, 239, 512, 256, 128),
             (4, 300, 512, 128, 16), (3, 77, 128, 256, 8), (5, 9, 256, 128, 64))
    for n, (B, S, D, H, Kl) in enumerate(cases):
        for attn in ("coverage", "loc_aware", "bahdanau"):
            args = chip_smoke.backward_inputs(B, S, D, H, Kl, dtype, attn, seed=n)
            fn = (b2.content_attention_step_backward if attn == "bahdanau"
                  else b2.coverage_attention_step_backward)
            before = fn.launches
            chip_smoke.check_backward(args, (B, S, D, H, Kl, attn))
            assert fn.launches == before
            got = fn(*args)
            assert fn.launches == before + 1
            assert got[0].dtype == got[1].dtype == dtype
            assert got[0].shape == (B, S, D) and got[1].shape == (B, S, H)
            if attn != "bahdanau":
                assert got[4].shape == (5, 1, Kl) and got[3].shape == (B, S)


@pytest.mark.cuda
def test_coverage_backward_kernel_raises_on_what_it_does_not_take():
    """The backward raises, before any launch, on K > 1, a width the kernel
    is not built for (D = H = 64) and a conv wider than 5 taps."""
    _need_card()
    from doc2tex_tpu_torch.ops.attention_step import coverage_attention_step_backward

    def inputs(B, K, S, D, H, Kl, taps):
        z = lambda *shape: torch.zeros(*shape, device="cuda")  # noqa: E731
        return [z(B, S, D), z(B, S, H), z(B * K, H), z(B * K, S), z(taps, 1, Kl), z(Kl),
                z(Kl, H), z(H), z(H), z(B * K, S), z(B * K, D), z(B * K, S)]

    for args in ((2, 5, 10, 128, 128, 16, 5), (2, 1, 10, 64, 64, 16, 5),
                 (2, 1, 10, 128, 128, 16, 7)):
        before = coverage_attention_step_backward.launches
        with pytest.raises(ValueError):
            coverage_attention_step_backward(*inputs(*args))
        assert coverage_attention_step_backward.launches == before
    out = coverage_attention_step_backward(*inputs(2, 1, 83, 128, 128, 64, 5))
    torch.cuda.synchronize()
    assert out[0].shape == (2, 83, 128)


@pytest.mark.cuda
def test_coverage_step_under_autograd_runs_both_kernels(monkeypatch):
    """A 3-step coverage sequence on the card under autograd launches the
    forward kernel 3 times and the backward kernel 3 times and never the
    plain versions; its gradients match autograd of the plain version on
    the same inputs (float32, chip_smoke's B2_BWD_TOL of each gradient's
    largest magnitude, times 10 for the three steps' sums)."""
    _need_card()
    from doc2tex_tpu_torch.ops import attention_step as b2

    kw = chip_smoke.coverage_step_inputs(4, 1, 300, 128, 128, 64, torch.float32, 1, seed=3)
    names = ("enc", "enc_proj", "loc_conv_w", "loc_conv_b", "w_loc", "b_loc", "w_score")
    qs = [torch.randn(4, 128, device="cuda") for _ in range(3)]
    g = [torch.randn(4, 128, device="cuda") for _ in range(3)]

    def run(step):
        leaves = {k: kw[k].detach().clone().requires_grad_() for k in names}
        q_leaves = [q.clone().requires_grad_() for q in qs]
        cum, loss = torch.zeros(4, 300, device="cuda"), 0.0
        for t in range(3):
            ctx, alpha = step(leaves["enc"], leaves["enc_proj"], q_leaves[t], cum,
                              leaves["loc_conv_w"], leaves["loc_conv_b"], leaves["w_loc"],
                              leaves["b_loc"], leaves["w_score"])
            loss = loss + (ctx * g[t]).sum() + (alpha * alpha).sum()
            cum = cum + alpha
        return torch.autograd.grad(loss, list(leaves.values()) + q_leaves)

    want = run(b2.coverage_attention_step_reference)

    def refuse(*a, **k):
        raise AssertionError("the plain version ran")

    monkeypatch.setattr(b2, "coverage_attention_step_reference", refuse)
    monkeypatch.setattr(b2, "coverage_attention_step_backward_reference", refuse)
    fwd, bwd = b2.coverage_attention_step.launches, b2.coverage_attention_step_backward.launches
    got = run(b2.coverage_attention_step)
    torch.cuda.synchronize()
    assert b2.coverage_attention_step.launches == fwd + 3
    assert b2.coverage_attention_step_backward.launches == bwd + 3
    for a, b in zip(got, want):
        assert (a - b).abs().max().item() <= 10 * chip_smoke.B2_BWD_TOL * b.abs().max().item()


@pytest.mark.cuda
def test_lstm_train_step_on_card_matches_cpu():
    """A small coverage-LSTM model at the kernels' width (D = H = 128),
    float32, random weights: the teacher-forced loss and the gradients on
    the card against the CPU's (loss 1e-5 relative, each leaf of the head
    and the ViT within 1e-3 of its norm, as chip_smoke's TRAIN_TOL; the
    ResNet's leaves are left out, since at random weights its float32
    gradient flips ReLU choices, tests/test_torch_port_train.py), B2's
    forward and backward launching once per decode step."""
    _need_card()
    from doc2tex_tpu_torch.ops import attention_step as b2
    from doc2tex_tpu_torch.train.trainer import criterion_from_config, loss_and_grads
    from doc2tex_tpu_torch.transforms.augment import normalize

    cfg = make_config(dict(
        max_dimension=[64, 256], min_dimension=[32, 32], batch_max_length=20, dtype="float32",
        FeatureExtraction={"name": "None"},
        SequenceModeling={"name": "ViT", "params": {
            "backbone": {"name": "resnet", "input_channel": 1, "output_channel": 32,
                         "gcb": False},
            "fix_embed": True, "input_channel": 1, "patching_style": "2d",
            "patch_size": [2, 2], "depth": 1, "num_heads": 4, "hidden_size": 128}},
        Prediction={"name": "Attnv2", "params": {
            "seqmodel": "TFM", "input_size": 128, "hidden_size": 128, "kernel_size": 2,
            "kernel_dim": 64, "embed_target": True, "enc_init": True,
            "attn_type": "coverage", "droprate": 0.0}}))
    torch.manual_seed(0)
    model = build_model(cfg, 30)
    rng = np.random.default_rng(0)
    images = torch.from_numpy(rng.integers(0, 256, (4, 64, 256, 1)).astype(np.uint8))
    text = torch.from_numpy(rng.integers(3, 30, (4, 22))).long()
    text[:, 0] = 0
    crit = criterion_from_config(cfg)
    out = {}
    for device in ("cpu", "cuda"):
        m = build_model(cfg, 30).to(device)
        m.load_state_dict(model.state_dict())
        fwd, bwd = b2.coverage_attention_step.launches, b2.coverage_attention_step_backward.launches
        loss, _, grads = loss_and_grads(m, crit, normalize(images.to(device)), text.to(device))
        out[device] = (float(loss), {k: v.cpu() for k, v in grads.items()})
        if device == "cuda":
            assert b2.coverage_attention_step.launches == fwd + 21
            assert b2.coverage_attention_step_backward.launches == bwd + 21
    (l0, g0), (l1, g1) = out["cpu"], out["cuda"]
    assert abs(l1 - l0) <= 1e-5 * abs(l0)
    norm = float(torch.sqrt(sum((g ** 2).sum() for g in g0.values())))
    for k, g in g0.items():
        if "ResNetFeatureExtractor" not in k:
            assert (g1[k] - g).abs().max().item() <= 1e-3 * g.norm().item() + 1e-5 * norm, k


@pytest.mark.cuda
def test_detector_train_step_on_card_matches_cpu():
    """chip_smoke's detect_train (a) at 2 windows of the pool: the float32
    Adam step from the shipped detector on the card against the CPU (loss,
    every gradient leaf, the weights after the step)."""
    _need_card()
    with open(chip_smoke.GOLDEN_DETECT_SOAK) as f:
        golden = json.load(f)
    chip_smoke.detect_step_parity(time.perf_counter(), golden, "cuda", n=2)


@pytest.mark.cuda
def test_stitch_on_card_matches_jax_golden():
    """chip_smoke's detect_train (e) on the first golden page: the stitched
    boxes within 1 px of the JAX package's and ``App(stitch=True)``'s
    strings, B1 launching."""
    _need_card()
    chip_smoke.stitch_check(time.perf_counter(), "cuda", n_pages=1)


# ---- the int8 forms of B1 and B2 (decode memory in int8) -----------------------

@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_int8_kv_kernel_matches_plain_version(dtype):
    """B1's int8 K/V form against its plain version (chip_smoke.TOL) at the
    release shapes, where M is split over a cluster, a dead cache tail, and
    hd 64 and 128; bit for bit (bf16) on the rounding-point inputs."""
    _need_card()
    cases = ((64, 10, 1510, 8, 32, True, 150), (64, 10, 623, 8, 32, False, None),
             (1, 10, 5010, 8, 32, True, 500), (8, 10, 1510, 8, 32, True, None),
             (64, 10, 930, 8, 32, True, 71), (4, 16, 96, 4, 64, True, None),
             (4, 3, 70, 2, 128, False, None), (2, 5, 300, 2, 128, True, None))
    # the int8 form's own edges: M one past a tile (256 positions with bf16
    # q; a masked M is T steps x K), a dead cache tail of whole tiles, and a
    # cluster split of 256-tiles
    cases += ((4, 10, 257, 8, 32, False, None), (4, 1, 257, 8, 32, True, None),
              (2, 10, 1510, 8, 32, True, 40), (1, 10, 2570, 8, 32, True, 256),
              (3, 16, 513, 2, 64, False, None))
    before = decode_attention.int8_launches
    for B, K, M, nh, hd, masked, step in cases:
        chip_smoke.check_attention_int8(B, K, M, nh, hd, dtype, masked, seed=M, step=step)
    assert chip_smoke.int8_rounding_point_check() == 6
    assert decode_attention.int8_launches == before      # the checks do not count
    # every ring the launcher takes (2..8), and a mask whose middle tiles no
    # beam attends, through launch() with explicit plans
    from doc2tex_tpu_torch.ops import decode_attention as b1

    B, K, M, nh, hd = 4, 10, 2000, 8, 32
    q, k8, v8, ks, vs, mask = chip_smoke.int8_attention_inputs(B, K, M, nh, hd, dtype, True, 5)
    mask[:, :, 300:1100] = False
    ref = b1.decode_attention_int8_reference(q, k8, v8, mask, ks, vs)
    chunk = -(-M // b1.TILE) * b1.TILE
    atol, rtol = chip_smoke.INT8_TOL[str(dtype).split(".")[-1]]
    for stages in range(2, 9):
        plan = b1.LaunchPlan(1, chunk, stages, b1.smem_bytes(K, chunk, stages, hd,
                                                             dtype.itemsize, 1))
        got = b1.launch(q, k8, v8, mask, plan, scales=(ks, vs))
        torch.testing.assert_close(got.float(), ref.float(), atol=atol, rtol=rtol)
    assert decode_attention.int8_launches == before + 7  # launch() counts each of its launches
    decode_attention.int8_launches = before


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_int8_memory_kernel_matches_plain_version(dtype):
    """B2's int8 form (coverage; float32 or bf16 compute) against its plain
    version (chip_smoke.B2_TOL): K 1, 5, 10, D = H 128 and 256, S split
    over clusters, valid_len None and S - 17."""
    _need_card()
    from doc2tex_tpu_torch.ops.attention_step import coverage_attention_step_int8_reference

    shapes = ((64, 10, 623, 128, 128, 64), (3, 1, 83, 128, 128, 64), (8, 5, 445, 256, 256, 128),
              (2, 10, 2525, 256, 256, 128))
    for i, (Bs, K, S, D, H, Kl) in enumerate(shapes):
        kw, q8 = chip_smoke.coverage_int8_inputs(Bs, K, S, D, H, Kl, dtype, 150, seed=i)
        for valid in (None, S - 17):
            before = coverage_attention_step.int8_launches
            got = coverage_attention_step(**kw, valid_len=valid, **q8)
            assert coverage_attention_step.int8_launches == before + 1
            ref = coverage_attention_step_int8_reference(*kw.values(), valid, q8["enc_scale"],
                                                         q8["proj_scale"], dtype)
            torch.cuda.synchronize()
            chip_smoke._check_b2("int8 form", got, ref, (Bs, K, S, D, valid))


def _tiny_decode_config(head: str) -> dict:
    if head == "TFM":
        return make_config(dict(
            max_dimension=[64, 128], min_dimension=[32, 32], batch_max_length=40,
            dtype="float32", FeatureExtraction={"name": "None"},
            SequenceModeling={"name": "ViT", "params": {
                "backbone": {"name": "resnet", "input_channel": 1, "output_channel": 64},
                "fix_embed": True, "patching_style": "2d", "patch_size": [2, 2],
                "depth": 2, "num_heads": 2, "hidden_size": 64}},
            Prediction={"name": "TFM", "params": {
                "d_model": 64, "nhead": 2, "num_decoder_layers": 2, "dim_feedforward": 128}}))
    return make_config(dict(
        max_dimension=[64, 128], min_dimension=[32, 32], batch_max_length=40, dtype="float32",
        FeatureExtraction={"name": "None"},
        SequenceModeling={"name": "ViT", "params": {
            "backbone": {"name": "resnet", "input_channel": 1, "output_channel": 32},
            "fix_embed": True, "patching_style": "2d", "patch_size": [2, 2],
            "depth": 1, "num_heads": 2, "hidden_size": 128}},
        Prediction={"name": "Attnv2", "params": {
            "seqmodel": "TFM", "input_size": 128, "hidden_size": 128, "kernel_size": 2,
            "kernel_dim": 16, "enc_init": True, "attn_type": "coverage"}}))


@pytest.mark.cuda
@pytest.mark.parametrize("head,parts", [("TFM", ("decoder_mem",)),
                                        ("TFM", ("decoder_mem", "decoder_kv")),
                                        ("Attnv2", ("decoder_mem",))])
def test_int8_memory_decode_on_card_matches_cpu(head, parts):
    """Tiny random-weight models, beam 5, float32, decode memory in int8:
    the same tokens on the card (the int8 forms; no float launch where the
    memory is int8) as on the CPU (their plain versions)."""
    _need_card()
    cfg = _tiny_decode_config(head)
    torch.manual_seed(0)
    model = build_model(cfg, 24).eval()
    if head != "TFM":
        with torch.no_grad():  # weights of unit fan-in scale, so logits are far from ties
            for p in model.predicter.parameters():
                p.normal_(0.0, p.shape[0] ** -0.5 if p.dim() > 1 else 0.1)
    model.set_quantize(parts)
    images = np.random.default_rng(0).integers(0, 256, (4, 32, 64, 1)).astype(np.uint8)
    cpu_tokens, _ = make_decode_fn(model, cfg, beam_size=5, device="cpu")(images)
    model.cuda()
    chip_smoke.reset_launches()
    gpu_tokens, _ = make_decode_fn(model, cfg, beam_size=5, device="cuda")(images)
    counts = chip_smoke.launch_counts()
    if head == "TFM":
        assert counts["decode_attention_int8"] > 0
        assert (counts["decode_attention"] == 0) == ("decoder_kv" in parts)
    else:
        assert counts["attention_step_int8"] > 0 and counts["attention_step"] == 0
    np.testing.assert_array_equal(gpu_tokens.cpu().numpy(), cpu_tokens.numpy())


@pytest.mark.cuda
@pytest.mark.parametrize("mode", ["bf16", "int8"])
def test_quantized_detector_runs_on_card(mode):
    """MathDetector in bf16 and int8 on a seeded page: boxes on the card,
    loc/conf of a window near the CPU's (the gates of
    tests/test_torch_port_detect.py's quantized test, against the CPU)."""
    _need_card()
    from doc2tex_tpu_torch.detection.flow import SHIPPED_WEIGHTS, MathDetector
    from doc2tex_tpu_torch.tools.page_eval import synth_labelled_page

    page = synth_labelled_page(np.random.default_rng(35))[0]
    det = MathDetector(SHIPPED_WEIGHTS, quantize=mode)
    boxes, scores = det.detect_page(page)
    assert len(boxes) > 0 and np.all(scores >= det.conf_thresh)
    cpu = MathDetector(SHIPPED_WEIGHTS, quantize=mode, device="cpu")
    x = det.model_input(det.page_windows(page)[0][:2])
    with torch.inference_mode():
        got = [t.float().cpu() for t in det.ssd(x)]
        want = [t.float() for t in cpu.ssd(x.cpu())]
    for g, w in zip(got, want):
        assert (g - w).abs().max().item() <= 0.05 * w.abs().max().item()
