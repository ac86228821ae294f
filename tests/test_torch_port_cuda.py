"""The port on a CUDA card: both kernels and a decode with each head.

Every test here carries the ``cuda`` marker and skips without a card (the
kernel has no CPU mode).  The file imports neither jax nor the JAX package,
so it also runs on a machine that has only PyTorch:

    python -m pytest --noconftest -m cuda tests/test_torch_port_cuda.py
"""

from __future__ import annotations

import os
import sys

import numpy as np
import pytest
import torch

from doc2tex_tpu_torch.config import make_config
from doc2tex_tpu_torch.decode.runner import make_decode_fn
from doc2tex_tpu_torch.models import build_model
from doc2tex_tpu_torch.ops.attention_step import (
    COVERAGE, attention_step_reference, coverage_attention_step,
    coverage_attention_step_reference, fused_attention_step, launch_plan as b2_launch_plan)
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
def test_coverage_step_kernel_raises_on_what_it_does_not_take():
    """On the card the coverage form raises, before any launch, on a width
    the kernel is not built for, a conv wider than 5 taps, D != H and an S
    no plan holds; a CUDA error is not left behind."""
    _need_card()

    def inputs(Bs, K, S, D, H, Kl, taps):
        z = lambda *shape: torch.zeros(*shape, device="cuda")  # noqa: E731
        return dict(enc=z(Bs, S, D), enc_proj=z(Bs, S, H), q=z(Bs * K, H), mem=z(Bs * K, S),
                    loc_conv_w=z(taps, 1, Kl), loc_conv_b=z(Kl), w_loc=z(Kl, H), b_loc=z(H),
                    w_score=z(H))

    for args in ((1, 5, 10, 64, 64, 16, 5), (1, 5, 10, 128, 128, 16, 7),
                 (1, 5, 10, 128, 256, 16, 5), (1, 16, 2_000_000, 128, 128, 64, 5)):
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
