"""The port on a CUDA card: both kernels and a decode with each head.

Every test here carries the ``cuda`` marker and skips without a card (the
kernel has no CPU mode).  The file imports neither jax nor the JAX package,
so it also runs on a machine that has only PyTorch:

    python -m pytest --noconftest -m cuda tests/test_torch_port_cuda.py
"""

from __future__ import annotations

import numpy as np
import pytest
import torch

from doc2tex_tpu_torch.config import make_config
from doc2tex_tpu_torch.decode.runner import make_decode_fn
from doc2tex_tpu_torch.models import build_model
from doc2tex_tpu_torch.ops.attention_step import attention_step_reference, fused_attention_step
from doc2tex_tpu_torch.ops.decode_attention import decode_attention, decode_attention_reference


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
    fit in shared memory, raise on the card; they never run the plain
    version."""
    _need_card()

    def inputs(S, D, Kl):
        z = lambda *shape: torch.zeros(*shape, device="cuda")  # noqa: E731
        return dict(enc=z(1, S, D), enc_proj=z(1, S, D), q=z(1, D), loc_feat=z(1, S, Kl),
                    w_loc=z(Kl, D), b_loc=z(D), w_score=z(D))

    for S, D, Kl in ((10, 64, 16), (100_000, 128, 64)):
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
    before = fused_attention_step.launches
    gpu_tokens, _ = make_decode_fn(model, cfg, beam_size=5, device="cuda")(images)
    assert fused_attention_step.launches > before
    np.testing.assert_array_equal(gpu_tokens.cpu().numpy(), cpu_tokens.numpy())
