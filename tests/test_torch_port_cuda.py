"""The port on a CUDA card: the decode attention kernel and a decode.

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
