"""The port's bfloat16 arithmetic against the JAX package's, on the CPU.

bfloat16 results depend on where each value is rounded.  These tests hold
the port to the JAX modules' rounding points, where the same inputs and
weights go through both:

- single modules (a ResNet ConvBN, the ViT Mlp and self-attention): the
  port's bfloat16 outputs equal JAX's except for rare one-ulp flips from
  another summation order (< 1 % of the values, each within 1 % of the
  value);
- the decoder heads from one shared encoder memory, three steps: the LSTM
  head's logits within 1e-5 of JAX's (it computes in float32 around its
  bfloat16 memory), the TFM head's within a tenth of the bfloat16 effect
  itself (mean |port - jax| < 0.1 x mean |jax bf16 - jax f32|).

Across a whole encoder the rare flips of a deep ResNet grow into ordinary
bfloat16 noise, so the encoder as a whole is not compared here.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from doc2tex_tpu.config import make_config as jax_make_config
from doc2tex_tpu.models import build_model as jax_build_model
from doc2tex_tpu.models.layers import Mlp as JaxMlp
from doc2tex_tpu.models.layers import SelfAttention as JaxSelfAttention
from doc2tex_tpu.models.resnet import ConvBN as JaxConvBN
from doc2tex_tpu_torch.config import make_config
from doc2tex_tpu_torch.models import build_model
from doc2tex_tpu_torch.models.layers import Mlp, SelfAttention
from doc2tex_tpu_torch.models.resnet import ConvBN
from doc2tex_tpu_torch.weights import load_variables
import test_torch_port_lstm as lstm_tests
import test_torch_port_model as tfm_tests
from torch_port_threads import one_torch_thread  # noqa: F401

BF16 = torch.bfloat16


def _agree(ours: torch.Tensor, ref, what: str) -> None:
    """bfloat16 outputs equal but for < 1 % one-ulp flips."""
    a, b = ours.float().numpy(), np.asarray(ref.astype(jnp.float32))
    assert a.shape == b.shape, what
    differ = a != b
    assert differ.mean() < 0.01, f"{what}: {differ.mean():.3%} of values differ"
    np.testing.assert_allclose(a, b, rtol=1e-2, atol=1e-6, err_msg=what)


def _module_pair(jax_module, port_module, x, seed):
    shapes = jax.eval_shape(lambda: jax_module.init(jax.random.PRNGKey(0), x))
    variables = tfm_tests._random_variables(dict(shapes), np.random.default_rng(seed))
    load_variables(port_module, variables)
    return jax_module.apply(jax.tree_util.tree_map(jnp.asarray, variables), x)


def test_convbn_rounds_like_flax():
    """flax's BatchNorm computes in float32 and rounds once."""
    x = np.random.default_rng(0).normal(size=(2, 16, 24, 8)).astype(np.float32)
    port = ConvBN(8, 32, dtype=BF16)
    ref = _module_pair(JaxConvBN(32, dtype=jnp.bfloat16), port,
                       jnp.asarray(x).astype(jnp.bfloat16), seed=1)
    with torch.no_grad():
        ours = port(torch.from_numpy(x).to(BF16).permute(0, 3, 1, 2)).permute(0, 2, 3, 1)
    _agree(ours, ref, "ConvBN")


def test_mlp_and_attention_round_like_jax():
    """The gelu rounds op by op, and constants are rounded to bfloat16."""
    x = np.random.default_rng(2).normal(size=(2, 40, 64)).astype(np.float32)
    for jmod, port in ((JaxMlp(128, 64, dtype=jnp.bfloat16), Mlp(64, 128, BF16)),
                       (JaxSelfAttention(64, 2, dtype=jnp.bfloat16), SelfAttention(64, 2, BF16))):
        ref = _module_pair(jmod, port, jnp.asarray(x), seed=3)
        with torch.no_grad():
            ours = port(torch.from_numpy(x))
        _agree(ours, ref, type(port).__name__)


@pytest.mark.parametrize("head", ["TFM", "Attnv2"])
def test_decoder_logits_from_shared_memory(head):
    """Both heads in bfloat16 from the same float32 encoder memory: three
    steps of logits against JAX's (tolerances in the module docstring)."""
    tests = tfm_tests if head == "TFM" else lstm_tests
    bucket = tfm_tests.BUCKETS[1] if head == "TFM" else lstm_tests.BUCKET
    V = tests.V
    x = tfm_tests._normalized(tfm_tests._images(bucket, 4, seed=2))
    jmodel32 = jax_build_model(jax_make_config(tests.tiny_config()), V)
    shapes = jax.eval_shape(
        lambda: jmodel32.init(jax.random.PRNGKey(0), jnp.zeros((1, *bucket, 1)),
                              jnp.zeros((1, 41), jnp.int32), train=False))
    variables = tfm_tests._random_variables(dict(shapes), np.random.default_rng(0))
    jv = jax.tree_util.tree_map(jnp.asarray, variables)
    memory = np.array(jax.jit(lambda v, x: jmodel32.apply(v, x, method="encode"))(
        jv, jnp.asarray(x)))
    K, T = 3, 6
    logits = {}
    for dtype in ("float32", "bfloat16"):
        cfg = tests.tiny_config()
        cfg["dtype"] = dtype
        jmodel = jax_build_model(jax_make_config(cfg), V)
        port = build_model(make_config(cfg), V).eval()
        load_variables(port, variables)
        jmem = jnp.asarray(memory).astype(jnp.bfloat16 if dtype == "bfloat16" else jnp.float32)
        jstate = jax.jit(lambda v, e: jmodel.apply(v, e, T, K, method="init_decode_state"))(
            jv, jmem)
        jstep = jax.jit(lambda v, s, t: jmodel.apply(v, s, t, method="decode_step"))
        with torch.no_grad():
            pstate = port.init_decode_state(torch.from_numpy(memory).to(port.dtype), T, K)
        rng = np.random.default_rng(3)
        out = []
        for _ in range(3):
            tokens = rng.integers(1, V, (4 * K,)).astype(np.int32)
            jstate, jl = jstep(jv, jstate, jnp.asarray(tokens))
            with torch.no_grad():
                pstate, pl = port.decode_step(pstate, torch.from_numpy(tokens).long())
            out.append((np.asarray(jl), pl.numpy()))
        logits[dtype] = [np.stack(z) for z in zip(*out)]
    (j16, p16), (j32, _) = logits["bfloat16"], logits["float32"]
    if head == "TFM":
        effect = np.abs(j16 - j32).mean()
        assert effect > 0
        assert np.abs(p16 - j16).mean() < 0.1 * effect
    else:
        np.testing.assert_allclose(p16, j16, atol=1e-5, rtol=0)
