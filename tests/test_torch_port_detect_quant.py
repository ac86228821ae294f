"""The quantized detector against the JAX package, on the CPU.

- ``MathDetector(quantize="bf16")`` and ``"int8"`` on one seeded window
  against JAX's SSD under the same mode (tolerances at the test), nearer to
  JAX's outputs in that mode than the float32 outputs are;
- the golden writer's exact int8 convolution
  (``test_torch_port_detect.exact_int8_conv``) against XLA's.

The bf16 and int8 golden pages are written with ``PYTHONPATH=. python
tests/test_torch_port_detect.py --write-golden-pages-quant``.
"""

from __future__ import annotations

import contextlib
import os
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from doc2tex_tpu_torch.detection.flow import SHIPPED_WEIGHTS, MathDetector

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
from test_torch_port_detect import exact_int8_conv  # noqa: E402
from torch_port_threads import one_torch_thread  # noqa: E402,F401


# loc/conf of the quantized SSD against JAX's in the same mode, on the
# seeded window: relative to each output's largest magnitude (loc ~4.7,
# conf ~17).  bf16: every convolution rounds its output to bf16 (2^-8
# relative) and the two packages' convolutions sum in other orders, so the
# outputs part by a few units in the last place over 22 layers; the port
# measured 3.3e-3 (loc) and 7.3e-3 (conf) of the largest magnitude.  int8:
# the products are exact in both, but a float32 layer that differs in its
# last bit (the first two convolutions and the heads stay float32) can put
# an activation on the other side of a rounding boundary: one quantization
# step, ~1 % of its tensor's abs-max, which the next layers carry; the port
# measured 1.7e-2 (loc) and 6.5e-3 (conf).  In both modes the port's
# outputs must lie nearer to JAX's in that mode than the port's float32
# outputs do, so a mode that silently ran in float32 fails: the mean error
# was 0.45 (loc) and 0.09 (conf) of the float32 outputs' from JAX's bf16
# ones, and 0.49 and 0.48 from JAX's int8 ones.  The gates are about 3
# times the measured errors, and the mean at 0.75.
SSD_QUANT_TOL = {"bf16": 0.02, "int8": 0.05}


@pytest.mark.parametrize("mode", ["bf16", "int8"])
def test_ssd512_quantized_matches_jax(mode):
    """SSD512 under ``quantize`` bf16 (bfloat16 compute, float32 weights)
    and int8 (the gated convolutions through the int8 op) on the seeded
    window: loc and conf within SSD_QUANT_TOL of the largest magnitude of
    JAX's in the same mode, and nearer to JAX's in that mode than the
    float32 outputs are."""
    from doc2tex_tpu.detection.flow import MathDetector as JaxDetector
    from doc2tex_tpu.ops.quant import quantized_inference

    x = (np.random.default_rng(0).integers(0, 256, (1, 512, 512, 3)).astype(np.float32)
         - np.float32(246))
    jdet = JaxDetector(weights_path=SHIPPED_WEIGHTS, quantize=mode)
    with exact_int8_conv(), (quantized_inference() if mode == "int8"
                             else contextlib.nullcontext()):
        want = [np.asarray(w, np.float32)
                for w in jax.jit(jdet.model.apply)(jdet.variables, jnp.asarray(x))]
    tdet = MathDetector(SHIPPED_WEIGHTS, quantize=mode, device="cpu")
    xt = torch.from_numpy(x).permute(0, 3, 1, 2).contiguous()
    with torch.inference_mode():
        got = [g.float().numpy() for g in tdet.model(xt)]
        tdet.model.set_quantize(None)
        plain = [g.numpy() for g in tdet.model(xt)]
    assert got[0].shape == (1, 65532, 4) and got[1].shape == (1, 65532, 2)
    for g, w, f in zip(got, want, plain):
        top = np.abs(w).max()
        np.testing.assert_allclose(g, w, atol=SSD_QUANT_TOL[mode] * top, rtol=0)
        assert np.abs(g - w).mean() < 0.75 * np.abs(f - w).mean()  # the mode is in effect


def test_exact_int8_conv_equals_jax_int8_conv():
    """The golden writer's exact convolution gives XLA's int8 integers."""
    import doc2tex_tpu.ops.quant as jq

    rng = np.random.default_rng(3)
    x = jnp.asarray(rng.normal(size=(2, 11, 13, 300)).astype(np.float32))
    w = jnp.asarray(rng.normal(size=(3, 3, 300, 128)).astype(np.float32) * 0.05)
    dn = ("NHWC", "HWIO", "NHWC")
    op = lambda a, k: jq.int8_conv_general_dilated(a, k, (1, 1), "SAME", rhs_dilation=(2, 2),
                                                   dimension_numbers=dn)
    want = np.asarray(jax.jit(op)(x, w))
    with exact_int8_conv():
        got = np.asarray(jax.jit(op)(x, w))
    np.testing.assert_array_equal(got, want)
