"""The port's int8 decoder memory (the ``decoder_mem`` and ``decoder_kv``
quantized parts; ``quantize: int8_full``) against the JAX package, on the
CPU, at a tiny size.

- ``quantize_memory`` and ``quantize_kv`` equal JAX's (jitted) bit for bit,
  on float32 and bfloat16 inputs.
- The plain int8 ``decode_attention`` (masked self-attention and unmasked
  cross-attention, bfloat16 and float32 q), given the same int8 K/V and
  scales as JAX's ``_reference``: within 1e-6 in float32, and in bfloat16
  within 2e-2, the bf16 tolerance B1 is held to (``chip_smoke.TOL``; JAX
  rounds each q.k and P.V product to bf16 before its sum, the port sums
  exact products, so outputs of ~0.6 part by a few bf16 steps); bit for bit
  in bfloat16 on inputs that show both rounding points of the scaled
  probabilities (as ``tests/test_torch_port_decode_attention.py`` holds the
  float form).
- The LSTM head's int8 memory and steps (the plain int8 B2 step): the int8
  ``enc``/``enc_proj`` and their scales equal JAX's ``init_decode_state``
  under ``decoder_mem`` bit for bit, and four decode steps' logits and
  coverage within 1e-4 (float32) / 2e-2 (bfloat16) of JAX's.
- Tiny beam-5 decodes: ``int8_full`` (both heads) and the parts
  ``encoder, decoder_mem, decoder_kv`` (TFM) give JAX's tokens under
  ``quantized_inference(parts=...)``; the TFM decodes run through every
  chunk of ``grow_decode_state`` (the int8 caches' scales grow with them)
  with rows that never finish.
- ``int8_conv2d`` with dilation (SSD's conv6) equals JAX's
  ``int8_conv_general_dilated(rhs_dilation=...)`` bit for bit.
"""

from __future__ import annotations

import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import doc2tex_tpu.ops.quant as jq
from doc2tex_tpu.config import make_config as jax_make_config
from doc2tex_tpu.decode.runner import make_decode_fn as jax_make_decode_fn
from doc2tex_tpu.models import build_model as jax_build_model
from doc2tex_tpu.ops.decode_attention import _reference as jax_reference
from doc2tex_tpu_torch.config import make_config
from doc2tex_tpu_torch.decode.runner import make_decode_fn
from doc2tex_tpu_torch.models import build_model
from doc2tex_tpu_torch.ops import quant
from doc2tex_tpu_torch.ops.decode_attention import decode_attention
from doc2tex_tpu_torch.weights import load_variables
from test_torch_port_lstm import _images_apart
from test_torch_port_lstm import tiny_config as lstm_tiny_config
from test_torch_port_model import _images, _normalized, _random_variables
from test_torch_port_model import tiny_config as tfm_tiny_config
from torch_port_threads import one_torch_thread  # noqa: F401

DTYPES = {"float32": (jnp.float32, torch.float32), "bfloat16": (jnp.bfloat16, torch.bfloat16)}
FULL = ("encoder", "decoder_mem")
KV = ("encoder", "decoder_mem", "decoder_kv")


def _np(a) -> np.ndarray:
    return np.asarray(a.float() if torch.is_tensor(a) else jnp.asarray(a, jnp.float32))


# ---- (a) the quantizers ------------------------------------------------------

@pytest.mark.parametrize("dtype", list(DTYPES))
@pytest.mark.parametrize("fn", ["quantize_memory", "quantize_kv"])
def test_memory_quantizers_equal_jax(dtype, fn):
    rng = np.random.default_rng(7)
    x = (rng.normal(size=(3, 17, 4, 32)) * 2).astype(np.float32)
    x[1] = 0.0                              # a zero sample: the 1e-8 floor
    x[2, 3, 1] = 0.0                        # a zero vector
    if fn == "quantize_memory":
        x = x.reshape(3, 17, 128)
    jdt, tdt = DTYPES[dtype]
    jv, js = jax.jit(getattr(jq, fn))(jnp.asarray(x).astype(jdt))
    tv, ts = getattr(quant, fn)(torch.from_numpy(x).to(tdt))
    assert tv.dtype == torch.int8 and ts.dtype == torch.float32
    assert tuple(ts.shape) == js.shape == ((3, 1, 1) if fn == "quantize_memory" else (3, 17, 4))
    np.testing.assert_array_equal(tv.numpy(), np.asarray(jv))
    np.testing.assert_array_equal(ts.numpy(), np.asarray(js))
    if fn == "quantize_memory":
        np.testing.assert_array_equal(quant.dequantize_memory(tv, ts).numpy(),
                                      np.asarray(jq.dequantize_memory(jv, js)))


# ---- (b) the plain int8 decode attention ---------------------------------------

def _int8_attention_inputs(masked: bool, B=2, K=5, M=45, nh=4, hd=32, seed=0):
    """q (float32) and int8 K/V with their scales from JAX's quantize_kv,
    and a random ancestry-like mask (every row attends somewhere)."""
    rng = np.random.default_rng(seed)
    q = (rng.normal(size=(B, K, nh, hd)) / hd ** 0.5).astype(np.float32)
    k8, ks = jq.quantize_kv(jnp.asarray(rng.normal(size=(B, M, nh, hd)).astype(np.float32)))
    v8, vs = jq.quantize_kv(jnp.asarray(rng.normal(size=(B, M, nh, hd)).astype(np.float32)))
    mask = None
    if masked:
        mask = rng.random((B, K, M)) < 0.4
        mask[:, :, 0] = True
    return q, *(np.array(a) for a in (k8, v8, ks, vs)), mask


@pytest.mark.parametrize("dtype", list(DTYPES))
@pytest.mark.parametrize("masked", [True, False])
def test_int8_decode_attention_plain_version_matches_jax_reference(dtype, masked):
    q, k8, v8, ks, vs, mask = _int8_attention_inputs(masked, seed=int(masked))
    jdt, tdt = DTYPES[dtype]
    want = jax_reference(jnp.asarray(q).astype(jdt), jnp.asarray(k8), jnp.asarray(v8),
                         None if mask is None else jnp.asarray(mask),
                         k_scale=jnp.asarray(ks), v_scale=jnp.asarray(vs))
    got = decode_attention(torch.from_numpy(q).to(tdt), torch.from_numpy(k8),
                           torch.from_numpy(v8), None if mask is None else torch.from_numpy(mask),
                           torch.from_numpy(ks), torch.from_numpy(vs))
    assert got.dtype == tdt and want.dtype == jdt
    want = _np(want)
    np.testing.assert_allclose(_np(got), want, atol=1e-6 if dtype == "float32" else 2e-2,
                               rtol=0)


@pytest.mark.parametrize("n,v8,v_scale", [(3, 100, 0.0123), (7, 127, 0.0917), (3, 55, 0.0457)])
def test_int8_decode_attention_rounds_where_the_reference_does(n, v8, v_scale):
    """q = 0, so the n attended positions score alike and p = 1/n; V is
    ``v8`` at position 0 (scale ``v_scale``) and 0 elsewhere.  Every output
    element is round(round(round(1/n) * round(v_scale)) * v8) in bf16: the
    same bits as JAX's, and not those of the product kept in float32."""
    B, K, nh, hd, M = 1, 2, 2, 32, n
    q = torch.zeros(B, K, nh, hd, dtype=torch.bfloat16)
    k8 = torch.from_numpy(np.random.default_rng(n).integers(-127, 128, (B, M, nh, hd)).astype(
        np.int8))
    v = torch.zeros(B, M, nh, hd, dtype=torch.int8)
    v[:, 0] = v8
    ks = torch.full((B, M, nh), 0.01)
    vs = torch.full((B, M, nh), v_scale)
    got = decode_attention(q, k8, v, None, ks, vs).float().numpy()
    want = _np(jax_reference(jnp.asarray(q.float().numpy()).astype(jnp.bfloat16),
                             *(jnp.asarray(t.numpy()) for t in (k8, v)), None,
                             k_scale=jnp.asarray(ks.numpy()), v_scale=jnp.asarray(vs.numpy())))
    np.testing.assert_array_equal(got, want)
    f32 = np.float32(1.0 / n) * np.float32(v_scale) * np.float32(v8)
    assert not np.array_equal(got, np.full_like(got, torch.tensor(f32).bfloat16().item()))


def test_int8_decode_attention_refuses_half_given_scales():
    q, k8, v8, ks, vs, _ = _int8_attention_inputs(False)
    q, k8, v8, ks, vs = (torch.from_numpy(a.copy()) for a in (q, k8, v8, ks, vs))
    with pytest.raises(ValueError, match="together"):
        decode_attention(q, k8, v8, None, ks, None)
    with pytest.raises(TypeError, match="int8"):
        decode_attention(q, k8.float(), v8.float(), None, ks, vs)
    with pytest.raises(TypeError, match="int8"):
        decode_attention(q.half(), k8, v8, None, ks, vs)


# ---- (c) the LSTM head's int8 memory and the plain int8 B2 step -----------------

LSTM_STEP_TOL = {"float32": 1e-4, "bfloat16": 2e-2}


@pytest.mark.parametrize("dtype", list(DTYPES))
def test_lstm_int8_memory_and_steps_match_jax(dtype):
    """init_decode_state under decoder_mem: int8 memory and scales equal
    JAX's (the port's sample row b is JAX's beam-repeated row b*K); four
    steps with a beam reorder after each: logits and coverage close."""
    from doc2tex_tpu.decode.beam import lstm_gather as jax_gather
    from doc2tex_tpu_torch.decode.beam import lstm_gather

    cfg = lstm_tiny_config(dtype)
    jmodel, variables, port = _pair(cfg, 24, seed=5, parts=("decoder_mem",))
    B, K = 2, 3
    x = _normalized(_images((32, 64), B, seed=2))
    with jq.quantized_inference(parts=("decoder_mem",)):
        jenc = jax.jit(lambda v, x: jmodel.apply(v, x, method="encode"))(variables, jnp.asarray(x))
        jstate = jax.jit(lambda v, e: jmodel.apply(v, e, 41, K, method="init_decode_state"))(
            variables, jenc)
        jstep = jax.jit(lambda v, s, t: jmodel.apply(v, s, t, method="decode_step"))
        with torch.no_grad():
            pstate = port.init_decode_state(torch.from_numpy(np.array(jenc, np.float32)), 41, K)
        for name in ("enc", "enc_proj", "enc_scale", "proj_scale"):
            got, want = getattr(pstate, name), np.asarray(getattr(jstate, name))
            assert got.dtype == (torch.int8 if name.startswith("enc") and "scale" not in name
                                 else torch.float32), name
            np.testing.assert_array_equal(_np(got), want[::K].astype(np.float32), err_msg=name)
        rng = np.random.default_rng(3)
        tokens = np.zeros(B * K, np.int32)
        tol = LSTM_STEP_TOL[dtype]
        for _ in range(4):
            jstate, jlogits = jstep(variables, jstate, jnp.asarray(tokens))
            with torch.no_grad():
                pstate, plogits = port.decode_step(pstate, torch.from_numpy(tokens).long())
            np.testing.assert_allclose(plogits.numpy(), np.asarray(jlogits), atol=tol, rtol=0)
            np.testing.assert_allclose(pstate.alpha_cum.numpy(), np.asarray(jstate.alpha_cum),
                                       atol=tol, rtol=0)
            beam_idx = rng.integers(0, K, (B, K)).astype(np.int32)
            jstate = jax_gather(jstate, jnp.asarray(beam_idx), B, K)
            pstate = lstm_gather(pstate, torch.from_numpy(beam_idx).long(), B, K)
            tokens = rng.integers(3, 24, B * K).astype(np.int32)


# ---- (d) tiny beam decodes ------------------------------------------------------

def _pair(cfg: dict, vocab: int, seed: int, parts, end_bias=None):
    """(jax model, jax variables, port model with ``parts``) sharing random
    weights; ``end_bias`` = (bias name, end token, value)."""
    jmodel = jax_build_model(jax_make_config(cfg), vocab)
    shapes = jax.eval_shape(
        lambda: jmodel.init(jax.random.PRNGKey(0), jnp.zeros((1, 32, 64, 1)),
                            jnp.zeros((1, 41), jnp.int32), train=False))
    variables = _random_variables(dict(shapes), np.random.default_rng(seed))
    if end_bias is not None:
        name, end, value = end_bias
        variables["params"]["predicter"][name][end] = value
    port = build_model(make_config(cfg), vocab).eval()
    load_variables(port, variables)
    port.set_quantize(parts)
    return jmodel, jax.tree_util.tree_map(jnp.asarray, variables), port


@pytest.mark.parametrize("family,parts", [("Attnv2", FULL), ("TFM", FULL), ("TFM", KV)])
def test_tiny_beam_decode_int8_memory_tokens_equal_jax(family, parts):
    """Beam 5 over 6 crops: the port's tokens equal JAX's under
    ``quantized_inference(parts)``; the TFM decode grows its caches (and
    int8 caches' scales) over 5 chunks to 41 steps, some rows finishing
    and some never."""
    from doc2tex_tpu_torch.decode import runner

    if family == "TFM":
        cfg, seed, end_bias = tfm_tiny_config(), 0, ("b_proj", 2, 0.6)
    else:
        cfg, seed, end_bias = lstm_tiny_config(), 5, ("b_gen", 1, -0.15)
    jmodel, variables, port = _pair(cfg, 24, seed=seed, parts=parts, end_bias=end_bias)
    assert port.quant_parts == parts
    assert port.predicter.quant_parts == tuple(p for p in parts if p != "encoder")
    images = _images_apart(6, seed=4)
    jfn = jax_make_decode_fn(jmodel, jax_make_config(cfg), beam_size=5, jit=True)
    with jq.quantized_inference(parts=parts):
        jtok = np.asarray(jfn(variables, jnp.asarray(images))[0])
    grown = []
    real_grow = runner.grow_decode_state

    def grow(state, new_steps, beam_size):
        state = real_grow(state, new_steps, beam_size)
        grown.append([tuple(s.shape) for s in state.k_scales])
        return state

    runner.grow_decode_state = grow
    try:
        ptok, _ = make_decode_fn(port, make_config(cfg), beam_size=5, device="cpu")(images)
    finally:
        runner.grow_decode_state = real_grow
    np.testing.assert_array_equal(ptok.numpy(), jtok)
    assert len({tuple(r) for r in jtok}) > 1
    if family == "TFM":
        ended = (jtok == 2).any(axis=1)      # [s] = 2: some rows finish, some never
        assert ended.any() and not ended.all()
        assert len(grown) == 4
        if "decoder_kv" in parts:      # 2 layers of (6, slots, nh 2) scales per chunk
            assert [g[0] for g in grown] == [(6, n * 5, 2) for n in (18, 27, 36, 41)]
        else:
            assert all(g == [] for g in grown)


def test_decoder_kv_state_is_int8_and_grows_with_zero_scales():
    """init_state under decoder_kv: int8 caches with zero (B, cap*K, nh)
    scales, int8 cross memory with (B, S, nh) scales; a step writes its rows'
    scales at slot t*K; grow_decode_state pads caches and scales with zeros."""
    from doc2tex_tpu_torch.models.decoder_tfm import grow_decode_state

    port = build_model(make_config(tfm_tiny_config()), 24).eval()
    port.set_quantize(KV)
    with torch.no_grad():
        memory = torch.randn(2, 33, 64)
        state = port.init_decode_state(memory, 41, 3, live_steps=9)
        assert all(c.dtype == torch.int8 and c.shape == (2, 27, 2, 32) for c in state.k_cache)
        assert all(m.dtype == torch.int8 for m in state.k_mem + state.v_mem)
        assert [tuple(s.shape) for s in state.k_mem_scales] == [(2, 33, 2)] * 2
        assert all(s.shape == (2, 27, 2) and not s.any() for s in state.k_scales + state.v_scales)
        state, _ = port.decode_step(state, torch.ones(6, dtype=torch.long))
        assert all(s[:, :3].all() and not s[:, 3:].any() for s in state.k_scales + state.v_scales)
        grown = grow_decode_state(state, 18, 3)
        assert all(s.shape == (2, 54, 2) and not s[:, 3:].any() for s in grown.v_scales)
        assert all(c.shape == (2, 54, 2, 32) and c.dtype == torch.int8 for c in grown.v_cache)


# ---- (e) int8 convolution with dilation ----------------------------------------

@pytest.mark.parametrize("dtype", list(DTYPES))
@pytest.mark.parametrize("dilation,pad", [(2, 2), (6, 6)])
def test_dilated_int8_conv_equals_jax(dtype, dilation, pad):
    """SSD's conv6 form (3x3, dilation 6, pad 6) and a dilation of 2: the
    port's int8_conv2d and the detector's Conv2d with the int8 flag against
    JAX's int8_conv_general_dilated(rhs_dilation=...) (+ bias), bit for bit."""
    from doc2tex_tpu_torch.detection.ssd import Conv2d

    rng = np.random.default_rng(dilation)
    cin, cout = 64, 128
    x = rng.normal(size=(2, 15, 14, cin)).astype(np.float32)
    w = (rng.normal(size=(3, 3, cin, cout)) * 0.05).astype(np.float32)
    b = (rng.normal(size=(cout,)) * 0.1).astype(np.float32)
    jdt, tdt = DTYPES[dtype]
    dn = ("NHWC", "HWIO", "NHWC")
    op = lambda a, k: jq.int8_conv_general_dilated(  # noqa: E731
        a, k, (1, 1), ((pad, pad), (pad, pad)), rhs_dilation=(dilation, dilation),
        dimension_numbers=dn)
    jx, jw = jnp.asarray(x).astype(jdt), jnp.asarray(w).astype(jdt)
    want = _np(jax.jit(op)(jx, jw))
    tx = torch.from_numpy(x).to(tdt).permute(0, 3, 1, 2)
    layer = Conv2d(cin, cout, padding=(pad, pad), dilation=dilation)
    with torch.no_grad():
        layer.kernel.copy_(torch.from_numpy(w).permute(3, 2, 0, 1))
        layer.bias.copy_(torch.from_numpy(b))
    layer.dtype, layer.int8 = tdt, True
    assert layer.takes_int8()
    with torch.inference_mode():
        w_q, w_scale = quant.quantize_conv_weight(layer.kernel, tdt)
        got = quant.int8_conv2d(tx, w_q, w_scale, None, (3, 3), (1, 1), (pad, pad), tdt,
                                (dilation, dilation)).permute(0, 2, 3, 1)
        with_bias = layer(tx).permute(0, 2, 3, 1)
    assert got.shape == want.shape
    np.testing.assert_array_equal(_np(got), want)
    want_b = _np(jax.jit(lambda a, k: op(a, k) + jnp.asarray(b).astype(jdt))(jx, jw))
    np.testing.assert_allclose(_np(with_bias), want_b, rtol=2.4e-7 if dtype == "float32" else 0,
                               atol=1e-7 if dtype == "float32" else 0)


def jax_int8_accuracy_eval(argv) -> None:
    """The JAX package's ``tools/int8_accuracy_eval.py`` with ``argv``, on
    the CPU, its int8 convolutions through ``exact_int8_conv`` (the same
    integers; XLA's own int8 convolution is very slow on the CPU): the
    reference rows of the port's twin.  Not part of the tests."""
    import runpy
    import sys

    from test_torch_port_detect import exact_int8_conv

    jax.config.update("jax_platforms", "cpu")
    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    sys.argv = ["int8_accuracy_eval.py"] + list(argv)
    with exact_int8_conv():
        runpy.run_path(os.path.join(root, "tools", "int8_accuracy_eval.py"), run_name="__main__")


if __name__ == "__main__":
    import sys

    if sys.argv[1:2] != ["--jax-int8-accuracy-eval"]:
        sys.exit("usage: PYTHONPATH=.:tests python tests/test_torch_port_quant_decoder.py "
                 "--jax-int8-accuracy-eval [the tool's flags]")
    jax_int8_accuracy_eval(sys.argv[2:])
