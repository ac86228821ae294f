"""The port's int8 encoder (``ops/quant.py``) against the JAX package's.

- The ops, bit for bit against the JAX package's jitted ``_quantize``,
  ``int8_dot_general`` and ``int8_conv_general_dilated`` (jitted: the form
  every decode runs them in, where XLA turns ``max / 127.0`` into a product
  with the reciprocal), in float32 and bfloat16: per-tensor and
  per-channel scales with a zero column, a gated Dense shape, the
  convolution shapes of the encoder (3x3 SAME, conv4_1's k2 s(2,1) p(0,1),
  the 2x2 patch conv), and shapes below the gates, which keep the plain
  product in both packages.
- The layers the int8 op reaches at the release widths: the same weight
  shapes as the JAX package's trace of the encoder.
- Tiny models with the gates lowered (as ``tests/test_quant.py``'s
  ``no_gates`` does): encoder memory with every product in int8 within
  3 % of its abs-max of JAX's (float32; an activation that lands on a
  rounding boundary in one package moves one quantization step, about 1 %
  of its tensor's abs-max, in the other, and the next layers carry it),
  and beam-5 tokens equal for both head families.
- The flow: the batch snap's padding rows (copies of row 0) leave int8
  strings unchanged; ``int8_full`` runs, and unknown modes are refused.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import doc2tex_tpu.ops.quant as jq
from doc2tex_tpu.config import make_config as jax_make_config
from doc2tex_tpu.decode.runner import make_decode_fn as jax_make_decode_fn
from doc2tex_tpu.models import build_model as jax_build_model
from doc2tex_tpu_torch.config import make_config
from doc2tex_tpu_torch.data.synthetic import HARD_VOCAB_PATH, synth_hard_sample
from doc2tex_tpu_torch.decode.runner import make_decode_fn
from doc2tex_tpu_torch.models import build_model
from doc2tex_tpu_torch.models.layers import Dense
from doc2tex_tpu_torch.ops import quant
from doc2tex_tpu_torch.recognition import MathRecognition, load_recog_config
from doc2tex_tpu_torch.transforms.augment import normalize
from doc2tex_tpu_torch.weights import load_variables
from test_torch_port_lstm import _images_apart
from test_torch_port_lstm import tiny_config as lstm_tiny_config
from test_torch_port_model import _images, _normalized, _random_variables
from test_torch_port_model import tiny_config as tfm_tiny_config
from torch_port_threads import one_torch_thread  # noqa: F401

DTYPES = {"float32": (jnp.float32, torch.float32), "bfloat16": (jnp.bfloat16, torch.bfloat16)}
DENSE_DN = (((2,), (0,)), ((), ()))


@pytest.fixture
def no_gates(monkeypatch):
    """Both packages' shape gates at 1: every encoder product goes int8."""
    for module in (jq, quant):
        monkeypatch.setattr(module, "MIN_CONTRACT", 1)
        monkeypatch.setattr(module, "MIN_OUT", 1)


def _pair(x: np.ndarray, dtype: str):
    jdt, tdt = DTYPES[dtype]
    return jnp.asarray(x).astype(jdt), torch.from_numpy(x).to(tdt)


def _np(a) -> np.ndarray:
    return np.asarray(a.float() if torch.is_tensor(a) else jnp.asarray(a, jnp.float32))


@pytest.mark.parametrize("dtype", list(DTYPES))
@pytest.mark.parametrize("per_channel", [False, True])
def test_quantize_equals_jax(dtype, per_channel):
    rng = np.random.default_rng(1)
    x = (rng.normal(size=(64, 96)) * 3).astype(np.float32)
    x[:, 7] = 0.0                       # a zero column: its scale is the 1e-8 floor
    jx, tx = _pair(x, dtype)
    axes = (0,) if per_channel else None
    jv, js = jax.jit(jq._quantize, static_argnums=1)(jx, axes)
    tv, ts = quant.quantize(tx, dims=0 if per_channel else None)
    assert tv.dtype == torch.int8 and ts.dtype == torch.float32
    np.testing.assert_array_equal(tv.numpy(), np.asarray(jv))
    np.testing.assert_array_equal(ts.numpy().reshape(np.shape(js)), np.asarray(js))
    if per_channel:
        assert ts[0, 7].item() == np.float32(1e-8) and not tv[:, 7].any()


@pytest.mark.parametrize("dtype", list(DTYPES))
@pytest.mark.parametrize("shape", [(2, 37, 256, 384), (2, 9, 128, 384), (2, 9, 256, 64)],
                         ids=["gated", "contract_below", "out_below"])
def test_dense_equals_jax_int8_dot_general(dtype, shape):
    """The port's int8 op against JAX's ``int8_dot_general`` on the same
    kernel in the compute type, and its Dense with the int8 flag against
    ``int8_dot_general`` + bias: equal bits where the gates pass (in
    float32 XLA fuses the rescale and the bias add into one multiply-add,
    so there the Dense's result is within one rounding of JAX's); below
    them both keep the plain product (the port exactly its unquantized
    Dense)."""
    B, N, K, O = shape
    rng = np.random.default_rng(K + O)
    x = (rng.normal(size=(B, N, K)) * 2).astype(np.float32)
    w = (rng.normal(size=(K, O)) * 0.05).astype(np.float32)
    w[:, 3] = 0.0
    b = (rng.normal(size=(O,)) * 0.1).astype(np.float32)
    jdt, tdt = DTYPES[dtype]
    dense = Dense(K, O, dtype=tdt)
    with torch.no_grad():
        dense.kernel.copy_(torch.from_numpy(w))
        dense.bias.copy_(torch.from_numpy(b))
    jx, tx = _pair(x, dtype)
    jw = jnp.asarray(w).astype(jdt)
    op = jax.jit(lambda a, k: jq.int8_dot_general(a, k, DENSE_DN))(jx, jw)
    want = jax.jit(lambda a, k: jq.int8_dot_general(a, k, DENSE_DN)
                   + jnp.asarray(b).astype(jdt))(jx, jw)
    plain = jax.jit(lambda a, k: jax.lax.dot_general(a, k, DENSE_DN))(jx, jw)
    dense.int8 = True
    with torch.inference_mode():
        got = dense(tx)
        dense.int8 = False
        unquantized = dense(tx)
    assert got.dtype == tdt and tuple(got.shape) == (B, N, O)
    if quant.gated(K, O):
        with torch.inference_mode():
            np.testing.assert_array_equal(
                _np(quant.int8_linear(tx, *quant.quantize_weight(dense.kernel, tdt), None, tdt)),
                _np(op))
        if dtype == "float32":
            np.testing.assert_allclose(_np(got), _np(want), rtol=2.4e-7, atol=1e-7)
        else:
            np.testing.assert_array_equal(_np(got), _np(want))
    else:
        assert torch.equal(got, unquantized)
        # JAX's op falls through to lax.dot_general, exactly
        np.testing.assert_array_equal(_np(jax.jit(lambda a, k: jq.int8_dot_general(
            a, k, DENSE_DN))(jx, jw)), _np(plain))


CONVS = {  # kernel, stride, padding (top/bottom, left/right), cin, cout
    "3x3_same": ((3, 3), (1, 1), (1, 1), 64, 128),
    "conv4_1": ((2, 2), (2, 1), (0, 1), 128, 128),
    "patch": ((2, 2), (2, 2), (0, 0), 128, 256),
    "below_gate": ((3, 3), (1, 1), (1, 1), 16, 128),
}


@pytest.mark.parametrize("dtype", list(DTYPES))
@pytest.mark.parametrize("conv", list(CONVS))
def test_conv_equals_jax_int8_conv(dtype, conv):
    """The port's int8 convolution (NCHW, OIHW) against JAX's
    ``int8_conv_general_dilated`` (NHWC, HWIO), and its Conv with the int8
    flag against that + bias, as the Dense test holds them (the patch conv
    at a grid of 5 x 6 patches)."""
    from doc2tex_tpu_torch.models.resnet import Conv

    kernel, stride, pad, cin, cout = CONVS[conv]
    rng = np.random.default_rng(cin + cout)
    x = rng.normal(size=(2, 10, 12, cin)).astype(np.float32)
    w = (rng.normal(size=(*kernel, cin, cout)) * 0.05).astype(np.float32)
    w[..., 5] = 0.0
    b = (rng.normal(size=(cout,)) * 0.1).astype(np.float32)
    jdt, tdt = DTYPES[dtype]
    layer = Conv(cin, cout, kernel, stride, pad, bias=True, dtype=tdt)
    with torch.no_grad():
        layer.kernel.copy_(torch.from_numpy(w).permute(3, 2, 0, 1))
        layer.bias.copy_(torch.from_numpy(b))
    jx, tx = _pair(x, dtype)
    jw = jnp.asarray(w).astype(jdt)
    padding = tuple((p, p) for p in pad)
    dn = ("NHWC", "HWIO", "NHWC")
    op = jax.jit(lambda a, k: jq.int8_conv_general_dilated(
        a, k, stride, padding, dimension_numbers=dn))(jx, jw)
    want = jax.jit(lambda a, k: jq.int8_conv_general_dilated(
        a, k, stride, padding, dimension_numbers=dn) + jnp.asarray(b).astype(jdt))(jx, jw)
    layer.int8 = True
    with torch.inference_mode():
        got = layer(tx.permute(0, 3, 1, 2)).permute(0, 2, 3, 1)
        w_q, w_scale = quant.quantize_conv_weight(layer.kernel, tdt)
        got_op = quant.int8_conv2d(tx.permute(0, 3, 1, 2), w_q, w_scale, None, kernel, stride,
                                   pad, tdt).permute(0, 2, 3, 1)
    assert got.dtype == tdt and tuple(got.shape) == want.shape
    if layer.takes_int8():
        np.testing.assert_array_equal(_np(got_op), _np(op))
        if dtype == "float32":   # XLA fuses the rescale and the bias add (see the Dense test)
            np.testing.assert_allclose(_np(got), _np(want), rtol=2.4e-7, atol=1e-7)
        else:
            np.testing.assert_array_equal(_np(got), _np(want))
    else:
        assert conv == "below_gate"
        plain = jax.jit(lambda a, k: jax.lax.conv_general_dilated(
            a, k, stride, padding, dimension_numbers=dn) + jnp.asarray(b).astype(jdt))(jx, jw)
        np.testing.assert_allclose(_np(got), _np(plain), atol=1e-4 if dtype == "float32" else 0.1)


@pytest.mark.parametrize("version", ["synthetic", "synthetic_tfm_big"])
def test_int8_layers_are_the_reference_hook_sites(version, monkeypatch):
    """At the release widths the port's int8 layers quantize the same
    weight shapes as the JAX package's trace of the encoder under
    ``quantized_inference()``: the patch conv, the ResNet convolutions
    and the ViT Denses that pass the gates, nothing of the head."""
    from doc2tex_tpu.ops.quant import quantized_inference
    from doc2tex_tpu.recognition.flow import load_recog_config as jax_load

    seen = []
    real = jq._quantize

    def recording(x, axes):
        if axes is not None:            # the weight's per-channel scale
            seen.append(tuple(x.shape))
        return real(x, axes)

    monkeypatch.setattr(jq, "_quantize", recording)
    jcfg, _ = jax_load(version=version)
    jmodel = jax_build_model(jcfg, 10)
    with quantized_inference():
        jax.eval_shape(lambda: jmodel.init(jax.random.PRNGKey(0), jnp.zeros((1, 64, 128, 1)),
                                           jnp.zeros((1, 4), jnp.int32), train=False))
    cfg, _ = load_recog_config(version=version)
    model = build_model(cfg, 10)
    shapes = []
    for name, layer in model.seqmodeler.named_modules():
        if getattr(layer, "int8", False) and layer.takes_int8():
            k = layer.kernel
            shapes.append(tuple(k.shape) if k.dim() == 2 else tuple(k.permute(2, 3, 1, 0).shape))
    assert sorted(shapes) == sorted(seen)
    assert len(model.int8_layers) == len(seen) == {"synthetic": 23, "synthetic_tfm_big": 49}[version]
    assert not any(getattr(m, "int8", False) for m in model.predicter.modules())


def _tiny_pair(cfg: dict, vocab: int, seed: int, end_bias=None):
    """(jax model, jax variables, port model under int8) sharing random
    weights; ``end_bias`` = (bias name, end token, value) sets how often
    rows finish."""
    jmodel = jax_build_model(jax_make_config(cfg), vocab)
    shapes = jax.eval_shape(
        lambda: jmodel.init(jax.random.PRNGKey(0), jnp.zeros((1, 32, 64, 1)),
                            jnp.zeros((1, 41), jnp.int32), train=False))
    variables = _random_variables(dict(shapes), np.random.default_rng(seed))
    if end_bias is not None:
        name, end, value = end_bias
        variables["params"]["predicter"][name][end] = value
    port = build_model(make_config(dict(cfg, quantize="int8")), vocab).eval()
    load_variables(port, variables)
    return jmodel, jax.tree_util.tree_map(jnp.asarray, variables), port


def test_tiny_encoder_int8_matches_jax(no_gates):
    jmodel, variables, port = _tiny_pair(tfm_tiny_config(), 24, seed=0)
    from doc2tex_tpu_torch.models.resnet import Conv

    # every conv and Dense of the encoder
    assert len(port.int8_layers) == sum(isinstance(m, (Conv, Dense))
                                        for m in port.seqmodeler.modules()) == 41
    x = _normalized(_images((64, 128), 2, seed=1))
    with jq.quantized_inference():
        want = np.asarray(jax.jit(lambda v, x: jmodel.apply(v, x, method="encode"))(
            variables, jnp.asarray(x)))
    with torch.inference_mode():
        got = port.encode(torch.from_numpy(x)).numpy()
        port.set_quantize(None)
        unquantized = port.encode(torch.from_numpy(x)).numpy()
    # every product quantized, so a rounding-boundary flip in one layer
    # (one quantization step, ~1 % of its tensor's abs-max) carries into
    # the next: the port stays within 3 % of the memory's abs-max (3.3) of
    # JAX's int8 memory everywhere, and on average under half as far from
    # it as the unquantized memory is
    np.testing.assert_allclose(got, want, atol=0.1, rtol=0)
    assert np.abs(got - want).mean() < 0.5 * np.abs(unquantized - want).mean()


@pytest.mark.parametrize("family,gates", [("TFM", (512, 1)), ("Attnv2", (1, 1))])
def test_tiny_beam_decode_int8_tokens_equal_jax(family, gates, monkeypatch):
    """Beam-5 decodes of both head families under int8: the same tokens
    as the JAX package under quantized_inference().  The LSTM model runs
    every encoder product in int8 (all 37 layers); the TFM model the 16
    whose contraction reaches 512.  With all 41 of the TFM model's layers
    in int8 its random beams meet near-ties that a one-step rounding flip
    decides, and such flips come from float ops between the products
    differing in their last bit: JAX's own memory from a separate jit of
    ``encode``, fed to the port's decoder, already gives other tokens than
    JAX's fused decode."""
    for module in (jq, quant):
        monkeypatch.setattr(module, "MIN_CONTRACT", gates[0])
        monkeypatch.setattr(module, "MIN_OUT", gates[1])
    # the seeds of the float32 decode tests of each head; end biases at
    # which the rows decode apart
    if family == "TFM":
        cfg, seed, end_bias, n_int8 = tfm_tiny_config(), 0, ("b_proj", 2, 0.6), 16
    else:
        cfg, seed, end_bias, n_int8 = lstm_tiny_config(), 5, ("b_gen", 1, -0.15), 37
    jmodel, variables, port = _tiny_pair(cfg, 24, seed=seed, end_bias=end_bias)
    assert len(port.int8_layers) == n_int8
    images = _images_apart(6, seed=4)
    jfn = jax_make_decode_fn(jmodel, jax_make_config(cfg), beam_size=5, jit=True)
    with jq.quantized_inference():
        jtok = np.asarray(jfn(variables, jnp.asarray(images))[0])
    ptok, _ = make_decode_fn(port, make_config(cfg), beam_size=5, device="cpu")(images)
    np.testing.assert_array_equal(ptok.numpy(), jtok)
    assert len({tuple(r) for r in jtok}) > 1


def _tiny_recognizer(quantize="int8") -> MathRecognition:
    cfg = make_config(dict(
        lstm_tiny_config(), max_dimension=[64, 256], batch_max_length=12, quantize=quantize,
        clahe=False, bucket_growth=2.2, vocab=HARD_VOCAB_PATH))
    return MathRecognition(cfg, None, beam_size=3, device="cpu", seed=3)


def test_padding_rows_leave_int8_strings_unchanged(no_gates):
    """The batch snap pads 3 crops to 8 rows with copies of row 0: the
    per-tensor activation scales, and so the encoder memory of the 3 crops
    and their strings, equal those of the 3-row batch decoded as it is.
    Padding rows of other pixels move the scales and the memory."""
    rec = _tiny_recognizer()
    crops = [synth_hard_sample(np.random.default_rng(s), min_len=3, max_len=10, max_h=60,
                               max_w=120)[0] for s in range(3)]
    prepped = [rec._preprocess(c) for c in crops]
    bucket = max(rec.bucket_key(c) for c in crops)
    snapped = rec.make_batch(prepped, bucket)
    assert snapped.shape[0] == 8
    exact = snapped[:3]
    assert torch.equal(rec._decode(snapped)[0][:3], rec._decode(exact)[0])

    def memory(batch):
        with torch.inference_mode():
            return rec.model.encode(normalize(torch.from_numpy(batch)))[:3]

    np.testing.assert_allclose(memory(snapped), memory(exact), atol=1e-5, rtol=0)
    other = np.concatenate([exact, 255 - snapped[3:]])
    assert (memory(other) - memory(exact)).abs().max() > 0.05


@pytest.mark.parametrize("mode,error", [("int8_full", None), ("decoder_kv", ValueError),
                                        ("fp8", ValueError)])
def test_modes_not_ported_are_refused(mode, error):
    """``int8_full`` runs (the encoder and the decode memory in int8: the
    parts reach the head, whose state holds int8 memory); ``decoder_kv`` is
    a part, not a mode, and raises like any unknown mode (the JAX package's
    lookup gives None for it, which runs unquantized)."""
    if error is not None:
        with pytest.raises(error, match="unknown"):
            _tiny_recognizer(quantize=mode)
        return
    rec = _tiny_recognizer(quantize=mode)
    assert rec.model.quant_parts == ("encoder", "decoder_mem")
    assert rec.model.predicter.quant_parts == ("decoder_mem",)
    crop = synth_hard_sample(np.random.default_rng(0), min_len=3, max_len=10, max_h=60,
                             max_w=120)[0]
    with torch.inference_mode():
        x = normalize(torch.from_numpy(rec.make_batch([rec._preprocess(crop)],
                                                      rec.bucket_key(crop))))
        state = rec.model.init_decode_state(rec.model.encode(x), 13, 3)
    assert state.enc.dtype == state.enc_proj.dtype == torch.int8
    assert tuple(state.enc_scale.shape) == tuple(state.proj_scale.shape) == (1, 1, 1)
    assert isinstance(rec(crop), str)


def test_release_configs_accept_int8():
    for version in ("synthetic", "synthetic_tfm_big"):
        cfg, _ = load_recog_config(version=version)
        assert cfg["quantize"] == "int8"
        for dtype in ("float32", "bfloat16"):
            rec = MathRecognition(dict(cfg, dtype=dtype), None, device="cpu")
            assert rec.model.quant_parts == ("encoder",) and rec.model.int8_layers
