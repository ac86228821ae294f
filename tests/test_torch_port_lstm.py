"""The port's coverage-LSTM path against the JAX package.

- The coverage-attention step (TPU kernel B2): the port's plain version
  against JAX's ``attention_step_reference`` and against the Pallas kernel
  in interpret mode, float32 and bfloat16 memory, with and without
  ``valid_len``, on a batch that does not fill the Pallas blocks.
  Tolerance: 1e-5 abs on context and 2e-6 abs on alpha (both float32 sums
  of the same terms in another order).
- A tiny Attnv2 coverage model (ViT depth 1, width 64; LSTM hidden 64, 16
  location features), every variable drawn with numpy and carried into the
  port by ``weights.load_variables``: encoder memory, ``init_state`` leaves
  (the port keeps the attention memory at sample rows: its row b against
  JAX's row b*K, whose K rows of a sample are equal) and per-step logits
  within 1e-4 (float32), through beam reorders;
  greedy and beam-5 tokens equal, on a batch where some rows never finish.
- The released ``synthetic`` weights: every leaf consumed, and two crops
  of ``tests/torch_port_golden_synthetic.json`` (one greedy, one beam 10)
  decoded at full width on the CPU to the JAX package's strings.
"""

from __future__ import annotations

import copy

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from doc2tex_tpu.config import make_config as jax_make_config
from doc2tex_tpu.decode.beam import lstm_gather as jax_lstm_gather
from doc2tex_tpu.decode.runner import make_decode_fn as jax_make_decode_fn
from doc2tex_tpu.models import build_model as jax_build_model
from doc2tex_tpu.ops.attention_step import attention_step_reference as jax_step_reference
from doc2tex_tpu.ops.attention_step import fused_attention_step as jax_fused_step
from doc2tex_tpu_torch import _msgpack
from doc2tex_tpu_torch.config import make_config
from doc2tex_tpu_torch.decode.beam import lstm_gather
from doc2tex_tpu_torch.decode.runner import make_decode_fn
from doc2tex_tpu_torch.models import build_model
from doc2tex_tpu_torch.ops.attention_step import attention_step_reference, fused_attention_step
from doc2tex_tpu_torch.recognition import MathRecognition, load_recog_config
from doc2tex_tpu_torch.weights import convert_variables, load_variables
from test_torch_port_model import _images, _normalized, _random_variables
from test_torch_port_slice import _short_crops, load_golden, make_crop

V = 24            # 3 specials + 21 tokens
END = 1           # Attn family: [GO]=0, [s]=1
BUCKET = (32, 64)


def tiny_config(dtype: str = "float32") -> dict:
    return dict(
        max_dimension=[64, 128], min_dimension=[32, 32], batch_max_length=40, dtype=dtype,
        FeatureExtraction={"name": "None"},
        SequenceModeling={"name": "ViT", "params": {
            "backbone": {"name": "resnet", "input_channel": 1, "output_channel": 32,
                         "gcb": False},
            "fix_embed": True, "input_channel": 1, "patching_style": "2d",
            "patch_size": [2, 2], "depth": 1, "num_heads": 2, "hidden_size": 64}},
        Prediction={"name": "Attnv2", "params": {
            "seqmodel": "TFM", "input_size": 64, "hidden_size": 64, "kernel_size": 2,
            "kernel_dim": 16, "embed_target": True, "enc_init": True,
            "attn_type": "coverage", "droprate": 0.0}},
    )


# ---- the coverage-attention step ------------------------------------------

def _step_inputs(dtype, B=10, S=83, D=64, H=64, Kl=32, seed=0):
    """numpy inputs; enc/enc_proj rounded to bfloat16 when ``dtype`` is, so
    both packages see the same values."""
    rng = np.random.default_rng(seed)
    enc = rng.normal(size=(B, S, D)).astype(np.float32)
    enc_proj = rng.normal(size=(B, S, H)).astype(np.float32)
    if dtype == "bfloat16":
        enc, enc_proj = (torch.from_numpy(x).bfloat16().float().numpy() for x in (enc, enc_proj))
    return dict(
        enc=enc, enc_proj=enc_proj,
        q=rng.normal(size=(B, H)).astype(np.float32),
        loc_feat=rng.normal(size=(B, S, Kl)).astype(np.float32),
        w_loc=(rng.normal(size=(Kl, H)) * 0.1).astype(np.float32),
        b_loc=(rng.normal(size=(H,)) * 0.1).astype(np.float32),
        w_score=(rng.normal(size=(H, 1)) * 0.1).astype(np.float32),
    )


@pytest.mark.parametrize("valid_len", [None, 61])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_attention_step_matches_jax_reference_and_pallas(dtype, valid_len):
    kw = _step_inputs(dtype, seed=1 + (valid_len or 0))
    jdt = jnp.bfloat16 if dtype == "bfloat16" else jnp.float32
    tdt = torch.bfloat16 if dtype == "bfloat16" else torch.float32
    jkw = {k: jnp.asarray(v) for k, v in kw.items()}
    jkw["enc"], jkw["enc_proj"] = jkw["enc"].astype(jdt), jkw["enc_proj"].astype(jdt)
    tkw = {k: torch.from_numpy(v) for k, v in kw.items()}
    tkw["enc"], tkw["enc_proj"] = tkw["enc"].to(tdt), tkw["enc_proj"].to(tdt)

    ref_ctx, ref_alpha = jax_step_reference(**jkw, valid_len=valid_len)
    # the Pallas kernel, interpreted, in blocks of 4 rows over 10 (ragged)
    pal_ctx, pal_alpha = jax_fused_step(**jkw, valid_len=valid_len, block_b=4, interpret=True)
    before = fused_attention_step.launches
    ctx, alpha = fused_attention_step(**tkw, valid_len=valid_len)
    assert fused_attention_step.launches == before    # the CPU runs the plain version
    plain_ctx, plain_alpha = attention_step_reference(**tkw, valid_len=valid_len)
    assert torch.equal(ctx, plain_ctx) and torch.equal(alpha, plain_alpha)
    assert ctx.dtype == alpha.dtype == torch.float32
    assert ctx.shape == (10, 64) and alpha.shape == (10, 83)
    for want_ctx, want_alpha in ((ref_ctx, ref_alpha), (pal_ctx, pal_alpha)):
        np.testing.assert_allclose(ctx.numpy(), np.asarray(want_ctx), atol=1e-5, rtol=0)
        np.testing.assert_allclose(alpha.numpy(), np.asarray(want_alpha), atol=2e-6, rtol=0)
    if valid_len is not None:
        assert alpha[:, valid_len:].max().item() == 0.0


def test_attention_step_wrapper_rejects_bad_shapes():
    tkw = {k: torch.from_numpy(v) for k, v in _step_inputs("float32", B=2, S=9).items()}
    with pytest.raises(ValueError, match="shape"):
        fused_attention_step(**dict(tkw, q=tkw["q"][:1]))
    with pytest.raises(ValueError, match="w_loc"):
        fused_attention_step(**dict(tkw, w_loc=tkw["w_loc"][:, :3]))


# ---- the tiny model ----------------------------------------------------------

def _images_apart(n: int, seed: int) -> np.ndarray:
    """Noise crops that differ per row (white left margin, black top band
    of growing size), so the rows decode differently."""
    img = _images(BUCKET, n, seed)
    for i in range(n):
        img[i, :, : i * BUCKET[1] // n] = 255
        img[i, : i * BUCKET[0] // (2 * n)] = 0
    return img


@pytest.fixture(scope="module")
def pair():
    """(jax model, numpy variables, port model) sharing random weights."""
    cfg = tiny_config()
    jmodel = jax_build_model(jax_make_config(cfg), V)
    shapes = jax.eval_shape(
        lambda: jmodel.init(jax.random.PRNGKey(0), jnp.zeros((1, *BUCKET, 1)),
                            jnp.zeros((1, 41), jnp.int32), train=False))
    variables = _random_variables(dict(shapes), np.random.default_rng(5))
    port = build_model(make_config(cfg), V).eval()
    assert load_variables(port, variables) == len(jax.tree_util.tree_leaves(variables))
    return jmodel, variables, port


def _with_end_bias(variables, port, bias):
    """Both models with the end token's bias set to ``bias``: it decides
    how often rows finish."""
    pred = dict(variables["params"]["predicter"])
    pred["b_gen"] = pred["b_gen"].copy()
    pred["b_gen"][END] = bias
    jvars = dict(variables, params=dict(variables["params"], predicter=pred))
    port = copy.deepcopy(port)
    with torch.no_grad():
        port.predicter.b_gen[END] = bias
    return jax.tree_util.tree_map(jnp.asarray, jvars), port


def test_encode_init_state_and_step_logits_match_jax(pair):
    """Encoder memory, every init_state leaf (beam 3), and the logits of
    four decode steps with a beam reorder after each: within 1e-4."""
    jmodel, variables, port = pair
    variables = jax.tree_util.tree_map(jnp.asarray, variables)
    B, K = 2, 3
    x = _normalized(_images(BUCKET, B, seed=2))
    jenc = jax.jit(lambda v, x: jmodel.apply(v, x, method="encode"))(variables, jnp.asarray(x))
    jstate = jax.jit(lambda v, e: jmodel.apply(v, e, 41, K, method="init_decode_state"))(
        variables, jenc)
    jstep = jax.jit(lambda v, s, t: jmodel.apply(v, s, t, method="decode_step"))
    with torch.no_grad():
        penc = port.encode(torch.from_numpy(x))
        pstate = port.init_decode_state(penc, 41, K)
    np.testing.assert_allclose(penc.numpy(), np.asarray(jenc), atol=1e-4, rtol=0)
    for name in ("h", "c", "alpha_cum", "alpha_prev"):
        got, want = getattr(pstate, name), np.asarray(getattr(jstate, name))
        assert tuple(got.shape) == want.shape, name
        np.testing.assert_allclose(got.numpy(), want, atol=1e-4, rtol=0, err_msg=name)
    # the port keeps the attention memory at sample rows; JAX repeats it to
    # B*K rows, whose K rows of a sample are equal: the port's row b is
    # JAX's row b*K
    for name in ("enc", "enc_proj"):
        got, want = getattr(pstate, name), np.asarray(getattr(jstate, name))
        assert tuple(got.shape) == (B,) + want.shape[1:], name
        per_sample = want.reshape(B, K, *want.shape[1:])
        np.testing.assert_array_equal(per_sample, np.repeat(per_sample[:, :1], K, axis=1),
                                      err_msg=name)
        np.testing.assert_allclose(got.numpy(), want[::K], atol=1e-4, rtol=0, err_msg=name)
    rng = np.random.default_rng(3)
    tokens = np.zeros(B * K, np.int32)        # the start token, [GO] = 0
    for _ in range(4):
        jstate, jlogits = jstep(variables, jstate, jnp.asarray(tokens))
        with torch.no_grad():
            pstate, plogits = port.decode_step(pstate, torch.from_numpy(tokens).long())
        np.testing.assert_allclose(plogits.numpy(), np.asarray(jlogits), atol=1e-4, rtol=0)
        beam_idx = rng.integers(0, K, (B, K)).astype(np.int32)
        jstate = jax_lstm_gather(jstate, jnp.asarray(beam_idx), B, K)
        pstate = lstm_gather(pstate, torch.from_numpy(beam_idx).long(), B, K)
        for name in ("h", "c", "alpha_cum", "alpha_prev"):
            np.testing.assert_allclose(getattr(pstate, name).numpy(),
                                       np.asarray(getattr(jstate, name)), atol=1e-4, rtol=0)
        tokens = rng.integers(0, V, (B * K,)).astype(np.int32)


@pytest.mark.parametrize("beam,end_bias", [(1, 0.14), (5, 0.0)])
def test_decode_tokens_match_jax(pair, beam, end_bias):
    """Greedy and beam-5 decodes of 41 steps: token-exact, with rows that
    finish and rows that never do (at these end-token biases)."""
    jmodel, variables, port = pair
    variables, port = _with_end_bias(variables, port, end_bias)
    cfg = tiny_config()
    images = _images_apart(6, seed=4)
    jfn = jax_make_decode_fn(jmodel, jax_make_config(cfg), beam_size=beam, jit=True)
    jtok, _ = jfn(variables, jnp.asarray(images))
    ptok, _ = make_decode_fn(port, make_config(cfg), beam_size=beam, device="cpu")(images)
    jtok = np.asarray(jtok)
    np.testing.assert_array_equal(ptok.numpy(), jtok)
    finished = (jtok == END).any(axis=1)
    assert finished.any() and not finished.all(), finished


# ---- the released weights ----------------------------------------------------

def test_weight_converter_consumes_every_synthetic_leaf():
    cfg, weights = load_recog_config(version="synthetic")
    variables = _msgpack.load(weights)
    n_leaves = len(convert_variables(variables))
    model = build_model(dict(cfg, dtype="float32", quantize=None), 682)
    assert load_variables(model, variables) == n_leaves
    pred = variables["params"]["predicter"]
    assert len(pred) == 21                      # flat predicter/<name> leaves
    np.testing.assert_array_equal(model.predicter.loc_conv_w.detach().numpy(),
                                  pred["loc_conv_w"].astype(np.float32))  # (k, 1, Kd) kept
    short = dict(variables, params=dict(variables["params"],
                                        predicter={k: v for k, v in pred.items() if k != "w_loc"}))
    with pytest.raises(ValueError, match="missing"):
        load_variables(model, short)


@pytest.mark.parametrize("mode", ["greedy", "beam10"])
def test_full_width_synthetic_weights_match_golden(mode):
    """The port on the CPU, released ``synthetic`` weights, full width,
    float32: the JAX package's string for one crop per decode mode."""
    golden = load_golden("synthetic")
    crop = _short_crops(golden, 2)[0 if mode == "greedy" else 1]
    img, _ = make_crop(crop["seed"])
    cfg, weights = load_recog_config(version="synthetic")
    cfg["dtype"], cfg["quantize"] = "float32", None
    rec = MathRecognition(cfg, weights, beam_size=1 if mode == "greedy" else 10, device="cpu")
    assert rec.bucket_key(img) == tuple(crop["native_bucket"])
    prepped = rec._preprocess(img)
    assert rec.decode_group([prepped], tuple(crop["decode_bucket"])) == [crop[mode]]


def test_synthetic_golden_holds_the_same_crops():
    """Both golden files hold the same 16 seeded crops."""
    ours, tfm = load_golden("synthetic"), load_golden()
    assert ours["version"] == "synthetic" and ours["dtype"] == "float32"
    keys = ("seed", "shape", "sha256", "native_bucket", "label")
    assert [[c[k] for k in keys] for c in ours["crops"]] == [
        [c[k] for k in keys] for c in tfm["crops"]]
