"""Dynamic int8 inference for the encoder (counterpart of
``doc2tex_tpu.ops.quant``, the ``quantize: int8`` mode every released
version block sets).

Symmetric int8, computed on the fly:

- activations: one scale per tensor, over the whole batch (padding rows
  included), so a row's result depends on its batch mates; on a mesh the
  batch is the global one: the data ranks' abs-maxes are maxed
  (``quantize_activation``), as JAX's abs-max over a sharded batch is;
- weights: one scale per output channel, taken from the kernel after its
  cast to the compute type (flax casts before the hook sees it);
- the integer product accumulates in int32 (``torch._int_mm``), then
  ``acc.float() * (activation scale * weight scale)``, the scale product
  formed first, is cast to the compute type and the bias added in it.

The order of operations is the reference's as XLA runs it under ``jit``,
the form every decode takes: XLA turns the division of the abs-max by the
constant 127.0 into a product with the float32 reciprocal of 127, while
``x / scale`` stays a true division.  Integer sums do not depend on their
order, so the results equal the JAX package's bit for bit.

The layers the reference's hook reaches go int8, each only where the
shape gates below pass: the encoder's convolutions (the ResNet's and the
patch conv) and the ViT blocks' Dense layers; the decoder heads' weights
stay in the compute type.  The JAX package injects the int8 op at trace
time from a context; here the quantized parts are a plain attribute of the
model (``Model.set_quantize``), and each int8 layer keeps its quantized
kernel (``layer_weight``).

The parts (the reference's ``quantized_inference(parts=...)``):

- ``encoder``: the products above;
- ``decoder_mem``: the decode-step attention memory is stored in int8,
  quantized once at decode start: the LSTM head's ``enc``/``enc_proj``
  with one scale per sample (``quantize_memory``), the TFM head's
  cross-attention K/V with one scale per vector of a head
  (``quantize_kv``).  B1 and B2 have int8 forms that read it;
- ``decoder_kv``: the TFM head's growing self-attention caches too, each
  step's new rows quantized as they are written (an LSTM head ignores it).

The modes of the config's ``quantize:`` are ``int8`` (the encoder) and
``int8_full`` (the encoder and ``decoder_mem``); ``decoder_kv`` is reached
only through an explicit parts tuple, as in the JAX package.
"""

from __future__ import annotations

import contextlib
from typing import Optional

import numpy as np
import torch
import torch.nn.functional as F

from ..parallel.mesh import data_all_reduce_max

# The reference's shape gates (doc2tex_tpu/ops/quant.py): an op goes int8
# only when its contraction and its output width both reach them.  They
# are part of the function the released exact-match figures were measured
# with, so they keep the reference's values.
MIN_CONTRACT = 256   # contraction (in_features, or kh*kw*cin of a conv)
MIN_OUT = 128        # output channels

_EPS = 1e-8
# float32(1 / 127): what XLA makes of the reference's ``max / 127.0``
_RECIP_127 = float(np.float32(1.0) / np.float32(127.0))

PARTS = ("encoder", "decoder_mem", "decoder_kv")
_MODES = {"int8": ("encoder",), "int8_full": ("encoder", "decoder_mem")}
# named sets of parts that are no ``quantize:`` mode: the caller sets them on
# the model (``Model.set_quantize``) over an ``int8_full`` config
NAMED_PARTS = {"int8_kv": ("encoder", "decoder_mem", "decoder_kv")}


def parts_for_mode(mode) -> Optional[tuple]:
    """The config's ``quantize:`` value -> the quantized parts (None =
    unquantized): ``int8`` -> the encoder, ``int8_full`` -> the encoder
    and ``decoder_mem``.  Any other value raises ``ValueError``, the part
    name ``decoder_kv`` included (the JAX package's lookup returns None
    for it, which runs unquantized)."""
    if mode is None or mode == "":
        return None
    if mode not in _MODES:
        raise ValueError(f"unknown quantize mode {mode!r} (int8, int8_full or null)")
    return _MODES[mode]


def check_parts(parts) -> Optional[tuple]:
    """A mode string, or an explicit tuple of PARTS (the JAX package's
    ``quantized_inference(parts=...)``) -> the parts tuple, or None."""
    if parts is None or isinstance(parts, str):
        return parts_for_mode(parts)
    parts = tuple(parts)
    bad = sorted(set(parts) - set(PARTS))
    if bad:
        raise ValueError(f"unknown quant parts {bad} (of {PARTS})")
    return parts or None


def gated(contract: int, n_out: int) -> bool:
    """True when an op of this contraction and output width goes int8."""
    return contract >= MIN_CONTRACT and n_out >= MIN_OUT


def quantize(x: torch.Tensor, dims=None) -> tuple[torch.Tensor, torch.Tensor]:
    """Symmetric int8 quantization, the scale reduced over ``dims`` (all
    when None).  Returns (int8 values, float32 scale that broadcasts
    against x)."""
    xf = x.float()
    if dims is None:
        amax = xf.abs().amax()
    else:
        amax = xf.abs().amax(dim=dims, keepdim=True)
    return _quantize_by(xf, amax)


def _quantize_by(xf: torch.Tensor, amax: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    scale = torch.clamp_min(amax * _RECIP_127, _EPS)
    # a true division by a tensor on x's device (a CPU scalar divisor would
    # make CUDA multiply by its reciprocal instead)
    q = torch.clamp(torch.round(xf / scale), -127.0, 127.0).to(torch.int8)
    return q, scale


_SCALE_LOGS: list = []


@contextlib.contextmanager
def recorded_scales():
    """While the block runs, every int8 product's activation scale, in
    the order the products run, as Python floats in the yielded list."""
    log: list = []
    _SCALE_LOGS.append(log)
    try:
        yield log
    finally:
        _SCALE_LOGS.pop()


def quantize_activation(x: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """``quantize(x)`` with one scale over the whole batch: under an
    active mesh the global batch's (the data ranks' abs-maxes maxed)."""
    xf = x.float()
    q, scale = _quantize_by(xf, data_all_reduce_max(xf.abs().amax()))
    if _SCALE_LOGS:
        _SCALE_LOGS[-1].append(float(scale))
    return q, scale


def quantize_weight(kernel: torch.Tensor, dtype: torch.dtype) -> tuple[torch.Tensor, torch.Tensor]:
    """A (K, N) kernel -> (int8 (N, K) row-major, float32 (N,) scale): cast
    to the compute type first, one scale per output column."""
    q, scale = quantize(kernel.to(dtype), dims=0)
    return q.t().contiguous(), scale.reshape(-1)


def layer_weight(layer, quantize_fn) -> tuple[torch.Tensor, torch.Tensor]:
    """``quantize_fn(layer.kernel, layer.dtype)``, kept on the layer until
    the kernel, its device or the compute type changes."""
    kernel = layer.kernel
    key = (kernel._version, kernel.device, layer.dtype)
    if layer._int8_kernel is None or layer._int8_kernel[0] != key:
        layer._int8_kernel = (key, *quantize_fn(kernel, layer.dtype))
    return layer._int8_kernel[1:]


def _pad_to(t: torch.Tensor, rows: int, cols: int) -> torch.Tensor:
    if t.shape == (rows, cols):
        return t
    return F.pad(t, (0, cols - t.shape[1], 0, rows - t.shape[0]))


def int_mm(a: torch.Tensor, b_t: torch.Tensor) -> torch.Tensor:
    """int8 (M, K) x int8 (N, K)^T -> int32 (M, N), exact.

    On the card cuBLASLt wants M > 16 and K, N multiples of 8: the operands
    are padded with zero rows and columns where needed (a zero adds nothing
    and a zero row changes no other row), and the pad is cut off the result.
    A refused call raises; there is no float fallback."""
    M, K = a.shape
    N = b_t.shape[0]
    if a.device.type != "cuda":
        return torch._int_mm(a, b_t.t())
    Mp, Kp, Np = 32 if M <= 16 else M, -(-K // 8) * 8, -(-N // 8) * 8
    a_p = _pad_to(a, Mp, Kp).contiguous()
    b_p = _pad_to(b_t, Np, Kp).contiguous()
    acc = torch._int_mm(a_p, b_p.t())
    return acc[:M, :N]


def _rescale(acc: torch.Tensor, a_scale: torch.Tensor, w_scale: torch.Tensor,
             bias: Optional[torch.Tensor], dtype: torch.dtype) -> torch.Tensor:
    out = (acc.float() * (a_scale.reshape(()) * w_scale)).to(dtype)
    return out if bias is None else out + bias.to(dtype)


def int8_linear(x: torch.Tensor, w_q: torch.Tensor, w_scale: torch.Tensor,
                bias: Optional[torch.Tensor], dtype: torch.dtype) -> torch.Tensor:
    """flax Dense through the int8 op: ``x (..., K)`` in the compute type,
    the kernel as ``quantize_weight`` gives it.  Returns (..., N) in
    ``dtype``."""
    x = x.to(dtype)
    a_q, a_scale = quantize_activation(x)
    acc = int_mm(a_q.reshape(-1, x.shape[-1]), w_q)
    return _rescale(acc, a_scale, w_scale, bias, dtype).reshape(*x.shape[:-1], -1)


def quantize_conv_weight(kernel: torch.Tensor, dtype: torch.dtype) -> tuple[torch.Tensor, torch.Tensor]:
    """An OIHW kernel -> (int8 (O, I*kh*kw), float32 (O,) scale): cast to
    the compute type first, one scale per output channel over (I, kh, kw)."""
    q, scale = quantize(kernel.to(dtype), dims=(1, 2, 3))
    return q.reshape(q.shape[0], -1), scale.reshape(-1)


def int8_conv2d(x: torch.Tensor, w_q: torch.Tensor, w_scale: torch.Tensor,
                bias: Optional[torch.Tensor], kernel_size: tuple[int, int],
                stride: tuple[int, int], padding: tuple[int, int],
                dtype: torch.dtype, dilation: tuple[int, int] = (1, 1)) -> torch.Tensor:
    """flax Conv through the int8 op, on NCHW input: the input quantized
    with one scale, zero-padded in int8 (a zero pad leaves the abs-max as it
    is), its windows (taps ``dilation`` apart, the reference's
    ``rhs_dilation``) gathered into one (B*Ho*Wo, I*kh*kw) int8 matrix and
    multiplied with the kernel as ``quantize_conv_weight`` gives it.
    Returns (B, O, Ho, Wo) in ``dtype``."""
    x = x.to(dtype)
    a_q, a_scale = quantize_activation(x)
    (kh, kw), (sh, sw), (ph, pw), (dh, dw) = kernel_size, stride, padding, dilation
    if ph or pw:
        a_q = F.pad(a_q, (pw, pw, ph, ph))
    B, C, H, W = a_q.shape
    Ho, Wo = (H - dh * (kh - 1) - 1) // sh + 1, (W - dw * (kw - 1) - 1) // sw + 1
    if (kh, kw) == (sh, sw) and (dh, dw) == (1, 1) and (H, W) == (Ho * kh, Wo * kw):
        # non-overlapping windows that tile the map (the patch conv): a view
        cols = a_q.reshape(B, C, Ho, kh, Wo, kw).permute(0, 2, 4, 1, 3, 5)
    else:
        taps = [a_q[:, :, i * dh:i * dh + sh * (Ho - 1) + 1:sh,
                    j * dw:j * dw + sw * (Wo - 1) + 1:sw]
                for i in range(kh) for j in range(kw)]
        cols = torch.stack(taps, dim=2).permute(0, 3, 4, 1, 2)   # (B, Ho, Wo, C, kh*kw)
    acc = int_mm(cols.reshape(B * Ho * Wo, C * kh * kw), w_q)
    out = _rescale(acc, a_scale, w_scale, bias, dtype)
    return out.reshape(B, Ho, Wo, -1).permute(0, 3, 1, 2)


# ---- decoder memory (the ``decoder_mem`` and ``decoder_kv`` parts) ----------

def quantize_memory(x: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """One scale per sample of a (B, S, D) attention memory: (int8 values,
    float32 scale (B, 1, 1)), the reference's ``quantize_memory``."""
    return quantize(x, dims=tuple(range(1, x.dim())))


def dequantize_memory(q: torch.Tensor, scale: torch.Tensor) -> torch.Tensor:
    return q.float() * scale


def quantize_kv(x: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """One scale per vector of the last axis: a (B, M, nh, hd) K or V ->
    (int8 values, float32 scale (B, M, nh)), the reference's
    ``quantize_kv``."""
    q, scale = quantize(x, dims=-1)
    return q, scale.squeeze(-1)
