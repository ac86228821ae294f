"""One coverage-attention decode step of the LSTM head.

Per decode row r = b*K + k (beam k of sample b), over S encoder positions,
as the JAX package's ``doc2tex_tpu.ops.attention_step``:

    e[r,s]     = tanh(enc_proj[b,s] + q[r] + locH[r,s]) @ w_score
    e[r,s]     = -1e30 where s >= valid_len
    alpha[r,s] = softmax_s(e[r])
    context[r] = sum_s alpha[r,s] * enc[b,s]

in two forms of the location term ``locH``:

- ``fused_attention_step``, the TPU kernel's contract: ``locH = loc_feat @
  w_loc + b_loc`` from the location features (B, S, Kl), with the memory at
  the rows of q (K = 1);
- ``coverage_attention_step``, the decoder's main path: the location conv
  over the coverage ``mem`` (B*K, S) folded in, with the memory at sample
  rows (Bs, S, ·) and q at Bs*K rows.  Its plain version is the decoder's
  former step: ``location_features``, the memory repeated K times, then
  ``attention_step_reference``.

Both run one hand-written CUDA kernel (``csrc/attention_step.cu``, the form a
template parameter) on CUDA tensors, with the grid ``launch_plan`` chooses,
and their plain PyTorch versions on CPU tensors.  Neither falls back from
one to the other: on a CUDA tensor each launches the kernel or raises.

Training: on a CUDA tensor that needs a gradient, ``coverage_attention_step``
runs through ``CoverageAttentionStepFn``, whose forward is the kernel above
(it saves the inputs and alpha, no (B, S, H) tensor) and whose backward is a
second hand-written kernel (``csrc/attention_step_backward.cu``, at K = 1),
``coverage_attention_step_backward``; its plain version
``coverage_attention_step_backward_reference`` writes the gradient out.  On
the CPU the step stays the plain version under autograd.
"""

from __future__ import annotations

import ctypes
import functools
from typing import NamedTuple

import torch
import torch.nn.functional as F

from .._build import load_library

SOURCE = "attention_step.cu"
BACKWARD_SOURCE = "attention_step_backward.cu"
BWD_CHUNK = 64            # positions per block in the backward's passes over S
BWD_VECS = 7              # per-block partial vectors of H: d q, d w_score, 5 taps
NEG_INF = -1e30
WIDTHS = (128, 256)            # D = H the kernel is built for
_DTYPE_CODE = {torch.float32: 0, torch.bfloat16: 2}
FEATURE, COVERAGE = "feature", "coverage"

# The kernel's grid (csrc/attention_step.cu): per sample, `zsplit` groups of
# K / zsplit beams, each a cluster of up to MAX_CLUSTER blocks splitting S
# into chunks; a block streams its chunk's enc_proj, then enc, rows through
# a ring of `stages` tiles of `tile` positions.
MAX_BEAM = 16             # beams a block holds (K / zsplit)
MAX_CLUSTER = 8           # portable cluster size
MAX_TAPS = 5              # the widest location conv: kernel_size 2
TILES = (32, 16)          # positions per ring tile, the first that fits
RED_FLOATS = 6144         # the kernel's scratch of partial sums
CHUNK_ALIGN = 8           # a chunk is a multiple of this many positions
SMEM_LIMIT = 232_448      # dynamic shared memory a block may use on sm_90 (227 KB)
SMEM_PER_SM = 233_472     # an SM's shared memory; each block also takes 1 KB
SMS = 132                 # H100 SXM
# launch_plan's model of a plan's time, fitted to the coverage form's bf16
# device times over every plan at the synthetic slice's and the release
# shapes on an H100 (tools/bench_attention_step.py --sweep; PERF.md §6):
# a block takes FIXED_US (prologue, softmax exchanges, output) plus
# CLUSTER_US for each block of its cluster, plus US_PER_BEAM_POSITION for
# each of its beams x positions (H 128; twice that at H 256, and G1_FACTOR
# times that when its beams are not in fives).  Blocks run in waves of SMS;
# two waves of clusters of at most 2 blocks share the SMs at CO_RESIDENT of
# the time.  More than BIG_CLUSTERS clusters of 7 or 8 blocks took
# BIG_CLUSTER_US longer.
FIXED_US, CLUSTER_US, US_PER_BEAM_POSITION = 9.4, 0.2, 0.0216
G1_FACTOR, CO_RESIDENT = 2, 0.72
BIG_CLUSTERS, BIG_CLUSTER_US = 12, 4.0
STAGES = 2                # ring tiles: deeper rings measured no faster


class LaunchPlan(NamedTuple):
    """The kernel's grid: block r of a cluster owns positions [r * chunk,
    min(S, (r + 1) * chunk)) of the K / zsplit beams of its group."""

    cluster: int     # blocks per (sample, beam group), along S
    chunk: int       # positions per block, a multiple of CHUNK_ALIGN
    zsplit: int      # beam groups per sample
    tile: int        # positions per ring tile
    stages: int      # ring tiles
    smem_bytes: int  # dynamic shared memory per block


def _up16(x: int) -> int:
    return (x + 15) // 16 * 16


def smem_bytes(form: str, Kz: int, chunk: int, tile: int, stages: int, H: int, Kl: int,
               elem: int) -> int:
    """Dynamic shared memory of one block: ``make_layout`` of the kernel."""
    cov = form == COVERAGE
    stage = _up16(tile * (H * elem + 16)) + (0 if cov else Kz * tile * (Kl * 4 + 16))
    return (_up16((MAX_TAPS if cov else Kl) * H * 4)             # W' or w_loc
            + _up16((MAX_TAPS + 1) * Kl * 4 if cov else 0)       # conv_w, conv_b
            + _up16(Kz * H * 4)                                  # q + b'
            + _up16(H * 4)                                       # w_score
            + _up16(Kz * (chunk + MAX_TAPS - 1) * 4 if cov else 0)  # coverage and halo
            + _up16(Kz * chunk * 4)                              # f32 scores
            + _up16(Kz * H * 4)                                  # the block's context
            + RED_FLOATS * 4                                     # partial sums
            + _up16((4 * 16 + 4) * 4)                            # row max and sum
            + stages * stage)                                    # the ring


@functools.lru_cache(maxsize=None)
def launch_plan(Bs: int, K: int, S: int, D: int, H: int, Kl: int, dtype: torch.dtype,
                form: str = COVERAGE, taps: int = MAX_TAPS) -> LaunchPlan:
    """The kernel's grid for one call.  Over beam groups (zsplit dividing
    K, at most MAX_BEAM beams a block) and clusters of 1..MAX_CLUSTER
    blocks, with a ring of STAGES tiles of the first size in TILES that fits
    shared memory, the plan of least modelled time (see FIXED_US); ties go
    to the smaller cluster, then the fewer groups.  Raises on what the
    kernel does not take: D != H, widths outside WIDTHS, taps (2 *
    kernel_size + 1) above MAX_TAPS, Kl not a multiple of 4 in the feature
    form, and an S that MAX_CLUSTER blocks cannot hold."""
    if dtype not in _DTYPE_CODE:
        raise TypeError(f"kernel takes float32/bfloat16 memory; got {dtype}")
    if form not in (FEATURE, COVERAGE):
        raise ValueError(f"form must be {FEATURE!r} or {COVERAGE!r}; got {form!r}")
    if D != H or D not in WIDTHS:
        raise ValueError(f"kernel takes D = H in {WIDTHS}; got D={D}, H={H}")
    if form == COVERAGE and not (0 < taps <= MAX_TAPS and taps % 2 == 1):
        raise ValueError(f"kernel takes a location conv of at most {MAX_TAPS} taps "
                         f"(kernel_size <= {(MAX_TAPS - 1) // 2}); got {taps}")
    if Kl <= 0 or (form == FEATURE and Kl % 4):
        raise ValueError(f"kernel takes Kl > 0 (a multiple of 4 in the feature form); got {Kl}")
    if Bs <= 0 or K <= 0 or S <= 0:
        raise ValueError(f"kernel takes samples, beams and S > 0; got {Bs}, {K}, {S}")
    elem = dtype.itemsize
    best = None
    for zsplit in (z for z in range(1, K + 1) if K % z == 0 and K // z <= MAX_BEAM):
        Kz = K // zsplit
        for cluster in range(1, MAX_CLUSTER + 1):
            chunk = -(-(-(-S // cluster)) // CHUNK_ALIGN) * CHUNK_ALIGN
            if -(-S // chunk) != cluster:
                continue  # the same chunks as a smaller cluster
            fit = next(((tile, smem) for tile in TILES
                        if (smem := smem_bytes(form, Kz, chunk, tile, STAGES, H, Kl, elem))
                        <= SMEM_LIMIT), None)
            if fit is None:
                continue
            tile, smem = fit
            waves = -(-Bs * zsplit * cluster // SMS)
            work = Kz * chunk * (H // 128) * (1 if Kz % 5 == 0 else G1_FACTOR)
            block = FIXED_US + CLUSTER_US * cluster
            if cluster >= 7 and Bs * zsplit > BIG_CLUSTERS:
                block += BIG_CLUSTER_US
            if waves == 2 and cluster <= 2 and 2 * (smem + 1024) <= SMEM_PER_SM:
                cost = block + 2 * work * US_PER_BEAM_POSITION * CO_RESIDENT
            else:
                cost = waves * (block + work * US_PER_BEAM_POSITION)
            key = (cost, cluster, zsplit)
            if best is None or key < best[0]:
                best = (key, LaunchPlan(cluster, chunk, zsplit, tile, STAGES, smem))
    if best is None:
        raise ValueError(f"S={S} does not fit {MAX_CLUSTER} blocks of {SMEM_LIMIT} bytes "
                         f"({form} form, K={K}, D={D}, Kl={Kl}, {dtype})")
    return best[1]


# ---- plain versions ----------------------------------------------------------

def attention_step_reference(enc, enc_proj, q, loc_feat, w_loc, b_loc, w_score,
                             valid_len=None):
    """Plain PyTorch version: enc (B,S,D), enc_proj (B,S,H) in the compute
    type, q (B,H), loc_feat (B,S,Kl) float32, w_loc (Kl,H), b_loc (H,),
    w_score (H,) or (H,1) -> (context (B,D) f32, alpha (B,S) f32).  With a
    float64 q everything is float64 (the backward's tests)."""
    H = enc_proj.shape[-1]
    ft = torch.promote_types(q.dtype, torch.float32)
    loc_h = loc_feat.to(ft) @ w_loc.to(ft) + b_loc.to(ft)
    x = torch.tanh(enc_proj.to(ft) + q.to(ft)[:, None, :] + loc_h)
    e = (x @ w_score.to(ft).reshape(H, 1))[..., 0]
    if valid_len is not None:
        pos = torch.arange(e.shape[-1], device=e.device)
        e = e.masked_fill(pos[None, :] >= valid_len, NEG_INF)
    alpha = torch.softmax(e, dim=-1)
    context = torch.einsum("bs,bsd->bd", alpha, enc.to(ft))
    return context, alpha


def location_features(mem, loc_conv_w, loc_conv_b):
    """Location features (B, S, Kl) f32: the cross-correlation of the
    attention memory (B, S) with ``loc_conv_w`` (k, 1, Kl), zero-padded by
    (k - 1) / 2 on each side, plus ``loc_conv_b``: the JAX package's
    ``conv_general_dilated`` (NWC, WIO).  Written as windows times the
    (k, Kl) kernel, so the result is already (B, S, Kl)."""
    k = loc_conv_w.shape[0]
    windows = F.pad(mem, ((k - 1) // 2, (k - 1) // 2)).unfold(-1, k, 1)
    return windows @ loc_conv_w[:, 0, :] + loc_conv_b


def coverage_attention_step_reference(enc, enc_proj, q, mem, loc_conv_w, loc_conv_b, w_loc,
                                      b_loc, w_score, valid_len=None):
    """Plain PyTorch version of the coverage form: enc (Bs,S,D) and
    enc_proj (Bs,S,H) at sample rows, q (Bs*K,H), mem (Bs*K,S) float32 ->
    (context (Bs*K,D) f32, alpha (Bs*K,S) f32)."""
    K = q.shape[0] // enc.shape[0]
    if K > 1:
        enc, enc_proj = enc.repeat_interleave(K, dim=0), enc_proj.repeat_interleave(K, dim=0)
    loc_feat = location_features(mem, loc_conv_w, loc_conv_b)
    return attention_step_reference(enc, enc_proj, q, loc_feat, w_loc, b_loc, w_score,
                                    valid_len)


def coverage_attention_step_backward_reference(enc, enc_proj, q, mem, loc_conv_w, loc_conv_b,
                                               w_loc, w_score, b_loc, alpha, g_context,
                                               g_alpha):
    """Plain PyTorch version of the coverage form's backward at K = 1 (one
    row of q per sample), written out rather than taken by autograd.

    From the forward's inputs, its ``alpha`` (B, S) and the cotangents of
    its outputs, ``g_context`` (B, D) and ``g_alpha`` (B, S) (alpha feeds
    the next step's coverage, so ``g_alpha`` is not zero), per row b and
    position s:

        loc_feat = location_features(mem), t = tanh(enc_proj + q + loc_feat @ w_loc + b_loc)
        g_a  = g_alpha + enc . g_context,  g_e = alpha (g_a - sum_s alpha g_a)
        g_pre = g_e w_score (1 - t^2) = d enc_proj,   d enc = alpha g_context
        d q = sum_s g_pre, d b_loc = sum g_pre, d w_loc = sum loc_feat^T g_pre,
        d w_score = sum g_e t;  g_loc = g_pre @ w_loc^T: d loc_conv_b = sum g_loc,
        d loc_conv_w[j] = sum mem_pad[s + j] g_loc[s], d mem the transposed
        correlation of g_loc (zero at the padded edges).

    Positions past a ``valid_len`` have alpha 0, so they get no gradient.
    Computes in float32 (float64 for float64 inputs).  Returns (d enc and
    d enc_proj in their inputs' types, d q, d mem, d loc_conv_w, d
    loc_conv_b, d w_loc, d b_loc, d w_score in the compute type)."""
    if q.shape[0] != enc.shape[0]:
        raise ValueError(f"the backward takes K = 1: q {tuple(q.shape)}, enc {tuple(enc.shape)}")
    ft = torch.promote_types(q.dtype, torch.float32)
    B, S, _ = enc.shape
    H = enc_proj.shape[-1]
    taps = loc_conv_w.shape[0]
    pad = (taps - 1) // 2
    conv_w, wl, a, g_ctx = (t.to(ft) for t in (loc_conv_w[:, 0, :], w_loc, alpha, g_context))
    windows = F.pad(mem.to(ft), (pad, pad)).unfold(-1, taps, 1)        # (B, S, taps)
    loc_feat = windows @ conv_w + loc_conv_b.to(ft)                     # (B, S, Kl)
    t = torch.tanh(enc_proj.to(ft) + q.to(ft)[:, None, :] + loc_feat @ wl + b_loc.to(ft))
    g_a = g_alpha.to(ft) + torch.einsum("bsd,bd->bs", enc.to(ft), g_ctx)
    g_e = a * (g_a - (a * g_a).sum(-1, keepdim=True))
    g_pre = g_e[..., None] * w_score.to(ft).reshape(H) * (1 - t * t)
    d_q = g_pre.sum(1)
    g_loc = g_pre @ wl.T                                                # (B, S, Kl)
    g_win = g_loc @ conv_w.T                                            # (B, S, taps)
    d_mem = torch.zeros(B, S + 2 * pad, dtype=ft, device=enc.device)
    for j in range(taps):
        d_mem[:, j:j + S] += g_win[..., j]
    return (
        (a[..., None] * g_ctx[:, None, :]).to(enc.dtype),
        g_pre.to(enc_proj.dtype),
        d_q,
        d_mem[:, pad:pad + S],
        torch.einsum("bsj,bsk->jk", windows, g_loc)[:, None, :],
        g_loc.sum((0, 1)),
        torch.einsum("bsk,bsh->kh", loc_feat, g_pre),
        d_q.sum(0),
        torch.einsum("bs,bsh->h", g_e, t),
    )


# ---- the kernel ----------------------------------------------------------------

def _kernels():
    lib, info = load_library(SOURCE)
    tail = [ctypes.c_int] * 6 + [ctypes.c_void_p]  # cluster .. smem_bytes, stream
    feat = lib.d2t_attention_step_features
    feat.restype = ctypes.c_int
    feat.argtypes = [ctypes.c_void_p] * 9 + [ctypes.c_int] * 8 + tail
    cov = lib.d2t_attention_step_coverage
    cov.restype = ctypes.c_int
    cov.argtypes = [ctypes.c_void_p] * 11 + [ctypes.c_int] * 9 + tail
    return {FEATURE: feat, COVERAGE: cov}, info


def build() -> dict:
    """Build (if needed) and load the kernel; returns ``load_library``'s info."""
    return _kernels()[1]


def _same_device(tensors):
    devices = {t.device for t in tensors}
    if len(devices) != 1:
        raise ValueError(f"tensors on different devices: {devices}")


def _check_memory(enc, enc_proj, q):
    """The memory at sample rows and q at Bs*K rows; returns K."""
    if enc.dim() != 3 or enc_proj.dim() != 3 or q.dim() != 2:
        raise ValueError("enc and enc_proj must be 3-D and q 2-D")
    Bs, S, _ = enc.shape
    H = enc_proj.shape[-1]
    if enc_proj.shape[:2] != (Bs, S) or q.shape[-1] != H or q.shape[0] % Bs:
        raise ValueError(f"shape mismatch: enc {tuple(enc.shape)}, enc_proj "
                         f"{tuple(enc_proj.shape)}, q {tuple(q.shape)} (q's rows must be "
                         "the samples times the beams)")
    return q.shape[0] // Bs


def _check_kernel_inputs(enc, enc_proj, f32):
    """What every launch needs beyond the plan: types, layout, alignment."""
    if enc.dtype != enc_proj.dtype or enc.dtype not in _DTYPE_CODE:
        raise TypeError(f"enc and enc_proj must share float32 or bfloat16; got "
                        f"{enc.dtype}, {enc_proj.dtype}")
    if any(t.dtype != torch.float32 for t in f32):
        raise TypeError("q, the location input and the weights must be float32")
    tensors = (enc, enc_proj) + tuple(f32)
    if not all(t.is_contiguous() for t in tensors):
        raise ValueError("all inputs must be contiguous")
    if any(t.data_ptr() % 16 for t in tensors):
        raise ValueError("all inputs must be 16-byte aligned")


def _valid_code(valid_len) -> int:
    return -1 if valid_len is None else max(int(valid_len), 0)  # the kernel reads -1 as no mask


def fused_attention_step(enc, enc_proj, q, loc_feat, w_loc, b_loc, w_score,
                         valid_len=None):
    """One attention step from location features; see the module docstring.

    enc (B,S,D), enc_proj (B,S,H), q (B,H), loc_feat (B,S,Kl) f32, w_loc
    (Kl,H), b_loc (H,), w_score (H,) or (H,1).  ``valid_len``: None, or an
    int; positions ``s >= valid_len`` get no attention.  Returns (context
    (B, D) float32, alpha (B, S) float32)."""
    if loc_feat.dim() != 3 or q.dim() != 2 or q.shape[0] != enc.shape[0]:
        raise ValueError(f"shape mismatch: q {tuple(q.shape)} must have the rows of enc "
                         f"{tuple(enc.shape)}, and loc_feat must be 3-D")
    _check_memory(enc, enc_proj, q)
    B, S, _ = enc.shape
    H, Kl = enc_proj.shape[-1], loc_feat.shape[-1]
    if loc_feat.shape[:2] != (B, S):
        raise ValueError(f"shape mismatch: loc_feat {tuple(loc_feat.shape)}, enc "
                         f"{tuple(enc.shape)}")
    if w_loc.shape != (Kl, H) or b_loc.shape != (H,) or w_score.numel() != H:
        raise ValueError(f"weights must be w_loc (Kl,H), b_loc (H,), w_score (H,); got "
                         f"{tuple(w_loc.shape)}, {tuple(b_loc.shape)}, {tuple(w_score.shape)}")
    _same_device((enc, enc_proj, q, loc_feat, w_loc, b_loc, w_score))
    if enc.device.type == "cpu":
        return attention_step_reference(enc, enc_proj, q, loc_feat, w_loc, b_loc, w_score,
                                        valid_len)
    if enc.device.type != "cuda":
        raise ValueError(f"unsupported device {enc.device}")
    _check_kernel_inputs(enc, enc_proj, (q, loc_feat, w_loc, b_loc, w_score))
    plan = launch_plan(B, 1, S, enc.shape[-1], H, Kl, enc.dtype, FEATURE)
    out = launch(FEATURE, plan, enc, enc_proj, q, loc_feat, w_loc, b_loc, w_score,
                 valid_len=valid_len)
    fused_attention_step.launches += 1
    return out


fused_attention_step.launches = 0


def coverage_attention_step(enc, enc_proj, q, mem, loc_conv_w, loc_conv_b, w_loc, b_loc,
                            w_score, valid_len=None):
    """One attention step with the location conv folded in; see the module
    docstring.

    enc (Bs,S,D) and enc_proj (Bs,S,H) at sample rows; q (Bs*K,H) with row
    b*K + k beam k of sample b; mem (Bs*K,S) f32, the coverage (or the last
    alignment); loc_conv_w (2*kernel_size+1, 1, Kl), loc_conv_b (Kl,), w_loc
    (Kl,H), b_loc (H,), w_score (H,) or (H,1).  Returns (context (Bs*K, D)
    float32, alpha (Bs*K, S) float32).  On CUDA tensors of which one needs
    a gradient (K = 1 only), through ``CoverageAttentionStepFn``: the
    backward is a kernel too."""
    K = _check_memory(enc, enc_proj, q)
    Bs, S, D = enc.shape
    H = enc_proj.shape[-1]
    if mem.shape != (Bs * K, S):
        raise ValueError(f"mem must be (rows of q, S) = {(Bs * K, S)}; got {tuple(mem.shape)}")
    if (loc_conv_w.dim() != 3 or loc_conv_w.shape[1] != 1 or loc_conv_w.shape[0] % 2 == 0
            or loc_conv_b.shape != loc_conv_w.shape[2:]):
        raise ValueError(f"loc_conv_w must be (odd k, 1, Kl) and loc_conv_b (Kl,); got "
                         f"{tuple(loc_conv_w.shape)}, {tuple(loc_conv_b.shape)}")
    taps, Kl = loc_conv_w.shape[0], loc_conv_w.shape[2]
    if w_loc.shape != (Kl, H) or b_loc.shape != (H,) or w_score.numel() != H:
        raise ValueError(f"weights must be w_loc (Kl,H), b_loc (H,), w_score (H,); got "
                         f"{tuple(w_loc.shape)}, {tuple(b_loc.shape)}, {tuple(w_score.shape)}")
    tensors = (enc, enc_proj, q, mem, loc_conv_w, loc_conv_b, w_loc, b_loc, w_score)
    _same_device(tensors)
    if enc.device.type == "cpu":
        return coverage_attention_step_reference(*tensors, valid_len=valid_len)
    if enc.device.type != "cuda":
        raise ValueError(f"unsupported device {enc.device}")
    _check_kernel_inputs(enc, enc_proj, tensors[2:])
    if torch.is_grad_enabled() and any(t.requires_grad for t in tensors):
        if K != 1:
            raise NotImplementedError(f"B2's backward takes K = 1 (the teacher-forced pass); "
                                      f"got K = {K} with a gradient")
        _check_backward_shape(D, H, taps, enc.dtype)
        return CoverageAttentionStepFn.apply(*tensors, valid_len)
    return _coverage_forward(tensors, valid_len)


coverage_attention_step.launches = 0


def _coverage_forward(tensors, valid_len):
    """The coverage form's kernel on checked CUDA tensors, counted."""
    enc, enc_proj, q, _, loc_conv_w = tensors[:5]
    Bs, S, D = enc.shape
    plan = launch_plan(Bs, q.shape[0] // Bs, S, D, enc_proj.shape[-1], loc_conv_w.shape[2],
                       enc.dtype, COVERAGE, loc_conv_w.shape[0])
    out = launch(COVERAGE, plan, *tensors, valid_len=valid_len)
    coverage_attention_step.launches += 1
    return out


class CoverageAttentionStepFn(torch.autograd.Function):
    """The coverage form with a gradient, at K = 1: forward the kernel of
    ``csrc/attention_step.cu``, saving the inputs and alpha (the memory is
    shared by every step, so saving it copies nothing); backward the kernel
    of ``csrc/attention_step_backward.cu``.  ``b_score`` is not an input
    (the decoder does not give the kernel the score bias, which moves no
    alpha), so it gets no gradient from here."""

    @staticmethod
    def forward(ctx, enc, enc_proj, q, mem, loc_conv_w, loc_conv_b, w_loc, b_loc, w_score,
                valid_len=None):
        tensors = (enc, enc_proj, q, mem, loc_conv_w, loc_conv_b, w_loc, b_loc, w_score)
        context, alpha = _coverage_forward(tensors, valid_len)
        ctx.save_for_backward(*tensors, alpha)
        return context, alpha

    @staticmethod
    def backward(ctx, g_context, g_alpha):
        enc, enc_proj, q, mem, conv_w, conv_b, w_loc, b_loc, w_score, alpha = ctx.saved_tensors
        grads = coverage_attention_step_backward(
            enc, enc_proj, q, mem, conv_w, conv_b, w_loc, w_score, b_loc, alpha,
            _aligned(g_context), _aligned(g_alpha))
        d_enc, d_enc_proj, d_q, d_mem, d_conv_w, d_conv_b, d_w_loc, d_b_loc, d_w_score = grads
        return (d_enc, d_enc_proj, d_q, d_mem, d_conv_w, d_conv_b, d_w_loc, d_b_loc,
                d_w_score.reshape(w_score.shape), None)


def _aligned(t):
    """A cotangent as the kernel takes it: contiguous and 16-byte aligned."""
    t = t.contiguous()
    return t if t.data_ptr() % 16 == 0 else t.clone()


def _check_backward_shape(D, H, taps, dtype):
    """What the backward kernel takes: the forward's widths and types."""
    if dtype not in _DTYPE_CODE:
        raise TypeError(f"backward kernel takes float32/bfloat16 memory; got {dtype}")
    if D != H or D not in WIDTHS:
        raise ValueError(f"backward kernel takes D = H in {WIDTHS}; got D={D}, H={H}")
    if not (0 < taps <= MAX_TAPS and taps % 2 == 1):
        raise ValueError(f"backward kernel takes a location conv of at most {MAX_TAPS} taps; "
                         f"got {taps}")


def backward_workspace_floats(B: int, S: int, H: int) -> int:
    """Float32 scratch of one backward launch (``csrc/attention_step_backward.cu``
    ``workspace_floats``): g_a (B, S), the chunks' sums (B, chunks), the
    location taps' gradient R (B, S, 5), the blocks' partials (B * chunks,
    BWD_VECS * H) and their sums (BWD_VECS * H)."""
    chunks = -(-S // BWD_CHUNK)
    return B * S + B * chunks + B * S * MAX_TAPS + (B * chunks + 1) * BWD_VECS * H


def coverage_attention_step_backward(enc, enc_proj, q, mem, loc_conv_w, loc_conv_b, w_loc,
                                     w_score, b_loc, alpha, g_context, g_alpha):
    """The coverage form's backward at K = 1: the arguments and results of
    ``coverage_attention_step_backward_reference``.  On CUDA tensors the
    hand-written kernel (four launches on the current stream, every sum in
    a fixed order, so two runs give the same bits); on CPU tensors the plain
    version.  Raises on what the kernel does not take: K > 1, D != H, widths
    outside WIDTHS, more than MAX_TAPS taps, memory other than float32 or
    bfloat16, and inputs that are not contiguous and 16-byte aligned."""
    args = (enc, enc_proj, q, mem, loc_conv_w, loc_conv_b, w_loc, w_score, b_loc, alpha,
            g_context, g_alpha)
    _same_device(args)
    if enc.device.type == "cpu":
        return coverage_attention_step_backward_reference(*args)
    if enc.device.type != "cuda":
        raise ValueError(f"unsupported device {enc.device}")
    K = _check_memory(enc, enc_proj, q)
    B, S, D = enc.shape
    H = enc_proj.shape[-1]
    taps, Kl = loc_conv_w.shape[0], loc_conv_w.shape[2]
    if K != 1:
        raise ValueError(f"backward kernel takes K = 1; got K = {K}")
    _check_backward_shape(D, H, taps, enc.dtype)
    if (mem.shape != (B, S) or alpha.shape != (B, S) or g_alpha.shape != (B, S)
            or g_context.shape != (B, D) or w_loc.shape != (Kl, H) or b_loc.shape != (H,)
            or w_score.numel() != H or loc_conv_b.shape != (Kl,)):
        raise ValueError("backward shapes: mem, alpha, g_alpha (B, S), g_context (B, D), "
                         "w_loc (Kl, H), b_loc (H,), w_score (H,), loc_conv_b (Kl,)")
    _check_kernel_inputs(enc, enc_proj, args[2:])
    f32 = dict(dtype=torch.float32, device=enc.device)
    outs = (torch.empty_like(enc), torch.empty_like(enc_proj), torch.empty(B, H, **f32),
            torch.empty(B, S, **f32), torch.empty(taps, 1, Kl, **f32), torch.empty(Kl, **f32),
            torch.empty(Kl, H, **f32), torch.empty(H, **f32), torch.empty(H, **f32))
    work = torch.empty(backward_workspace_floats(B, S, H), **f32)
    kernel = _backward_kernel()
    with torch.cuda.device(enc.device):
        rc = kernel(*(t.data_ptr() for t in args + outs), work.data_ptr(), work.numel(),
                    B, S, D, H, Kl, taps, _DTYPE_CODE[enc.dtype], BWD_CHUNK,
                    torch.cuda.current_stream(enc.device).cuda_stream)
    if rc != 0:
        raise RuntimeError(f"attention_step backward kernel launch failed at B={B} S={S} "
                           f"D={D}: CUDA error {rc}")
    coverage_attention_step_backward.launches += 1
    return outs


coverage_attention_step_backward.launches = 0


def _backward_kernel():
    lib, _ = load_library(BACKWARD_SOURCE)
    fn = lib.d2t_attention_step_coverage_backward
    fn.restype = ctypes.c_int
    fn.argtypes = ([ctypes.c_void_p] * 22 + [ctypes.c_longlong] + [ctypes.c_int] * 8
                   + [ctypes.c_void_p])
    return fn


def build_backward() -> dict:
    """Build (if needed) and load the backward kernel; returns ``load_library``'s info."""
    return load_library(BACKWARD_SOURCE)[1]


def launch(form: str, plan: LaunchPlan, enc, enc_proj, q, *loc_and_weights, valid_len=None,
           kernel=None):
    """Launch the kernel's ``form`` (or ``kernel``, a library function of
    the same C signature) with ``plan`` on checked CUDA tensors: after q,
    ``loc_feat, w_loc, b_loc, w_score`` (feature form) or ``mem,
    loc_conv_w, loc_conv_b, w_loc, b_loc, w_score`` (coverage form).
    Returns (context, alpha).  The callers count their launches."""
    Bs, S, D = enc.shape
    H = enc_proj.shape[-1]
    K = q.shape[0] // Bs
    w_loc = loc_and_weights[-3]
    kernel = kernel or _kernels()[0][form]
    ctx = torch.empty((Bs * K, D), dtype=torch.float32, device=enc.device)
    alpha = torch.empty((Bs * K, S), dtype=torch.float32, device=enc.device)
    shape = [Bs, K, S, D, H, w_loc.shape[0]]
    if form == COVERAGE:
        shape.append(loc_and_weights[1].shape[0])  # taps
    with torch.cuda.device(enc.device):
        rc = kernel(
            enc.data_ptr(), enc_proj.data_ptr(), q.data_ptr(),
            *(t.data_ptr() for t in loc_and_weights), ctx.data_ptr(), alpha.data_ptr(),
            *shape, _valid_code(valid_len), _DTYPE_CODE[enc.dtype], *plan,
            torch.cuda.current_stream(enc.device).cuda_stream,
        )
    if rc != 0:
        raise RuntimeError(f"attention_step kernel ({form} form) launch failed at Bs={Bs} "
                           f"K={K} S={S} D={D}: CUDA error {rc}")
    return ctx, alpha
