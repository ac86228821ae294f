"""One coverage-attention decode step of the LSTM head.

Per decode row r = b*K + k (beam k of sample b), over S encoder positions,
as the JAX package's ``doc2tex_tpu.ops.attention_step``:

    e[r,s]     = tanh(enc_proj[b,s] + q[r] + locH[r,s]) @ w_score
    e[r,s]     = -1e30 where s >= valid_len
    alpha[r,s] = softmax_s(e[r])
    context[r] = sum_s alpha[r,s] * enc[b,s]

in three forms of the location term ``locH``:

- ``fused_attention_step``, the TPU kernel's contract: ``locH = loc_feat @
  w_loc + b_loc`` from the location features (B, S, Kl), with the memory at
  the rows of q (K = 1);
- ``coverage_attention_step``, the decoder's main path: the location conv
  over the coverage ``mem`` (B*K, S) folded in, with the memory at sample
  rows (Bs, S, ·) and q at Bs*K rows.  Its plain version is the decoder's
  former step: ``location_features``, the memory repeated K times, then
  ``attention_step_reference``;
- ``content_attention_step``, the bahdanau head's step: no location term
  (``locH = 0``), the memory at sample rows as in the coverage form.

D (enc's width) and H (enc_proj's) are independent, as in the TPU
kernel's contract: H in {128, 256}, D in {128, 256, 512}.

The coverage and content forms also take int8 memory (the ``decoder_mem`` quantized
part): ``enc`` and ``enc_proj`` int8 with one float32 scale per sample,
``enc_scale`` and ``proj_scale`` (Bs, 1, 1), and the model's compute type,
as the JAX package's LSTM step reads them:

    enc_proj = round_to(compute type, enc_proj_int8 * round_to(compute type, proj_scale))
    context  = (sum_s alpha * enc_int8) * enc_scale                     (f32)

All run one hand-written CUDA kernel (``csrc/attention_step.cu``, the form a
template parameter, and the memory's type: its int8 form) on CUDA tensors,
with the grid ``launch_plan`` chooses, and their plain PyTorch versions on
CPU tensors.  The kernel is built twice: at D = H with D a compile-time
constant (the feature and coverage forms), and with ``WIDE_DEFINE`` at a
run-time D (D != H, and the content form).  None falls back from one to the other: on a CUDA tensor each
launches the kernel or raises.  ``coverage_attention_step.launches`` counts
the coverage form's float launches, ``.int8_launches`` its int8 ones;
``content_attention_step`` counts its own the same way.

Training: on a CUDA tensor that needs a gradient (K = 1, float memory),
``coverage_attention_step`` runs through ``CoverageAttentionStepFn`` and
``content_attention_step`` through ``ContentAttentionStepFn``.  Their
forward is the kernel above (saving the inputs and alpha, no (B, S, H)
tensor); their backward a second hand-written kernel
(``csrc/attention_step_backward.cu``: a clustered main pass and a finish
pass), ``coverage_attention_step_backward`` and
``content_attention_step_backward``, at every D and H the forward takes.
Their plain versions, ``coverage_attention_step_backward_reference`` and
``content_attention_step_backward_reference``, write the gradient out.  On
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
WIDE_DEFINE = "D2T_ATTENTION_STEP_WIDE"   # the build of SOURCE for D != H and the content form
BACKWARD_SOURCE = "attention_step_backward.cu"
NEG_INF = -1e30
WIDTHS = (128, 256)            # H the kernel is built for
D_WIDTHS = (128, 256, 512)     # D, enc's width, the forward takes
_DTYPE_CODE = {torch.float32: 0, torch.bfloat16: 2}   # the memory's type, or the compute type
_MEM_CODE = {**_DTYPE_CODE, torch.int8: 3}            # the memory's type (int8: coverage form)
FEATURE, COVERAGE, CONTENT = "feature", "coverage", "content"
_FORMS = (FEATURE, COVERAGE, CONTENT)

# The kernel's grid (csrc/attention_step.cu): per sample, `zsplit` groups of
# K / zsplit beams, each a cluster of up to MAX_CLUSTER blocks splitting S
# into chunks; a block takes its chunk's enc_proj, then enc, rows in tiles
# of `tile` positions, either through a ring of `stages` tiles or (stages
# FULL, the coverage and content forms) with the whole chunk in shared
# memory, every tile issued at once.
MAX_BEAM = 16             # beams a block holds (K / zsplit)
MAX_CLUSTER = 8           # portable cluster size
MAX_TAPS = 5              # the widest location conv: kernel_size 2
TILES = (32, 16)          # positions per tile, the first that fits
RED_FLOATS = 6144         # the kernel's scratch of partial sums
MISC_FLOATS = MAX_BEAM + 3 * MAX_BEAM * MAX_CLUSTER   # sums, rank factors, pushed (m, l)
CHUNK_ALIGN = 8           # a chunk is a multiple of this many positions
SMEM_LIMIT = 232_448      # dynamic shared memory a block may use on sm_90 (227 KB)
SMEM_PER_SM = 233_472     # an SM's shared memory; each block also takes 1 KB
SMS = 132                 # H100 SXM
FULL = 0                  # stages: the whole chunk in shared memory
# a whole-chunk plan leaves room for two blocks an SM: at one block an SM,
# clusters of 8 of the D = H = 256 int8 form at S 2525 did not all fit the
# card at once and took 1.46 times the ring's time (PERF.md §6)
FULL_LIMIT = SMEM_PER_SM // 2 - 1024
STAGES = 2                # ring tiles: deeper rings measured no faster


class PlanModel(NamedTuple):
    """launch_plan's model of a plan's time, one per row of PERF.md §6 (a
    form and memory type), fitted to its device times over every plan
    (tools/bench_attention_step.py --sweep; PERF.md §6): a block takes
    ``fixed_us`` (prologue, memory latency, cluster barrier, output) plus
    ``cluster_us`` for each block of its cluster, plus ``us_per_beam_position``
    for each of its beams x positions (H 128; H / 128 times that, and
    ``g1_factor`` times that when its beams are not in fives).  Blocks run
    in waves of SMS; two waves of clusters of at most 2 blocks share the
    SMs at ``co_resident`` of the time.  More than BIG_CLUSTERS clusters of
    7 or 8 blocks took ``big_cluster_us`` longer.  ``full``: plans may keep
    the whole chunk in shared memory where it fits; a ring of STAGES then
    costs ``ring_us`` more for each tile of the chunk (a memory round trip
    each)."""

    fixed_us: float
    cluster_us: float
    us_per_beam_position: float
    g1_factor: float
    co_resident: float
    full: bool
    ring_us: float = 0.0
    big_cluster_us: float = 4.0


BIG_CLUSTERS = 12
# the coverage form on float memory (bf16, H 128; fitted to its first sweep): a ring
COVERAGE_MODEL = PlanModel(9.4, 0.2, 0.0216, 2, 0.72, False)
# the content form on float memory (the bahdanau head: D 512, H 256, bf16):
# the least squares over its 184 plans at the zoo's launches
# (bench_attention_step --content --sweep, then --fit; PERF.md §6)
CONTENT_MODEL = PlanModel(7.6151, 0.1311, 0.0211, 1.0797, 0.72, True, 0.3524)
# the int8 memory form, coverage and content (bf16 compute): the best picks
# over its 404 plans at int8_full's launches, the release shape and D = H =
# 256 (--int8 --sweep, then --fit)
INT8_MODEL = PlanModel(7.2874, 0.1917, 0.0265, 2.0683, 0.6066, True, 0.5613, 6.0713)


class LaunchPlan(NamedTuple):
    """The kernel's grid: block r of a cluster owns positions [r * chunk,
    min(S, (r + 1) * chunk)) of the K / zsplit beams of its group."""

    cluster: int     # blocks per (sample, beam group), along S
    chunk: int       # positions per block, a multiple of CHUNK_ALIGN
    zsplit: int      # beam groups per sample
    tile: int        # positions per ring tile
    stages: int      # ring tiles, or FULL: the whole chunk
    smem_bytes: int  # dynamic shared memory per block


def _up16(x: int) -> int:
    return (x + 15) // 16 * 16


def smem_bytes(form: str, Kz: int, chunk: int, tile: int, stages: int, H: int, Kl: int,
               elem: int, D: int | None = None) -> int:
    """Dynamic shared memory of one block: ``make_layout`` of the kernel
    (D defaults to H; ``stages`` FULL: the whole chunk)."""
    D = H if D is None else D
    cov = form == COVERAGE
    feat = form == FEATURE
    if stages == FULL:   # the padded enc_proj rows, then the padded enc rows
        memory = _up16(chunk * (H * elem + 16)) + _up16(chunk * (D * elem + 16))
    else:
        memory = stages * (_up16(tile * (max(D, H) * elem + 16))
                           + (Kz * tile * (Kl * 4 + 16) if feat else 0))
    return (_up16((MAX_TAPS if cov else Kl if feat else 0) * H * 4)  # W' or w_loc
            + _up16((MAX_TAPS + 1) * Kl * 4 if cov else 0)       # conv_w, conv_b
            + _up16(Kz * H * 4)                                  # q + b'
            + _up16(H * 4)                                       # w_score
            + _up16(Kz * (chunk + MAX_TAPS - 1) * 4 if cov else 0)  # coverage and halo
            + _up16(Kz * chunk * 4)                              # f32 scores, then p
            + _up16((max(Kz * D, H) + MAX_CLUSTER) * 4)          # b_loc, then pushed context
            + RED_FLOATS * 4                                     # partial sums
            + _up16(MISC_FLOATS * 4)                             # sums, factors, (m, l)
            + memory)                                            # the ring or the chunk


def plan_model(form: str, dtype: torch.dtype) -> PlanModel:
    """The model ``launch_plan`` prices a call's plans with: int8 memory's,
    the content form's, else the coverage form's (the feature form too)."""
    if dtype == torch.int8:
        return INT8_MODEL
    return CONTENT_MODEL if form == CONTENT else COVERAGE_MODEL


def plan_cost(model: PlanModel, Bs: int, K: int, H: int, plan: LaunchPlan) -> float:
    """``model``'s µs for a plan (see PlanModel)."""
    cluster, chunk, zsplit, tile, stages, smem = plan
    Kz = K // zsplit
    waves = -(-Bs * zsplit * cluster // SMS)
    work = Kz * chunk * (H / 128) * (1 if Kz % 5 == 0 else model.g1_factor)
    block = model.fixed_us + model.cluster_us * cluster
    if stages != FULL:
        block += model.ring_us * 2 * -(-chunk // tile)
    if cluster >= 7 and Bs * zsplit > BIG_CLUSTERS:
        block += model.big_cluster_us
    if waves == 2 and cluster <= 2 and 2 * (smem + 1024) <= SMEM_PER_SM:
        return block + 2 * work * model.us_per_beam_position * model.co_resident
    return waves * (block + work * model.us_per_beam_position)


@functools.lru_cache(maxsize=None)
def launch_plan(Bs: int, K: int, S: int, D: int, H: int, Kl: int, dtype: torch.dtype,
                form: str = COVERAGE, taps: int = MAX_TAPS) -> LaunchPlan:
    """The kernel's grid for one call.  Over beam groups (zsplit dividing
    K, at most MAX_BEAM beams a block) and clusters of 1..MAX_CLUSTER
    blocks, each with the whole chunk in shared memory (stages FULL, tiles
    of 32) where its model allows it and two such blocks fit an SM
    (FULL_LIMIT), or a ring of STAGES tiles
    of the first size in TILES that fits, the plan of least modelled time
    (``plan_model``'s; see PlanModel); ties go to the smaller cluster, then
    the fewer groups, then the whole chunk.  Raises on what the kernel does not
    take: H outside WIDTHS, D outside D_WIDTHS, taps (2 * kernel_size + 1)
    above MAX_TAPS, Kl not a multiple of 4 in the feature form (and not 0
    in the content form, which has no location term), and an S that
    MAX_CLUSTER blocks cannot hold."""
    if dtype not in _DTYPE_CODE and not (dtype == torch.int8 and form != FEATURE):
        raise TypeError(f"kernel takes float32/bfloat16 memory (or int8 in the coverage "
                        f"and content forms); got {dtype}")
    if form not in _FORMS:
        raise ValueError(f"form must be one of {_FORMS}; got {form!r}")
    if H not in WIDTHS or D not in D_WIDTHS:
        raise ValueError(f"kernel takes D in {D_WIDTHS} and H in {WIDTHS}; got D={D}, H={H}")
    if form == COVERAGE and not (0 < taps <= MAX_TAPS and taps % 2 == 1):
        raise ValueError(f"kernel takes a location conv of at most {MAX_TAPS} taps "
                         f"(kernel_size <= {(MAX_TAPS - 1) // 2}); got {taps}")
    if (Kl != 0) if form == CONTENT else (Kl <= 0 or (form == FEATURE and Kl % 4)):
        raise ValueError(f"kernel takes Kl > 0 (a multiple of 4 in the feature form; 0 in the "
                         f"content form); got {Kl}")
    if Bs <= 0 or K <= 0 or S <= 0:
        raise ValueError(f"kernel takes samples, beams and S > 0; got {Bs}, {K}, {S}")
    elem = dtype.itemsize
    model = plan_model(form, dtype)
    best = None
    for zsplit in (z for z in range(1, K + 1) if K % z == 0 and K // z <= MAX_BEAM):
        Kz = K // zsplit
        for cluster in range(1, MAX_CLUSTER + 1):
            chunk = -(-(-(-S // cluster)) // CHUNK_ALIGN) * CHUNK_ALIGN
            if -(-S // chunk) != cluster:
                continue  # the same chunks as a smaller cluster
            ring = next(((t, STAGES, b) for t in TILES
                         if (b := smem_bytes(form, Kz, chunk, t, STAGES, H, Kl, elem, D))
                         <= SMEM_LIMIT), None)
            whole = smem_bytes(form, Kz, chunk, TILES[0], FULL, H, Kl, elem, D)
            for fit in ([(TILES[0], FULL, whole)] if model.full and whole <= FULL_LIMIT
                        else []) + ([ring] if ring else []):
                plan = LaunchPlan(cluster, chunk, zsplit, *fit)
                key = (plan_cost(model, Bs, K, H, plan), cluster, zsplit, plan.stages)
                if best is None or key < best[0]:
                    best = (key, plan)
    if best is None:
        raise ValueError(f"S={S} does not fit {MAX_CLUSTER} blocks of {SMEM_LIMIT} bytes "
                         f"({form} form, K={K}, D={D}, Kl={Kl}, {dtype})")
    return best[1]


# ---- plain versions ----------------------------------------------------------

def attention_step_reference(enc, enc_proj, q, loc_feat, w_loc, b_loc, w_score,
                             valid_len=None):
    """Plain PyTorch version: enc (B,S,D), enc_proj (B,S,H) in the compute
    type, q (B,H), loc_feat (B,S,Kl) float32, w_loc (Kl,H), b_loc (H,),
    w_score (H,) or (H,1) -> (context (B,D) f32, alpha (B,S) f32).  A
    ``loc_feat`` of None means no location term (the content form).  With
    a float64 q everything is float64 (the backward's tests)."""
    H = enc_proj.shape[-1]
    ft = torch.promote_types(q.dtype, torch.float32)
    x = enc_proj.to(ft) + q.to(ft)[:, None, :]
    if loc_feat is not None:
        x = x + (loc_feat.to(ft) @ w_loc.to(ft) + b_loc.to(ft))
    x = torch.tanh(x)
    e = (x @ w_score.to(ft).reshape(H, 1))[..., 0]
    if valid_len is not None:
        pos = torch.arange(e.shape[-1], device=e.device)
        e = e.masked_fill(pos[None, :] >= valid_len, NEG_INF)
    alpha = torch.softmax(e, dim=-1)
    context = torch.einsum("bs,bsd->bd", alpha, enc.to(ft))
    return context, alpha


def coverage_attention_step_int8_reference(enc, enc_proj, q, mem, loc_conv_w, loc_conv_b,
                                           w_loc, b_loc, w_score, valid_len, enc_scale,
                                           proj_scale, compute_dtype):
    """Plain PyTorch version of the coverage form on int8 memory: enc
    (Bs,S,D) and enc_proj (Bs,S,H) int8, enc_scale and proj_scale (Bs,1,1)
    float32, the rest as ``coverage_attention_step_reference``; the JAX
    package's LSTM step under ``decoder_mem``."""
    proj = enc_proj.to(compute_dtype) * proj_scale.to(compute_dtype)
    context, alpha = coverage_attention_step_reference(
        enc, proj, q, mem, loc_conv_w, loc_conv_b, w_loc, b_loc, w_score, valid_len)
    K = q.shape[0] // enc.shape[0]
    return context * enc_scale.reshape(-1, 1).repeat_interleave(K, dim=0), alpha


def _repeat_memory(enc, enc_proj, q):
    """The memory (Bs, S, .) repeated to the Bs*K rows of q."""
    K = q.shape[0] // enc.shape[0]
    if K > 1:
        enc, enc_proj = enc.repeat_interleave(K, dim=0), enc_proj.repeat_interleave(K, dim=0)
    return enc, enc_proj


def content_attention_step_reference(enc, enc_proj, q, w_score, valid_len=None):
    """Plain PyTorch version of the content form: enc (Bs,S,D) and enc_proj
    (Bs,S,H) at sample rows, q (Bs*K,H) -> (context (Bs*K,D) f32, alpha
    (Bs*K,S) f32); the JAX package's bahdanau step (a location of 0.0)."""
    enc, enc_proj = _repeat_memory(enc, enc_proj, q)
    return attention_step_reference(enc, enc_proj, q, None, None, None, w_score, valid_len)


def content_attention_step_int8_reference(enc, enc_proj, q, w_score, valid_len, enc_scale,
                                          proj_scale, compute_dtype):
    """The content form on int8 memory, as
    ``coverage_attention_step_int8_reference``."""
    proj = enc_proj.to(compute_dtype) * proj_scale.to(compute_dtype)
    context, alpha = content_attention_step_reference(enc, proj, q, w_score, valid_len)
    K = q.shape[0] // enc.shape[0]
    return context * enc_scale.reshape(-1, 1).repeat_interleave(K, dim=0), alpha


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
    enc, enc_proj = _repeat_memory(enc, enc_proj, q)
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


def content_attention_step_backward_reference(enc, enc_proj, q, w_score, alpha, g_context,
                                              g_alpha):
    """Plain PyTorch version of the content form's backward at K = 1 (the
    bahdanau head), written out rather than taken by autograd: the
    coverage form's with no location term,

        t = tanh(enc_proj + q),  g_a = g_alpha + enc . g_context,
        g_e = alpha (g_a - sum_s alpha g_a),  g_pre = g_e w_score (1 - t^2),
        d enc = alpha g_context,  d enc_proj = g_pre,  d q = sum_s g_pre,
        d w_score = sum g_e t.

    Computes in float32 (float64 for float64 inputs).  Returns (d enc and
    d enc_proj in their inputs' types, d q, d w_score in the compute
    type)."""
    if q.shape[0] != enc.shape[0]:
        raise ValueError(f"the backward takes K = 1: q {tuple(q.shape)}, enc {tuple(enc.shape)}")
    ft = torch.promote_types(q.dtype, torch.float32)
    H = enc_proj.shape[-1]
    a, g_ctx = alpha.to(ft), g_context.to(ft)
    t = torch.tanh(enc_proj.to(ft) + q.to(ft)[:, None, :])
    g_a = g_alpha.to(ft) + torch.einsum("bsd,bd->bs", enc.to(ft), g_ctx)
    g_e = a * (g_a - (a * g_a).sum(-1, keepdim=True))
    g_pre = g_e[..., None] * w_score.to(ft).reshape(H) * (1 - t * t)
    return ((a[..., None] * g_ctx[:, None, :]).to(enc.dtype), g_pre.to(enc_proj.dtype),
            g_pre.sum(1), torch.einsum("bs,bsh->h", g_e, t))


# ---- the kernel ----------------------------------------------------------------

def _kernels(wide: bool = False):
    """The plain build (D = H, feature and coverage forms) or, with
    ``wide``, the wide one (D a run-time width; every form)."""
    lib, info = load_library(SOURCE, (WIDE_DEFINE,) if wide else ())
    tail = [ctypes.c_int] * 6 + [ctypes.c_void_p]  # cluster .. smem_bytes, stream
    feat = lib.d2t_attention_step_features
    feat.restype = ctypes.c_int
    feat.argtypes = [ctypes.c_void_p] * 9 + [ctypes.c_int] * 8 + tail
    cov = lib.d2t_attention_step_coverage
    cov.restype = ctypes.c_int
    cov.argtypes = [ctypes.c_void_p] * 13 + [ctypes.c_int] * 10 + tail
    fns = {FEATURE: feat, COVERAGE: cov}
    if wide:
        content = lib.d2t_attention_step_content
        content.restype = ctypes.c_int
        content.argtypes = [ctypes.c_void_p] * 8 + [ctypes.c_int] * 8 + tail
        fns[CONTENT] = content
    return fns, info


def build() -> dict:
    """Build (if needed) and load the plain build; returns ``load_library``'s info."""
    return _kernels()[1]


def build_wide() -> dict:
    """Build (if needed) and load the wide build (D != H, the content form)."""
    return _kernels(wide=True)[1]


def launch_floor(plan: LaunchPlan, Bs: int, device=None) -> None:
    """An empty kernel on ``plan``'s grid for ``Bs`` samples, with its
    cluster and dynamic shared memory, on the current stream: what a launch
    of the step costs before any of its work (the tools time it beside the
    kernel).  Not a step: nothing is computed or counted."""
    device = torch.device("cuda") if device is None else torch.device(device)
    lib, _ = load_library(SOURCE, (WIDE_DEFINE,))
    fn = lib.d2t_attention_step_floor
    fn.restype = ctypes.c_int
    fn.argtypes = [ctypes.c_int] * 4 + [ctypes.c_void_p]
    with torch.cuda.device(device):
        rc = fn(plan.cluster, Bs, plan.zsplit, plan.smem_bytes,
                torch.cuda.current_stream(device).cuda_stream)
    if rc != 0:
        raise RuntimeError(f"attention_step floor kernel launch failed with {plan}: CUDA error {rc}")


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


def _check_kernel_inputs(enc, enc_proj, f32, int8=False):
    """What every launch needs beyond the plan: types, layout, alignment."""
    if enc.dtype != enc_proj.dtype or (enc.dtype not in _DTYPE_CODE
                                       and not (int8 and enc.dtype == torch.int8)):
        raise TypeError(f"enc and enc_proj must share float32 or bfloat16; got "
                        f"{enc.dtype}, {enc_proj.dtype}")
    if any(t.dtype != torch.float32 for t in f32):
        raise TypeError("q, the location input and the weights must be float32")
    tensors = (enc, enc_proj) + tuple(f32)
    if not all(t.is_contiguous() for t in tensors):
        raise ValueError("all inputs must be contiguous")
    if any(t.data_ptr() % 16 for t in tensors):
        raise ValueError("all inputs must be 16-byte aligned")


def _check_coverage(enc, enc_proj, q, mem, loc_conv_w, loc_conv_b, w_loc, b_loc, w_score):
    """The coverage form's shapes; returns K."""
    K = _check_memory(enc, enc_proj, q)
    Bs, S, _ = enc.shape
    H = enc_proj.shape[-1]
    if mem.shape != (Bs * K, S):
        raise ValueError(f"mem must be (rows of q, S) = {(Bs * K, S)}; got {tuple(mem.shape)}")
    if (loc_conv_w.dim() != 3 or loc_conv_w.shape[1] != 1 or loc_conv_w.shape[0] % 2 == 0
            or loc_conv_b.shape != loc_conv_w.shape[2:]):
        raise ValueError(f"loc_conv_w must be (odd k, 1, Kl) and loc_conv_b (Kl,); got "
                         f"{tuple(loc_conv_w.shape)}, {tuple(loc_conv_b.shape)}")
    Kl = loc_conv_w.shape[2]
    if w_loc.shape != (Kl, H) or b_loc.shape != (H,) or w_score.numel() != H:
        raise ValueError(f"weights must be w_loc (Kl,H), b_loc (H,), w_score (H,); got "
                         f"{tuple(w_loc.shape)}, {tuple(b_loc.shape)}, {tuple(w_score.shape)}")
    return K


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
                            w_score, valid_len=None, enc_scale=None, proj_scale=None,
                            compute_dtype=None):
    """One attention step with the location conv folded in; see the module
    docstring.

    enc (Bs,S,D) and enc_proj (Bs,S,H) at sample rows; q (Bs*K,H) with row
    b*K + k beam k of sample b; mem (Bs*K,S) f32, the coverage (or the last
    alignment); loc_conv_w (2*kernel_size+1, 1, Kl), loc_conv_b (Kl,), w_loc
    (Kl,H), b_loc (H,), w_score (H,) or (H,1).  Returns (context (Bs*K, D)
    float32, alpha (Bs*K, S) float32).  On CUDA tensors of which one needs
    a gradient (K = 1 only), through ``CoverageAttentionStepFn``: the
    backward is a kernel too.  Int8 memory comes with ``enc_scale`` and
    ``proj_scale`` (Bs, 1, 1) float32 and ``compute_dtype`` (float32 or
    bfloat16); it takes no gradient."""
    _check_coverage(enc, enc_proj, q, mem, loc_conv_w, loc_conv_b, w_loc, b_loc, w_score)
    return _memory_step(COVERAGE, (enc, enc_proj, q, mem, loc_conv_w, loc_conv_b, w_loc, b_loc,
                                   w_score), valid_len, enc_scale, proj_scale, compute_dtype)


coverage_attention_step.launches = 0
coverage_attention_step.int8_launches = 0


def content_attention_step(enc, enc_proj, q, w_score, valid_len=None, enc_scale=None,
                           proj_scale=None, compute_dtype=None):
    """One attention step with no location term (the bahdanau head); see
    the module docstring.  enc (Bs,S,D) and enc_proj (Bs,S,H) at sample
    rows, q (Bs*K,H), w_score (H,) or (H,1); int8 memory as in
    ``coverage_attention_step``.  Returns (context (Bs*K, D) float32, alpha
    (Bs*K, S) float32).  On CUDA tensors of which one needs a gradient (K =
    1 only), through ``ContentAttentionStepFn``: the backward is a kernel
    too."""
    _check_memory(enc, enc_proj, q)
    if w_score.numel() != enc_proj.shape[-1]:
        raise ValueError(f"w_score must have H = {enc_proj.shape[-1]} entries; got "
                         f"{tuple(w_score.shape)}")
    return _memory_step(CONTENT, (enc, enc_proj, q, w_score), valid_len, enc_scale, proj_scale,
                        compute_dtype)


content_attention_step.launches = 0
content_attention_step.int8_launches = 0

_STEPS = {COVERAGE: (coverage_attention_step, coverage_attention_step_reference,
                     coverage_attention_step_int8_reference),
          CONTENT: (content_attention_step, content_attention_step_reference,
                    content_attention_step_int8_reference)}


def _memory_step(form, tensors, valid_len, enc_scale, proj_scale, compute_dtype):
    """The body the coverage and content forms share, on shape-checked
    ``tensors`` (the form's arguments up to w_score): the plain version on
    the CPU; on the card the gradient's path (K = 1, float memory: the
    form's autograd function, both passes kernels), or the kernel,
    counted."""
    enc, enc_proj, q = tensors[:3]
    _, reference, int8_reference = _STEPS[form]
    scales = _check_int8(enc, enc_proj, enc_scale, proj_scale, compute_dtype)
    _same_device(tensors + scales)
    if enc.device.type == "cpu":
        if scales:
            return int8_reference(*tensors, valid_len, *scales, compute_dtype)
        return reference(*tensors, valid_len=valid_len)
    if enc.device.type != "cuda":
        raise ValueError(f"unsupported device {enc.device}")
    grad = torch.is_grad_enabled() and any(t.requires_grad for t in tensors)
    if grad and scales:
        raise NotImplementedError("int8 memory is an inference mode: B2's int8 form takes "
                                  "no gradient")
    scales = tuple(t.reshape(enc.shape[0]).contiguous() for t in scales)
    _check_kernel_inputs(enc, enc_proj, tensors[2:] + scales, int8=bool(scales))
    if grad:
        K = q.shape[0] // enc.shape[0]
        if K != 1:
            raise NotImplementedError(f"B2's backward takes K = 1 (the teacher-forced pass); "
                                      f"got K = {K} with a gradient")
        taps = tensors[4].shape[0] if form == COVERAGE else 0
        check_backward_widths(enc.shape[1], enc.shape[2], enc_proj.shape[-1], enc.dtype, form,
                              taps, tensors[4].shape[2] if form == COVERAGE else 0)
        fn = CoverageAttentionStepFn if form == COVERAGE else ContentAttentionStepFn
        return fn.apply(*tensors, valid_len)
    return _forward(form, tensors, valid_len, scales, compute_dtype)


def _check_int8(enc, enc_proj, enc_scale, proj_scale, compute_dtype):
    """The int8 memory's scales, () for float memory (no scales and no
    ``compute_dtype``)."""
    if enc_scale is None and proj_scale is None and compute_dtype is None:
        return ()
    if enc.dtype != torch.int8 or enc_proj.dtype != torch.int8:
        raise TypeError(f"with scales enc and enc_proj must be int8; got {enc.dtype}, "
                        f"{enc_proj.dtype}")
    if compute_dtype not in _DTYPE_CODE:
        raise TypeError(f"compute_dtype must be float32 or bfloat16; got {compute_dtype}")
    Bs = enc.shape[0]
    for t in (enc_scale, proj_scale):
        if t is None or t.dtype != torch.float32 or t.numel() != Bs:
            raise ValueError(f"enc_scale and proj_scale must be float32 (Bs, 1, 1) with Bs = "
                             f"{Bs}; got {None if t is None else (t.dtype, tuple(t.shape))}")
    return enc_scale, proj_scale


def _forward(form, tensors, valid_len, scales=(), compute_dtype=None):
    """The coverage or content form's kernel on checked CUDA tensors,
    counted; with ``scales`` (enc_scale, proj_scale) (Bs,) its int8 memory
    form."""
    enc, enc_proj, q = tensors[:3]
    Bs, S, D = enc.shape
    conv = tensors[4].shape if form == COVERAGE else (MAX_TAPS, 1, 0)   # (taps, 1, Kl)
    plan = launch_plan(Bs, q.shape[0] // Bs, S, D, enc_proj.shape[-1], conv[2], enc.dtype, form,
                       conv[0])
    out = launch(form, plan, *tensors, valid_len=valid_len, scales=scales,
                 compute_dtype=compute_dtype)
    step = _STEPS[form][0]
    if scales:
        step.int8_launches += 1
    else:
        step.launches += 1
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
        context, alpha = _forward(COVERAGE, tensors, valid_len)
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


class ContentAttentionStepFn(torch.autograd.Function):
    """The content form (the bahdanau head) with a gradient, at K = 1: as
    ``CoverageAttentionStepFn``, with no location term."""

    @staticmethod
    def forward(ctx, enc, enc_proj, q, w_score, valid_len=None):
        context, alpha = _forward(CONTENT, (enc, enc_proj, q, w_score), valid_len)
        ctx.save_for_backward(enc, enc_proj, q, w_score, alpha)
        return context, alpha

    @staticmethod
    def backward(ctx, g_context, g_alpha):
        enc, enc_proj, q, w_score, alpha = ctx.saved_tensors
        d_enc, d_enc_proj, d_q, d_w_score = content_attention_step_backward(
            enc, enc_proj, q, w_score, alpha, _aligned(g_context), _aligned(g_alpha))
        return d_enc, d_enc_proj, d_q, d_w_score.reshape(w_score.shape), None


def _aligned(t):
    """A cotangent as the kernel takes it: contiguous and 16-byte aligned."""
    t = t.contiguous()
    return t if t.data_ptr() % 16 == 0 else t.clone()


# The backward's grid (csrc/attention_step_backward.cu): per row a cluster of
# up to BWD_MAX_CLUSTER blocks splitting S into chunks (at least
# BWD_MIN_CLUSTER blocks, which share the fold of W'; more only where each
# gets a ring tile of positions), as many as leave every row's cluster on
# the card at once (cudaOccupancyMaxActiveClusters); each block streams its
# chunk through a ring of `stages` tiles of BWD_TILE positions, three where
# two blocks still fit an SM, else two.
BWD_TILE = 32             # positions per ring tile (8 warps x 4)
BWD_MAX_CLUSTER = 8       # portable cluster size
BWD_MIN_CLUSTER = 4       # ranks that share the fold (the last may own no positions)
BWD_MAX_CHUNK = 1024      # positions a block may own
BWD_VECS = {COVERAGE: 7, CONTENT: 2}   # a row's partial vectors of H: d q, d w_score, M[5]
BWD_TWO_BLOCKS = SMEM_PER_SM // 2 - 1024  # shared memory of a block when two share an SM


class BackwardPlan(NamedTuple):
    """The backward's grid: block r of a row's cluster owns positions
    [r * chunk, min(S, (r + 1) * chunk))."""

    cluster: int     # blocks per row, along S
    chunk: int       # positions per block
    stages: int      # ring tiles


def backward_smem_bytes(form: str, chunk: int, stages: int, D: int, H: int, elem: int) -> int:
    """Dynamic shared memory of one block of the backward's main pass:
    ``make_layout`` of the kernel."""
    cov = form == COVERAGE
    vecs = BWD_VECS[form]
    return (_up16(MAX_TAPS * H * 4 if cov else 0)                # W'
            + _up16(H * 4) * 2                                   # q + b', w_score
            + _up16(H * 4 if cov else 0)                         # conv_b . w_loc
            + _up16(chunk * 4) * 2                               # g_alpha then ge, alpha
            + _up16((chunk + MAX_TAPS - 1) * 4 if cov else 0)    # mem and its halo
            + _up16((H // 128) * chunk * MAX_TAPS * 4 if cov else 0)  # R
            + _up16((vecs * H + BWD_MAX_CLUSTER) * 4)            # the row's partials by rank
            + 8 * vecs * 128 * 4                                 # the warps' partials
            + _up16((BWD_MAX_CLUSTER + (MAX_TAPS - 1) * MAX_TAPS) * 4)  # rank slots, R halo
            + stages * BWD_TILE * (max(D, H) * elem + 16))       # the ring


@functools.lru_cache(maxsize=None)
def backward_plan(B: int, S: int, D: int, H: int, dtype: torch.dtype, form: str = COVERAGE,
                  taps: int = MAX_TAPS, Kl: int = 0) -> BackwardPlan:
    """The backward's grid for one call (see BWD_TILE): of the cluster
    sizes from 1 to the larger of BWD_MIN_CLUSTER and S / BWD_TILE (at
    most BWD_MAX_CLUSTER), the largest of those whose B clusters the card
    holds in the fewest waves (``backward_clusters``); chunk = S / cluster
    rounded up; the deepest ring (3, else 2 tiles) that leaves two blocks
    an SM, else one that fits.  Raises, before asking the card, on what
    the kernel does not take: memory other than float32 or bfloat16, D
    outside D_WIDTHS, H outside WIDTHS, a coverage conv of more than
    MAX_TAPS taps (or an even count), and an S that BWD_MAX_CLUSTER blocks
    cannot hold."""
    check_backward_widths(S, D, H, dtype, form, taps, Kl)
    if B <= 0:
        raise ValueError(f"backward kernel takes B > 0; got {B}")
    best = None
    top = min(BWD_MAX_CLUSTER, max(BWD_MIN_CLUSTER, -(-S // BWD_TILE)))
    for cluster in range(1, top + 1):
        chunk = max(-(-S // cluster), 2)
        if chunk > BWD_MAX_CHUNK:
            continue
        sizes = {stages: backward_smem_bytes(form, chunk, stages, D, H, dtype.itemsize)
                 for stages in (3, 2)}
        stages = next((n for n, b in sizes.items() if b <= BWD_TWO_BLOCKS),
                      next((n for n, b in sizes.items() if b <= SMEM_LIMIT), None))
        if stages is None:
            continue
        fits = backward_clusters(form, D, H, dtype, cluster, sizes[stages])
        key = (-(-B // max(fits, 1)), -cluster)
        if best is None or key < best[0]:
            best = (key, BackwardPlan(cluster, chunk, stages))
    if best is None:
        raise ValueError(f"S={S} at D={D}, H={H} does not fit {BWD_MAX_CLUSTER} blocks of "
                         f"{SMEM_LIMIT} bytes of shared memory")
    return best[1]


def check_backward_widths(S, D, H, dtype, form=COVERAGE, taps=MAX_TAPS, Kl=0):
    """Raise on what the backward kernel does not take (see ``backward_plan``)."""
    if dtype not in _DTYPE_CODE:
        raise TypeError(f"backward kernel takes float32/bfloat16 memory; got {dtype}")
    if form not in BWD_VECS:
        raise ValueError(f"backward kernel takes the coverage and content forms; got {form!r}")
    if H not in WIDTHS or D not in D_WIDTHS:
        raise ValueError(f"backward kernel takes D in {D_WIDTHS} and H in {WIDTHS}; got D={D}, "
                         f"H={H}")
    if form == COVERAGE and not (0 < taps <= MAX_TAPS and taps % 2 == 1 and Kl > 0):
        raise ValueError(f"backward kernel takes a location conv of at most {MAX_TAPS} taps "
                         f"and Kl > 0; got {taps} taps, Kl {Kl}")
    if S <= 0 or S > BWD_MAX_CLUSTER * BWD_MAX_CHUNK:
        raise ValueError(f"backward kernel takes 0 < S <= {BWD_MAX_CLUSTER * BWD_MAX_CHUNK}; "
                         f"got {S}")


def backward_workspace_floats(form: str, B: int, H: int) -> int:
    """Float32 scratch of one backward call (``csrc/attention_step_backward.cu``
    ``workspace_floats``): the rows' partial vectors (B, BWD_VECS, H)."""
    return B * BWD_VECS[form] * H


def _backward(form, enc, enc_proj, q, w_score, alpha, g_context, g_alpha, loc=None,
              kernel=None, plan=None):
    """The backward kernel of ``form`` (or ``kernel``, a library function
    of the same C signature; with ``plan`` in place of ``backward_plan``'s)
    on CUDA tensors, after its checks; ``loc`` =
    (mem, loc_conv_w, loc_conv_b, w_loc, b_loc) in the coverage form.
    Returns the kernel's outputs: (d enc, d enc_proj, d q, d w_score) and,
    in the coverage form, (d mem, d loc_conv_w, d loc_conv_b, d w_loc, d
    b_loc).  The callers count their launches."""
    K = _check_memory(enc, enc_proj, q)
    B, S, D = enc.shape
    H = enc_proj.shape[-1]
    if K != 1:
        raise ValueError(f"backward kernel takes K = 1; got K = {K}")
    mem, conv_w, conv_b, w_loc, b_loc = loc or (None,) * 5
    taps, Kl = (conv_w.shape[0], conv_w.shape[2]) if loc else (0, 0)
    plan = plan or backward_plan(B, S, D, H, enc.dtype, form, taps, Kl)
    if (alpha.shape != (B, S) or g_alpha.shape != (B, S) or g_context.shape != (B, D)
            or w_score.numel() != H or (loc and (
                mem.shape != (B, S) or w_loc.shape != (Kl, H) or b_loc.shape != (H,)
                or conv_w.shape[1] != 1 or conv_b.shape != (Kl,)))):
        raise ValueError("backward shapes: alpha, g_alpha (B, S), g_context (B, D), w_score "
                         "(H,); coverage: mem (B, S), loc_conv_w (taps, 1, Kl), loc_conv_b "
                         "(Kl,), w_loc (Kl, H), b_loc (H,)")
    ins = (q, w_score, alpha, g_context, g_alpha) + tuple(loc or ())
    _check_kernel_inputs(enc, enc_proj, ins)
    f32 = dict(dtype=torch.float32, device=enc.device)
    outs = [torch.empty_like(enc), torch.empty_like(enc_proj), torch.empty(B, H, **f32),
            torch.empty(H, **f32)]
    if loc:
        outs += [torch.empty(B, S, **f32), torch.empty(taps, 1, Kl, **f32),
                 torch.empty(Kl, **f32), torch.empty(Kl, H, **f32), torch.empty(H, **f32)]
    work = torch.empty(backward_workspace_floats(form, B, H), **f32)
    ptr = lambda t: None if t is None else t.data_ptr()  # noqa: E731
    d_enc, d_enc_proj, d_q, d_w_score, *d_loc = outs
    d_mem, d_conv_w, d_conv_b, d_w_loc, d_b_loc = d_loc or (None,) * 5
    with torch.cuda.device(enc.device):
        rc = (kernel or _backward_kernel())(
            1 if form == COVERAGE else 2,
            *map(ptr, (enc, enc_proj, q, mem, conv_w, conv_b, w_loc, w_score, b_loc, alpha,
                       g_context, g_alpha, d_enc, d_enc_proj, d_q, d_mem, d_conv_w, d_conv_b,
                       d_w_loc, d_b_loc, d_w_score, work)),
            work.numel(), B, S, D, H, Kl, taps, _DTYPE_CODE[enc.dtype], *plan,
            torch.cuda.current_stream(enc.device).cuda_stream)
    if rc != 0:
        raise RuntimeError(f"attention_step backward kernel ({form} form) launch failed at B={B} "
                           f"S={S} D={D} H={H}: CUDA error {rc}")
    return outs


def coverage_attention_step_backward(enc, enc_proj, q, mem, loc_conv_w, loc_conv_b, w_loc,
                                     w_score, b_loc, alpha, g_context, g_alpha):
    """The coverage form's backward at K = 1: the arguments and results of
    ``coverage_attention_step_backward_reference``.  On CUDA tensors the
    hand-written kernel (two launches on the current stream, every sum in a
    fixed order, so two runs give the same bits); on CPU tensors the plain
    version.  Raises on what the kernel does not take: K > 1, D outside
    D_WIDTHS, H outside WIDTHS, more than MAX_TAPS taps, memory other than
    float32 or bfloat16, and inputs that are not contiguous and 16-byte
    aligned."""
    args = (enc, enc_proj, q, mem, loc_conv_w, loc_conv_b, w_loc, w_score, b_loc, alpha,
            g_context, g_alpha)
    _same_device(args)
    if enc.device.type == "cpu":
        return coverage_attention_step_backward_reference(*args)
    if enc.device.type != "cuda":
        raise ValueError(f"unsupported device {enc.device}")
    d_enc, d_enc_proj, d_q, d_w_score, d_mem, d_conv_w, d_conv_b, d_w_loc, d_b_loc = _backward(
        COVERAGE, enc, enc_proj, q, w_score, alpha, g_context, g_alpha,
        (mem, loc_conv_w, loc_conv_b, w_loc, b_loc))
    coverage_attention_step_backward.launches += 1
    return d_enc, d_enc_proj, d_q, d_mem, d_conv_w, d_conv_b, d_w_loc, d_b_loc, d_w_score


coverage_attention_step_backward.launches = 0


def content_attention_step_backward(enc, enc_proj, q, w_score, alpha, g_context, g_alpha):
    """The content form's backward at K = 1: the arguments and results of
    ``content_attention_step_backward_reference``; on CUDA tensors the
    kernel of ``coverage_attention_step_backward`` in its content form, on
    CPU tensors the plain version.  Raises as that one does."""
    args = (enc, enc_proj, q, w_score, alpha, g_context, g_alpha)
    _same_device(args)
    if enc.device.type == "cpu":
        return content_attention_step_backward_reference(*args)
    if enc.device.type != "cuda":
        raise ValueError(f"unsupported device {enc.device}")
    outs = _backward(CONTENT, *args)
    content_attention_step_backward.launches += 1
    return tuple(outs)


content_attention_step_backward.launches = 0


def _backward_kernel(lib=None):
    """The backward's C function, of this build or of ``lib``."""
    fn = (lib or load_library(BACKWARD_SOURCE)[0]).d2t_attention_step_backward
    fn.restype = ctypes.c_int
    fn.argtypes = ([ctypes.c_int] + [ctypes.c_void_p] * 22 + [ctypes.c_longlong]
                   + [ctypes.c_int] * 10 + [ctypes.c_void_p])
    return fn


def backward_clusters(form: str, D: int, H: int, dtype: torch.dtype, cluster: int,
                      smem: int) -> int:
    """How many clusters of ``cluster`` blocks of the backward's main pass,
    each with ``smem`` bytes of dynamic shared memory, the current card
    holds at once (``cudaOccupancyMaxActiveClusters``)."""
    lib, _ = load_library(BACKWARD_SOURCE)
    fn = lib.d2t_attention_step_backward_clusters
    fn.restype = ctypes.c_int
    fn.argtypes = [ctypes.c_int] * 6 + [ctypes.c_void_p]
    out = ctypes.c_int(0)
    rc = fn(1 if form == COVERAGE else 2, D, H, _DTYPE_CODE[dtype], cluster, smem,
            ctypes.addressof(out))
    if rc != 0:
        raise RuntimeError(f"cudaOccupancyMaxActiveClusters failed: CUDA error {rc}")
    return out.value


def build_backward() -> dict:
    """Build (if needed) and load the backward kernel; returns ``load_library``'s info."""
    return load_library(BACKWARD_SOURCE)[1]


def launch(form: str, plan: LaunchPlan, enc, enc_proj, q, *loc_and_weights, valid_len=None,
           kernel=None, scales=(), compute_dtype=None):
    """Launch the kernel's ``form`` (or ``kernel``, a library function of
    the same C signature) with ``plan`` on checked CUDA tensors: after q,
    ``loc_feat, w_loc, b_loc, w_score`` (feature form), ``mem, loc_conv_w,
    loc_conv_b, w_loc, b_loc, w_score`` (coverage form) or ``w_score``
    (content form); the coverage and content forms on int8 memory with
    ``scales`` = (enc_scale, proj_scale) (Bs,) float32 and
    ``compute_dtype``.  The plain build at D = H, else the wide one.
    Returns (context, alpha).  The callers count their launches."""
    Bs, S, D = enc.shape
    H = enc_proj.shape[-1]
    K = q.shape[0] // Bs
    kernel = kernel or _kernels(wide=form == CONTENT or D != H)[0][form]
    ctx = torch.empty((Bs * K, D), dtype=torch.float32, device=enc.device)
    alpha = torch.empty((Bs * K, S), dtype=torch.float32, device=enc.device)
    shape = [Bs, K, S, D, H]
    codes = [_MEM_CODE[enc.dtype]]
    pointers = [t.data_ptr() for t in loc_and_weights]
    if form != CONTENT:
        shape.append(loc_and_weights[-3].shape[0])  # Kl, the rows of w_loc
    if form == COVERAGE:
        shape.append(loc_and_weights[1].shape[0])   # taps
    if form != FEATURE:
        pointers += [t.data_ptr() for t in scales] if scales else [None, None]
        codes.append(_DTYPE_CODE[compute_dtype or enc.dtype])
    with torch.cuda.device(enc.device):
        rc = kernel(
            enc.data_ptr(), enc_proj.data_ptr(), q.data_ptr(), *pointers, ctx.data_ptr(),
            alpha.data_ptr(), *shape, _valid_code(valid_len), *codes, *plan,
            torch.cuda.current_stream(enc.device).cuda_stream,
        )
    if rc != 0:
        raise RuntimeError(f"attention_step kernel ({form} form) launch failed at Bs={Bs} "
                           f"K={K} S={S} D={D} H={H}: CUDA error {rc}")
    return ctx, alpha
