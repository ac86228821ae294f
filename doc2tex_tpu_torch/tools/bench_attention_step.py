"""Device time of the coverage-attention step (B2) on a CUDA card.

    python -m doc2tex_tpu_torch.tools.bench_attention_step [--sweep] [--phases]
        [--against OTHER_CHECKOUT]
    python -m doc2tex_tpu_torch.tools.bench_attention_step --backward [--sweep] [--phases]
        [--against OTHER_CHECKOUT]
    python -m doc2tex_tpu_torch.tools.bench_attention_step --content|--int8 [--sweep]
        [--phases] [--against OTHER_CHECKOUT]
    python -m doc2tex_tpu_torch.tools.bench_attention_step --fit chiprun_out/b2_sweep_int8.json

Times both forms of the kernel in bf16 at the shapes of the ``synthetic``
main path (the batches of 8 and 1 samples at beam 10 that its golden crops
give, ``chip_smoke.lstm_launch_shapes``) and at the release shape (64 crops
x beam 10, S 623), D = H = 128, Kl 64, on the coverage of decode step 150:

- the coverage form, the main path's: memory at sample rows, location conv
  folded in, with ``launch_plan``'s grid;
- the feature form, the TPU kernel's contract: memory at the B*K rows of q
  and the location features given (the conv not counted).

Each time is one call's share of a CUDA graph of 20 calls, so no host time
between launches is counted.  ``--sweep`` also times the coverage form at
every plan that fits and prints the fastest beside ``launch_plan``'s.
``--phases`` builds a copy of the kernel with a device timestamp at each
phase boundary and prints each phase's mean over the blocks.
``--against`` times another checkout's coverage form on the same inputs, at
these shapes and at the zoo's D = H = 256 (8 samples x beam 10, S 241, Kl
128), in the order other, this, this, other, each in its own process.
Prints one line per shape with the card's name and power limit first.

``--backward`` times B2's backward instead (``csrc/attention_step_backward.cu``,
K = 1, bf16 memory, the inputs of ``backward_args``): the coverage form at
the ``synthetic`` recipe's launches (``BWD_SHAPES``: its largest, 32
samples x S 623, and the small shapes its soak launched; D = H = 128, Kl
64) and at the reference widths (32 x S 623 and 8 x S 2525, D = H = 256,
Kl 128), the coverage form at D 512, H 256 and the content form (the zoo's
bahdanau head, D 512, H 256).  Each time is a call's share of a CUDA graph
of 20 calls; beside it the device time of each of its two kernels (under
``torch.profiler``); with ``--sweep`` the time at every cluster size
beside the number of such clusters the card holds at once; with
``--phases`` the mean of each phase of the main pass over its blocks.  ``--against`` times another checkout's
coverage-form backward in this same process (its package loaded under
another name, its kernel built from its own sources) on the same inputs,
in the order other, this, this, other.

``--content`` times B2's content form (the bahdanau head of
``zoo_vgg_bahdanau``: D 512, H 256, bf16 memory, no location term) at the
zoo's launched shapes (``CONTENT_SHAPES``: 1 sample x beam 10, S 47-207)
and at training's forward (8 samples, K = 1, S 207).  ``--int8`` times the
int8 memory form (bf16 compute, coverage form) at the ``synthetic``
``int8_full`` launches, the release shape and D = H = 256 (``INT8_SHAPES``;
Kl 64, 128), the bf16-memory coverage form at the same inputs beside it,
and the content form on int8 memory at the zoo's largest shape.  In both
modes every time is a call's share of a CUDA graph of 20 calls, printed
beside the plan, the bound of the work and the launch floor: an empty
kernel on the same grid, cluster and dynamic shared memory in a graph of
20 (``attention_step.launch_floor``), what no kernel on that plan can go
under.  ``--sweep`` times every plan (whole chunk and ring, every cluster
and beam split) and writes them to ``chiprun_out/b2_sweep_<mode>.json``;
``--phases`` prints each phase's mean over the blocks; ``--against`` times
the other checkout's step on the same inputs in this process (other, this,
this, other).  ``--fit SWEEP_JSON`` fits ``launch_plan``'s model of each
row in a sweep's file (``fit_plan_model``) and says how far its picks are
from the fastest plans; it needs no card.  The rest needs a card and fails
without one.
"""

from __future__ import annotations

import argparse
import ctypes
import inspect
import json
import os
import subprocess
import sys
from typing import NamedTuple

import numpy as np
import torch

from .. import _build
from ..ops import attention_step as b2
from .bench_decode_attention import graph_ms
from .profile_slice import _device_us

SHAPES = (  # (samples, K, S): the synthetic slice's launches, then the release shape
    (1, 10, 623), (8, 10, 135), (8, 10, 225), (8, 10, 267), (8, 10, 445), (64, 10, 623),
)
D, KL, STEP = 128, 64, 150
# --against: (samples, K, S, D = H, Kl)
AGAINST_SHAPES = tuple((Bs, K, S, D, KL) for Bs, K, S in SHAPES) + ((8, 10, 241, 256, 128),)
PHASES = ("prologue issue", "prologue wait and staging", "scores", "block softmax", "context",
          "context sums and pushes", "exchange barrier", "output", "alpha")
# phase boundaries in csrc/attention_step.cu: (text, stamp after it)
HOOKS = (("  extern __shared__ __align__(16) unsigned char smem[];\n", True),
         ("  cp_async_wait(pro_pending);  // the prologue's group", False),
         ("  // ---- scores, a tile at a time", False),
         ("  // ---- the block's softmax", False),
         ("  // ---- context, unnormalised", False),
         ("  // the position groups' sums meet in red", False),
         ("  // ---- the one exchange", False),
         ("  if (tid < Kz * C) {  // thread (k, c)", False),
         ("  // alpha = p exp(m_r - m) / l", False),
         ("      alpha[(row0 + k) * S + lo + s] = fmaf(fmaf(-q0, l, x), inv, q0);\n    }\n  }\n",
          True))
STAMP_SLOTS = 12   # stamps a block keeps (the most any HOOKS has)
# --content: the zoo's bahdanau launches (samples, K, S), D 512, H 256, then
# training's forward (K = 1)
CONTENT_SHAPES = ((1, 10, 47), (1, 10, 63), (1, 10, 95), (1, 10, 143), (1, 10, 207),
                  (8, 1, 207))
CONTENT_D, CONTENT_H = 512, 256
# --int8: (samples, K, S, D = H, Kl): synthetic's int8_full launches, the
# release shape, the reference widths
INT8_SHAPES = tuple((Bs, K, S, 128, 64) for Bs, K, S in SHAPES) + (
    (8, 10, 623, 256, 128), (8, 10, 2525, 256, 128))


def inputs(Bs, K, S, D=128, Kl=64, step=150, seed=7):
    """bf16 memory at sample rows and float32 q, coverage (the sum of
    ``step`` softmax rows) and weights at the released ``synthetic`` head's
    scales, on the card; the same in every process (a CPU generator)."""
    g = torch.Generator().manual_seed(seed)

    def randn(*shape, scale=1.0):
        return torch.randn(*shape, generator=g) * scale

    mem = torch.zeros(Bs * K, S)
    for _ in range(step):
        mem += torch.softmax(randn(Bs * K, S, scale=3.0), dim=-1)
    kw = dict(enc=randn(Bs, S, D).bfloat16(), enc_proj=randn(Bs, S, D, scale=1.5).bfloat16(),
              q=randn(Bs * K, D, scale=1.5), mem=mem, loc_conv_w=randn(5, 1, Kl, scale=0.5),
              loc_conv_b=randn(Kl, scale=0.1), w_loc=randn(Kl, D, scale=0.35),
              b_loc=randn(D, scale=0.17), w_score=randn(D, 1, scale=0.4))
    return {k: v.cuda() for k, v in kw.items()}


def time_coverage(shapes) -> dict:
    """µs per call of the checkout's coverage form at ``shapes`` ((samples,
    K, S, D = H, Kl)), keyed by the shape's repr."""
    from doc2tex_tpu_torch.ops.attention_step import coverage_attention_step

    out = {}
    for Bs, K, S, D, Kl in shapes:
        kw = inputs(Bs, K, S, D, Kl)
        out[repr((Bs, K, S, D, Kl))] = graph_ms(lambda: coverage_attention_step(**kw)) * 1e3
    return out


def time_other(checkout: str) -> dict:
    """time_coverage in a process of its own that imports only ``checkout``."""
    code = "\n".join([
        "import json, torch", inspect.getsource(inputs), inspect.getsource(graph_ms),
        inspect.getsource(time_coverage),
        f"print(json.dumps(time_coverage({AGAINST_SHAPES!r})))",
    ])
    env = dict(os.environ, PYTHONPATH=os.path.abspath(checkout))
    proc = subprocess.run([sys.executable, "-c", code], cwd=checkout, env=env,
                          capture_output=True, text=True, timeout=900)
    if proc.returncode:
        raise RuntimeError(f"timing {checkout} failed:\n{proc.stderr}")
    return json.loads(proc.stdout.strip().splitlines()[-1])


def plans(Bs, K, S):
    """Every coverage-form plan that fits (the plan's grid with every
    cluster size and beam split; tiles of 32, the whole chunk or a ring)."""
    for zsplit in (z for z in range(1, K + 1) if K % z == 0 and K // z <= b2.MAX_BEAM):
        for cluster in range(1, b2.MAX_CLUSTER + 1):
            chunk = -(-(-(-S // cluster)) // b2.CHUNK_ALIGN) * b2.CHUNK_ALIGN
            if -(-S // chunk) != cluster:
                continue
            for stages in (b2.FULL, 2, 4, 8):
                smem = b2.smem_bytes(b2.COVERAGE, K // zsplit, chunk, 32, stages, D, KL, 2)
                if smem <= b2.SMEM_LIMIT:
                    yield b2.LaunchPlan(cluster, chunk, zsplit, 32, stages, smem)


def _stamped_library(source, hooks, stem, defines=()):
    """A copy of ``source`` with a %globaltimer stamp at each of ``hooks``
    (thread 0 of every block), built into build/ with ``defines``."""
    with open(os.path.join(_build.CSRC, source)) as f:
        src = f.read()
    for text, after in hooks:
        if text not in src:
            raise RuntimeError(f"phase boundary not found in the kernel: {text!r}")
    for i, (text, after) in enumerate(hooks):
        src = src.replace(text, text + f"  STAMP({i});\n" if after else f"  STAMP({i});\n" + text, 1)
    src = src.replace("namespace {\n", f"#define D2T_STAMP_SLOTS {STAMP_SLOTS}\n" + r'''__device__ unsigned long long d2t_stamps[16384][D2T_STAMP_SLOTS];
#define STAMP(i) do { if (threadIdx.x == 0) { unsigned long long t_; \
  asm volatile("mov.u64 %0, %%globaltimer;" : "=l"(t_)); \
  const unsigned b_ = (blockIdx.z * gridDim.y + blockIdx.y) * gridDim.x + blockIdx.x; \
  if (b_ < 16384) d2t_stamps[b_][i] = t_; } } while (0)
namespace {
''', 1) + '''
extern "C" int d2t_read_stamps(void* host) {
  return (int)cudaMemcpyFromSymbol(host, d2t_stamps, sizeof(d2t_stamps));
}
'''
    os.makedirs(_build.BUILD_DIR, exist_ok=True)
    path = os.path.join(_build.BUILD_DIR, stem)
    with open(path + ".cu", "w") as f:
        f.write(src)
    flags = [f for f in _build.NVCC_FLAGS if f not in ("-Xptxas", "-v")]
    flags += [f"-D{d}" for d in defines]
    proc = subprocess.run([_build._nvcc(), *flags, "-o", path + ".so", path + ".cu"],
                          capture_output=True, text=True, timeout=_build.NVCC_TIMEOUT_S)
    if proc.returncode:
        raise RuntimeError(proc.stderr)
    return ctypes.CDLL(path + ".so")


def timed_library(wide=False):
    """A copy of the kernel (the wide build with ``wide``) with a
    %globaltimer stamp at each phase boundary (thread 0 of every block),
    built into build/."""
    lib = _stamped_library(b2.SOURCE, HOOKS, "attention_step_phases" + "_wide" * wide,
                           (b2.WIDE_DEFINE,) if wide else ())
    fn = lib.d2t_attention_step_coverage
    fn.restype = ctypes.c_int
    fn.argtypes = [ctypes.c_void_p] * 13 + [ctypes.c_int] * 16 + [ctypes.c_void_p]
    if wide:
        fn = lib.d2t_attention_step_content
        fn.restype = ctypes.c_int
        fn.argtypes = [ctypes.c_void_p] * 8 + [ctypes.c_int] * 14 + [ctypes.c_void_p]
    return lib


def _phase_text(lib, call, n_blocks, names) -> str:
    """Each phase's mean over the ``n_blocks`` blocks of ``call``'s last launch."""
    for _ in range(3):
        call()
    torch.cuda.synchronize()
    stamps = np.zeros((16384, STAMP_SLOTS), dtype=np.uint64)
    if lib.d2t_read_stamps(ctypes.c_void_p(stamps.ctypes.data)):
        raise RuntimeError("reading the stamps failed")
    n = len(names) + 1
    t = stamps[:n_blocks, :n].astype(np.int64)
    t0 = t[:, 0].min()
    d = np.diff(t, axis=1).mean(axis=0) / 1e3
    return (f"    phases (µs, mean of blocks): "
            + ", ".join(f"{name} {x:.2f}" for name, x in zip(names, d))
            + f"; block {(t[:, -1] - t[:, 0]).mean() / 1e3:.1f} µs; last block starts at "
            f"{(t[:, 0].max() - t0) / 1e3:.1f} µs; kernel {(t[:, -1].max() - t0) / 1e3:.1f} µs")


def phase_line(lib, kw, plan) -> str:
    call = lambda: b2.launch(b2.COVERAGE, plan, *kw.values(),  # noqa: E731
                             kernel=lib.d2t_attention_step_coverage)
    return _phase_text(lib, call, kw["enc"].shape[0] * plan.zsplit * plan.cluster, PHASES)


def ptxas_summary(info: dict) -> str:
    """Registers, stack and spills of each kernel instance, from nvcc's
    -Xptxas -v report of this process's build."""
    if not info["built"]:
        return f"kernel loaded from {info['path']} (built earlier: no ptxas report)"
    lines, name = [], None
    for line in info["ptxas"].splitlines():
        if "Compiling entry function" in line:
            name = line.split("'")[1] if "'" in line else line.strip()
        elif name and ("spill" in line or "registers" in line):
            lines.append(f"{name}: {line.split(':', 1)[-1].strip()}")
    return "ptxas:\n  " + "\n  ".join(lines)


# ---- the content form and the int8 memory form ----------------------------------

HBM_BYTES_PER_S = 3.35e12    # H100 SXM HBM3
F32_FLOPS = 67e12            # H100 SXM float32 rate outside the tensor cores


def floor_us(plan, Bs) -> float:
    """µs per launch of an empty kernel on ``plan``'s grid, cluster and
    shared memory, in a CUDA graph of 20."""
    return graph_ms(lambda: b2.launch_floor(plan, Bs)) * 1e3


def bound_us(nbytes, flops) -> tuple[float, str]:
    """The least time of the work: its bytes at HBM's rate or its float32
    operations at the card's rate, the larger, and which."""
    by, op = nbytes / HBM_BYTES_PER_S * 1e6, flops / F32_FLOPS * 1e6
    return (by, "bytes") if by >= op else (op, "operations")


class Case(NamedTuple):
    """One timed row: the form, the step's keywords (int8 ones included),
    the arguments of ``b2.launch`` after the plan, and the plan's sizes."""

    form: str
    kw: dict
    launch_args: tuple
    launch_kw: dict
    Bs: int
    K: int
    S: int
    D: int
    H: int
    Kl: int
    dtype: torch.dtype
    nbytes: int
    flops: int

    def step(self, module=b2):
        fn = (module.content_attention_step if self.form == b2.CONTENT
              else module.coverage_attention_step)
        return lambda: fn(**self.kw)

    def plan(self):
        return b2.launch_plan(self.Bs, self.K, self.S, self.D, self.H, self.Kl, self.dtype,
                              self.form, 5 if self.form == b2.COVERAGE else 0)

    def with_plan(self, plan, kernel=None):
        return lambda: b2.launch(self.form, plan, *self.launch_args, kernel=kernel,
                                 **self.launch_kw)


def content_case(Bs, K, S, D=CONTENT_D, H=CONTENT_H, int8=False, seed=7) -> Case:
    """The content form's inputs (those of ``inputs`` at D != H, bf16 memory;
    with ``int8`` quantized per sample as the decoder stores it, bf16
    compute)."""
    kw = inputs(Bs, K, S, D, seed=seed)
    g = torch.Generator().manual_seed(seed + 2)
    proj = (torch.randn(Bs, S, H, generator=g) * 1.5).bfloat16().cuda()
    q = (torch.randn(Bs * K, H, generator=g) * 1.5).cuda()
    w_score = (torch.randn(H, 1, generator=g) * 0.4).cuda()
    step = dict(enc=kw["enc"], enc_proj=proj, q=q, w_score=w_score)
    return _case(b2.CONTENT, step, (q, w_score), Bs, K, S, D, H, 0, int8,
                 flops=Bs * K * S * (5 * H + 3 + 2 * D))


def coverage_case(Bs, K, S, D=128, Kl=64, int8=False, seed=7) -> Case:
    """The coverage form's inputs of ``inputs`` (D = H; with ``int8`` the
    memory quantized per sample, bf16 compute)."""
    kw = inputs(Bs, K, S, D, Kl, seed=seed)
    rest = tuple(kw[k] for k in ("q", "mem", "loc_conv_w", "loc_conv_b", "w_loc", "b_loc",
                                 "w_score"))
    return _case(b2.COVERAGE, kw, rest, Bs, K, S, D, D, Kl, int8,
                 flops=Bs * K * S * (2 * 5 * D + 5 * D + 3 + 2 * D))


def _case(form, kw, rest, Bs, K, S, D, H, Kl, int8, flops) -> Case:
    from ..ops.quant import quantize_memory

    launch_kw = {}
    dtype = kw["enc"].dtype
    if int8:
        enc, es = quantize_memory(kw["enc"])
        proj, ps = quantize_memory(kw["enc_proj"])
        kw = dict(kw, enc=enc, enc_proj=proj, enc_scale=es, proj_scale=ps,
                  compute_dtype=torch.bfloat16)
        launch_kw = dict(scales=(es.reshape(Bs).contiguous(), ps.reshape(Bs).contiguous()),
                         compute_dtype=torch.bfloat16)
        dtype = torch.int8
    nbytes = sum(t.numel() * t.element_size() for t in kw.values() if torch.is_tensor(t))
    nbytes += Bs * K * (D + S) * 4
    return Case(form, kw, (kw["enc"], kw["enc_proj"]) + rest, launch_kw, Bs, K, S, D, H, Kl,
                dtype, nbytes, flops)


def all_plans(case: Case):
    """Every plan of the case's form: each beam split and cluster size,
    the whole chunk where it fits and a ring of 2 and 4 tiles."""
    elem = case.dtype.itemsize
    for zsplit in (z for z in range(1, case.K + 1) if case.K % z == 0
                   and case.K // z <= b2.MAX_BEAM):
        Kz = case.K // zsplit
        for cluster in range(1, b2.MAX_CLUSTER + 1):
            chunk = -(-(-(-case.S // cluster)) // b2.CHUNK_ALIGN) * b2.CHUNK_ALIGN
            if -(-case.S // chunk) != cluster:
                continue
            for stages in (b2.FULL, 2, 4):
                smem = b2.smem_bytes(case.form, Kz, chunk, 32, stages, case.H, case.Kl, elem,
                                     case.D)
                if smem <= b2.SMEM_LIMIT:
                    yield b2.LaunchPlan(cluster, chunk, zsplit, 32, stages, smem)


def pick_quality(model, rows) -> tuple:
    """How well ``model`` picks among swept plans: (the mean and the largest
    ratio of its pick's time to the fastest over the shapes, the shape of
    the largest)."""
    ratios = {}
    for shape in {tuple(r["shape"]) for r in rows}:
        rs = [r for r in rows if tuple(r["shape"]) == shape]
        pick = min(rs, key=lambda r: (b2.plan_cost(model, shape[0], shape[1], shape[4],
                                                   b2.LaunchPlan(*r["plan"])),
                                      r["plan"][0], r["plan"][2], r["plan"][4]))
        ratios[shape] = pick["us"] / min(r["us"] for r in rs)
    worst = max(ratios, key=ratios.get)
    return sum(ratios.values()) / len(ratios), ratios[worst], worst


def fit_plan_model(rows, start, tries=1500, seed=0) -> tuple:
    """A PlanModel fitted to swept plans (``--sweep``'s JSON rows of one
    row: form and memory type): the least squares of the model's relative
    error over every plan (Nelder-Mead from ``start``), then a random
    search around the better of that and ``start`` for the model whose
    picks come nearest the fastest plans (the mean ratio of pick to fastest
    over the shapes, plus a quarter of the largest's excess).  Returns (the
    model, ``pick_quality``)."""
    from scipy.optimize import minimize

    def model_of(x):
        return b2.PlanModel(*x[:5], start.full, *x[5:])

    def cost(x):
        if min(x) < 0:
            return 1e9
        m = model_of(x)
        return sum(((b2.plan_cost(m, r["shape"][0], r["shape"][1], r["shape"][4],
                                  b2.LaunchPlan(*r["plan"])) - r["us"]) / r["us"]) ** 2
                   for r in rows)

    def score(x):
        mean, worst, _ = pick_quality(model_of(x), rows)
        return mean + 0.25 * (worst - 1)

    x0 = np.array([start.fixed_us, start.cluster_us, start.us_per_beam_position,
                   start.g1_factor, start.co_resident, start.ring_us, start.big_cluster_us])
    ls = minimize(cost, x0, method="Nelder-Mead",
                  options={"maxiter": 4000, "xatol": 1e-5, "fatol": 1e-7}).x
    best = min((x0, np.maximum(ls, 0)), key=score)
    best_score = score(best)
    rng = np.random.default_rng(seed)
    for i in range(tries):
        x = best * np.exp(rng.normal(0, 0.3 * (1 - i / tries) + 0.02, best.shape))
        if (sc := score(x)) < best_score:
            best, best_score = x, sc
    model = model_of([round(float(v), 4) for v in best])
    return (model, *pick_quality(model, rows))


def fit_main(path) -> None:
    """--fit: a model for each row (form, memory type) in a sweep's JSON."""
    with open(path) as f:
        rows = json.load(f)
    for form, dtype in sorted({(r["form"], r["dtype"]) for r in rows}):
        # the plans launch_plan may pick: rings of STAGES, whole chunks within FULL_LIMIT
        sub = [r for r in rows if (r["form"], r["dtype"]) == (form, dtype) and (
            r["plan"][4] == b2.STAGES or (r["plan"][4] == b2.FULL
                                          and r["plan"][5] <= b2.FULL_LIMIT))]
        start = b2.plan_model(form, getattr(torch, dtype))
        mean0, worst0, where0 = pick_quality(start, sub)
        model, mean, worst, where = fit_plan_model(sub, start)
        print(f"{form} form, {dtype} memory, {len(sub)} plans over "
              f"{len({tuple(r['shape']) for r in sub})} shapes: launch_plan's model {start} picks "
              f"{mean0 - 1:.1%} off the fastest on average, {worst0:.2f}x at {where0}; fitted "
              f"here: {model}, {mean - 1:.1%} off on average, {worst:.2f}x at {where}",
              flush=True)


def _kernel_of(lib, form):
    return lib.d2t_attention_step_content if form == b2.CONTENT else \
        lib.d2t_attention_step_coverage


def forward_main(args, mode) -> None:
    """--content or --int8 (see the module docstring)."""
    wide = mode == "content"
    print(ptxas_summary(b2.build_wide() if wide else b2.build()), flush=True)
    libs = {}   # the stamped builds, plain and wide, as the cases need them
    other = load_other(args.against) if args.against else None
    if mode == "content":
        cases = [content_case(Bs, K, S) for Bs, K, S in CONTENT_SHAPES]
    else:
        cases = [coverage_case(Bs, K, S, D, Kl, int8=True) for Bs, K, S, D, Kl in INT8_SHAPES]
        cases.append(content_case(1, 10, 207, int8=True))
    sweep = []
    for case in cases:
        plan = case.plan()
        call = case.step()
        us = graph_ms(call) * 1e3
        bound, by = bound_us(case.nbytes, case.flops)
        line = (f"{mode}: {case.form} form, {case.Bs} samples x K {case.K}, S {case.S}, D "
                f"{case.D} H {case.H}{f' Kl {case.Kl}' if case.Kl else ''}, "
                f"{str(case.dtype)[6:]} memory: {us:.2f} µs with {plan}; launch floor "
                f"{floor_us(plan, case.Bs):.2f} µs; bound {bound:.2f} µs ({by}, "
                f"{case.nbytes / 1e6:.2f} MB)")
        if mode == "int8" and case.form == b2.COVERAGE:
            bf16 = coverage_case(case.Bs, case.K, case.S, case.D, case.Kl)
            line += f"; the bf16-memory coverage form {graph_ms(bf16.step()) * 1e3:.2f} µs"
        if other is not None:
            theirs = case.step(other)
            runs = [graph_ms(f) * 1e3 for f in (theirs, call, call, theirs)]
            line += "; µs per call (other, this, this, other): " + ", ".join(
                f"{x:.2f}" for x in runs)
        if args.sweep:
            model = b2.plan_model(case.form, case.dtype)
            times = {p: graph_ms(case.with_plan(p)) * 1e3 for p in all_plans(case)}
            fast = sorted(times, key=times.get)
            line += "; fastest " + ", ".join(f"{times[p]:.2f} µs with {tuple(p)}"
                                             for p in fast[:3])
            line += f"; the plan's {times.get(plan, float('nan')):.2f} µs"
            sweep += [{"mode": mode, "form": case.form, "dtype": str(case.dtype)[6:],
                       "shape": [case.Bs, case.K, case.S, case.D, case.H, case.Kl],
                       "plan": list(p), "us": t, "chosen": p == plan,
                       "model_us": b2.plan_cost(model, case.Bs, case.K, case.H, p)}
                      for p, t in times.items()]
        print(line, flush=True)
        if args.phases:
            wide_case = case.form == b2.CONTENT or case.D != case.H
            lib = libs.get(wide_case) or libs.setdefault(wide_case, timed_library(wide_case))
            call = case.with_plan(plan, _kernel_of(lib, case.form))
            print(_phase_text(lib, call, case.Bs * plan.zsplit * plan.cluster, PHASES),
                  flush=True)
    if sweep:
        os.makedirs("chiprun_out", exist_ok=True)
        path = os.path.join("chiprun_out", f"b2_sweep_{mode}.json")
        with open(path, "w") as f:
            json.dump(sweep, f)
        print(f"every plan's time: {path}", flush=True)


# ---- B2's backward ------------------------------------------------------------

# (samples, S, D, H, Kl, form): the recipe's largest launch, the small shapes
# its soak launched, the reference widths, then the zoo's widths
BWD_SHAPES = (
    (32, 623, 128, 128, 64, b2.COVERAGE),
    *((B, S, 128, 128, 64, b2.COVERAGE) for B, S in (
        (2, 68), (5, 9), (7, 33), (8, 66), (8, 68), (8, 130), (8, 132), (32, 63), (32, 135),
        (32, 225), (32, 267), (32, 315), (32, 445))),
    (32, 623, 256, 256, 128, b2.COVERAGE), (8, 2525, 256, 256, 128, b2.COVERAGE),
    (16, 239, 512, 256, 128, b2.COVERAGE), (16, 239, 512, 256, 0, b2.CONTENT),
)
BWD_PHASES = ("prologue", "fold", "pass A", "exchange 1", "pass B", "block partials",
              "exchange 2 and output")
# phase boundaries in csrc/attention_step_backward.cu: (text, stamp after it)
BWD_HOOKS = (("  extern __shared__ __align__(16) unsigned char smem[];\n", True),
             ("  // ---- the fold of this rank's share", False),
             ("  // ---- pass A, an enc tile at a time", False),
             ("  // ---- the cluster's first exchange", False),
             ("  // ---- pass B, an enc_proj tile at a time", False),
             ("  // ---- the block's partial vectors", False),
             ("  // ---- the cluster's second exchange", False),
             ("    if (e < H) d_q[(long)b * H + e] = x;\n  }\n", True))


def backward_args(B, S, D, H, Kl, form, seed=11):
    """The backward's arguments on the card (bf16 memory, K = 1): the
    forward's inputs as ``inputs`` makes them (the coverage of 150 steps),
    alpha from the plain forward, cotangents of std 0.1; the content form's
    seven, or the coverage form's twelve."""
    kw = inputs(B, 1, S, D, Kl or 64, seed=seed)
    if H != D:
        g = torch.Generator().manual_seed(seed + 2)
        kw["enc_proj"] = (torch.randn(B, S, H, generator=g) * 1.5).bfloat16().cuda()
        kw.update({k: (torch.randn(*shape, generator=g) * sd).cuda() for k, shape, sd in (
            ("q", (B, H), 1.5), ("w_loc", (Kl or 64, H), 0.35), ("b_loc", (H,), 0.17),
            ("w_score", (H, 1), 0.4))})
    g = torch.Generator().manual_seed(seed + 1)
    cot = [(torch.randn(B, D, generator=g) * 0.1).cuda(),
           (torch.randn(B, S, generator=g) * 0.1).cuda()]
    if form == b2.CONTENT:
        args = [kw[k] for k in ("enc", "enc_proj", "q", "w_score")]
        return args + [b2.content_attention_step_reference(*args)[1]] + cot
    _, alpha = b2.coverage_attention_step_reference(**kw)
    return [kw[k] for k in ("enc", "enc_proj", "q", "mem", "loc_conv_w", "loc_conv_b", "w_loc",
                            "w_score", "b_loc")] + [alpha] + cot


def _backward_fn(module, args):
    """The backward wrapper of ``module`` (this tree's ops.attention_step
    or another checkout's) for ``args``, with its launch count left as it was."""
    fn = (module.coverage_attention_step_backward if len(args) == 12
          else module.content_attention_step_backward)

    def call():
        n = fn.launches
        out = fn(*args)
        fn.launches = n
        return out
    return call


def load_other(checkout: str):
    """Another checkout's ``doc2tex_tpu_torch.ops.attention_step``, imported
    under the package name ``other_doc2tex_tpu_torch`` (its relative
    imports, sources and build directory its own)."""
    import importlib
    import importlib.util

    name = "other_doc2tex_tpu_torch"
    pkg = os.path.join(os.path.abspath(checkout), "doc2tex_tpu_torch")
    spec = importlib.util.spec_from_file_location(name, os.path.join(pkg, "__init__.py"),
                                                  submodule_search_locations=[pkg])
    module = importlib.util.module_from_spec(spec)
    sys.modules[name] = module
    spec.loader.exec_module(module)
    return importlib.import_module(f"{name}.ops.attention_step")


def kernel_split_us(call, reps=20) -> str:
    """Device µs per call of each kernel ``call`` launches, by name, under
    torch.profiler."""
    call()
    torch.cuda.synchronize()
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CUDA]) as prof:
        for _ in range(reps):
            call()
        torch.cuda.synchronize()
    parts = {}
    for e in prof.key_averages():
        if e.device_type == torch.autograd.DeviceType.CUDA and "b2_bwd" in e.key:
            kind = "main" if "main" in e.key else "finish" if "finish" in e.key else e.key[:40]
            parts[kind] = parts.get(kind, 0.0) + _device_us(e) / reps
    return ", ".join(f"{k} {v:.2f}" for k, v in parts.items())


def timed_backward_library():
    """A copy of the backward with a %globaltimer stamp at each phase
    boundary of its main pass (thread 0 of every block), built into build/."""
    return _stamped_library(b2.BACKWARD_SOURCE, BWD_HOOKS, "attention_step_backward_phases")


def backward_phase_line(lib, args, plan) -> str:
    fn = b2._backward_kernel(lib)
    form = b2.COVERAGE if len(args) == 12 else b2.CONTENT
    enc, enc_proj, q = args[:3]
    if form == b2.COVERAGE:
        mem, cw, cb, w_loc, w_score, b_loc, alpha, g_ctx, g_alpha = args[3:]
        call = lambda: b2._backward(form, enc, enc_proj, q, w_score, alpha, g_ctx,  # noqa: E731
                                    g_alpha, (mem, cw, cb, w_loc, b_loc), kernel=fn)
    else:
        call = lambda: b2._backward(form, *args, kernel=fn)  # noqa: E731
    return _phase_text(lib, call, enc.shape[0] * plan.cluster, BWD_PHASES)


def backward_plans(B, S, D, H, form):
    """Every backward plan of 1..BWD_MAX_CLUSTER blocks a row (the ring of
    backward_plan's rule), and how many of its clusters the card holds."""
    for cluster in range(1, b2.BWD_MAX_CLUSTER + 1):
        chunk = max(-(-S // cluster), 2)
        if chunk > b2.BWD_MAX_CHUNK:
            continue
        for stages in (3, 2):
            smem = b2.backward_smem_bytes(form, chunk, stages, D, H, 2)
            if smem <= b2.SMEM_LIMIT:
                yield (b2.BackwardPlan(cluster, chunk, stages),
                       b2.backward_clusters(form, D, H, torch.bfloat16, cluster, smem))
                break


def _call_with_plan(args, plan):
    form = b2.COVERAGE if len(args) == 12 else b2.CONTENT
    enc, enc_proj, q = args[:3]
    if form == b2.CONTENT:
        return lambda: b2._backward(form, *args, plan=plan)
    mem, cw, cb, w_loc, w_score, b_loc, alpha, g_ctx, g_alpha = args[3:]
    return lambda: b2._backward(form, enc, enc_proj, q, w_score, alpha, g_ctx, g_alpha,
                                (mem, cw, cb, w_loc, b_loc), plan=plan)


def backward_main(args) -> None:
    print(ptxas_summary(b2.build_backward()), flush=True)
    lib = timed_backward_library() if args.phases else None
    other = load_other(args.against) if args.against else None
    for B, S, D, H, Kl, form in BWD_SHAPES:
        bargs = backward_args(B, S, D, H, Kl, form)
        plan = b2.backward_plan(B, S, D, H, torch.bfloat16, form, 5 if Kl else 0, Kl)
        call = _backward_fn(b2, bargs)
        line = (f"backward {form}, {B} samples S {S} D {D} H {H} Kl {Kl}: "
                f"{graph_ms(call) * 1e3:.2f} µs with {plan}; kernels (µs) "
                f"{kernel_split_us(call)}")
        if args.sweep:
            line += "; every cluster size (µs, clusters the card holds): " + ", ".join(
                f"{p.cluster} x {p.chunk}/{p.stages}: {graph_ms(_call_with_plan(bargs, p)) * 1e3:.2f}"
                f" ({n})" for p, n in backward_plans(B, S, D, H, form))
        if other is not None and form == b2.COVERAGE and (D, H) != (512, 256):
            theirs = _backward_fn(other, bargs)
            runs = [graph_ms(f) * 1e3 for f in (theirs, call, call, theirs)]
            line += ("; µs per call (other, this, this, other): "
                     + ", ".join(f"{x:.2f}" for x in runs))
        print(line, flush=True)
        if lib is not None:
            print(backward_phase_line(lib, bargs, plan), flush=True)


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--sweep", action="store_true")
    ap.add_argument("--phases", action="store_true")
    ap.add_argument("--against", default=None, metavar="OTHER_CHECKOUT")
    mode = ap.add_mutually_exclusive_group()
    mode.add_argument("--backward", action="store_true", help="time B2's backward instead")
    mode.add_argument("--content", action="store_true",
                      help="time the content form at the zoo's launches")
    mode.add_argument("--int8", action="store_true",
                      help="time the int8 memory form at int8_full's launches")
    ap.add_argument("--fit", default=None, metavar="SWEEP_JSON",
                    help="fit launch_plan's models to a --sweep's plans (no card needed)")
    args = ap.parse_args()
    if args.fit:
        fit_main(args.fit)
        return
    if not torch.cuda.is_available():
        raise SystemExit("bench_attention_step needs a CUDA card")
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True).stdout.strip()
    print(f"{torch.cuda.get_device_name(0)}; nvidia-smi: {smi}", flush=True)
    if args.backward:
        backward_main(args)
        return
    if args.content or args.int8:
        forward_main(args, "content" if args.content else "int8")
        return
    print(ptxas_summary(b2.build()), flush=True)
    lib = timed_library() if args.phases else None
    for Bs, K, S in SHAPES:
        kw = inputs(Bs, K, S)
        plan = b2.launch_plan(Bs, K, S, D, D, KL, torch.bfloat16)
        ms = graph_ms(lambda: b2.coverage_attention_step(**kw))
        enc, proj = (kw[n].repeat_interleave(K, dim=0) for n in ("enc", "enc_proj"))
        loc_feat = b2.location_features(kw["mem"], kw["loc_conv_w"], kw["loc_conv_b"])
        feat_ms = graph_ms(lambda: b2.fused_attention_step(enc, proj, kw["q"], loc_feat,
                                                           kw["w_loc"], kw["b_loc"],
                                                           kw["w_score"]))
        line = (f"{Bs} samples x K {K}, S {S}: coverage form {ms * 1e3:.1f} µs with {plan}; "
                f"feature form at {Bs * K} rows {feat_ms * 1e3:.1f} µs")
        if args.sweep:
            times = {p: graph_ms(lambda p=p: b2.launch(b2.COVERAGE, p, *kw.values()))
                     for p in plans(Bs, K, S)}
            fast = sorted(times, key=times.get)[:5]
            line += "; fastest " + ", ".join(f"{times[p] * 1e3:.1f} µs with {p}" for p in fast)
        print(line, flush=True)
        if lib is not None:
            print(phase_line(lib, kw, plan), flush=True)
    if args.against:
        runs = [time_other(args.against), time_coverage(AGAINST_SHAPES),
                time_coverage(AGAINST_SHAPES), time_other(args.against)]
        for shape in runs[0]:
            print(f"{shape} (samples, K, S, D = H, Kl): µs per call of the coverage form "
                  "(other, this, this, other): " + ", ".join(f"{r[shape]:.2f}" for r in runs),
                  flush=True)


if __name__ == "__main__":
    main()
