"""Device time of the coverage-attention step (B2) on a CUDA card.

    python -m doc2tex_tpu_torch.tools.bench_attention_step [--sweep] [--phases]
        [--against OTHER_CHECKOUT]

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
Needs a card; fails without one.
"""

from __future__ import annotations

import argparse
import ctypes
import inspect
import json
import os
import subprocess
import sys

import numpy as np
import torch

from .. import _build
from ..ops import attention_step as b2
from .bench_decode_attention import graph_ms

SHAPES = (  # (samples, K, S): the synthetic slice's launches, then the release shape
    (1, 10, 623), (8, 10, 135), (8, 10, 225), (8, 10, 267), (8, 10, 445), (64, 10, 623),
)
D, KL, STEP = 128, 64, 150
# --against: (samples, K, S, D = H, Kl)
AGAINST_SHAPES = tuple((Bs, K, S, D, KL) for Bs, K, S in SHAPES) + ((8, 10, 241, 256, 128),)
PHASES = ("prologue", "scores", "softmax and exchanges", "context", "context sums and output")
# phase boundaries in csrc/attention_step.cu: (text, stamp after it)
HOOKS = (("  extern __shared__ __align__(16) unsigned char smem[];\n", True),
         ("  // ---- scores, a ring tile at a time", False),
         ("  // ---- softmax over S, in f32", False),
         ("  // ---- context: thread (pg, d4)", False),
         ("  // the position groups' sums meet in red", False),
         ("  cluster_sync();  // no block leaves", False))


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
    cluster size and beam split; its tile and ring rule)."""
    for zsplit in (z for z in range(1, K + 1) if K % z == 0 and K // z <= b2.MAX_BEAM):
        for cluster in range(1, b2.MAX_CLUSTER + 1):
            chunk = -(-(-(-S // cluster)) // b2.CHUNK_ALIGN) * b2.CHUNK_ALIGN
            if -(-S // chunk) != cluster:
                continue
            for stages in (2, 4, 8):
                smem = b2.smem_bytes(b2.COVERAGE, K // zsplit, chunk, 32, stages, D, KL, 2)
                if smem <= b2.SMEM_LIMIT:
                    yield b2.LaunchPlan(cluster, chunk, zsplit, 32, stages, smem)


def timed_library():
    """A copy of the kernel with a %globaltimer stamp at each phase
    boundary (thread 0 of every block), built into build/."""
    with open(os.path.join(_build.CSRC, b2.SOURCE)) as f:
        src = f.read()
    for text, after in HOOKS:
        if text not in src:
            raise RuntimeError(f"phase boundary not found in the kernel: {text!r}")
    for i, (text, after) in enumerate(HOOKS):
        src = src.replace(text, text + f"  STAMP({i});\n" if after else f"  STAMP({i});\n" + text, 1)
    src = src.replace("namespace {\n", r'''__device__ unsigned long long d2t_stamps[16384][8];
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
    path = os.path.join(_build.BUILD_DIR, "attention_step_phases")
    with open(path + ".cu", "w") as f:
        f.write(src)
    flags = [f for f in _build.NVCC_FLAGS if f not in ("-Xptxas", "-v")]
    proc = subprocess.run([_build._nvcc(), *flags, "-o", path + ".so", path + ".cu"],
                          capture_output=True, text=True, timeout=_build.NVCC_TIMEOUT_S)
    if proc.returncode:
        raise RuntimeError(proc.stderr)
    lib = ctypes.CDLL(path + ".so")
    fn = lib.d2t_attention_step_coverage
    fn.restype = ctypes.c_int
    fn.argtypes = [ctypes.c_void_p] * 13 + [ctypes.c_int] * 16 + [ctypes.c_void_p]
    return lib


def phase_line(lib, kw, plan) -> str:
    for _ in range(3):
        b2.launch(b2.COVERAGE, plan, *kw.values(), kernel=lib.d2t_attention_step_coverage)
    torch.cuda.synchronize()
    stamps = np.zeros((16384, 8), dtype=np.uint64)
    if lib.d2t_read_stamps(ctypes.c_void_p(stamps.ctypes.data)):
        raise RuntimeError("reading the stamps failed")
    n = len(PHASES) + 1
    t = stamps[: kw["enc"].shape[0] * plan.zsplit * plan.cluster, :n].astype(np.int64)
    t0 = t[:, 0].min()
    d = np.diff(t, axis=1).mean(axis=0) / 1e3
    return (f"    phases (µs, mean of blocks): "
            + ", ".join(f"{name} {x:.2f}" for name, x in zip(PHASES, d))
            + f"; block {(t[:, -1] - t[:, 0]).mean() / 1e3:.1f} µs; last block starts at "
            f"{(t[:, 0].max() - t0) / 1e3:.1f} µs; kernel {(t[:, -1].max() - t0) / 1e3:.1f} µs")


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


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--sweep", action="store_true")
    ap.add_argument("--phases", action="store_true")
    ap.add_argument("--against", default=None, metavar="OTHER_CHECKOUT")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        raise SystemExit("bench_attention_step needs a CUDA card")
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True).stdout.strip()
    print(f"{torch.cuda.get_device_name(0)}; nvidia-smi: {smi}", flush=True)
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
