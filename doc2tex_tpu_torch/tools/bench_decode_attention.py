"""Device time of the beam decode attention kernel (B1) on a CUDA card.

    python -m doc2tex_tpu_torch.tools.bench_decode_attention [--sweep] [--phases]
        [--against OTHER_CHECKOUT] [--long]

Times the kernel in bf16 at the shapes of the ``synthetic_tfm_big`` main
path (batch 64, beam 10, nh 8, hd 32: self-attention at M 310, 620, 930 and
1510 with a beam-ancestry mask at the step that ends each cache chunk, and
cross-attention at M 623) and where ``launch_plan`` splits M (batch 1 and
8; M 5010); with ``--long`` at the ``synthetic_long`` decode's shapes
instead (batch 16, the release eval's, and 64, a 16-crop call's snapped
batch: self-attention at the end of each of the 5 cache chunks of a
501-step decode, M up to 5010, and cross-attention over a 448x960
bucket, M 1695).  Each time is one launch's share of a CUDA graph of 20
launches, so no host time between launches is counted.  ``--sweep`` also
times every plan that fits (cluster 1..8 x ring of 2 to 6 tiles) and prints
the fastest beside ``launch_plan``'s.  ``--phases`` builds a copy of the
kernel with a device timestamp at each phase boundary and prints each
phase's mean time over the blocks, and the blocks' spread of start times.
``--against`` times the ``decode_attention`` of another checkout (another
commit of this repository) at the same shapes and inputs, in the order
other, this, this, other, each in its own process.
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
from ..ops import decode_attention as b1

SHAPES = (  # (B, K, M, step; None = no mask)
    (64, 10, 310, 30), (64, 10, 620, 61), (64, 10, 930, 71), (64, 10, 1510, 150),
    (64, 10, 623, None), (1, 10, 1510, 150), (8, 10, 1510, 150), (1, 10, 623, None),
    (8, 10, 623, None), (1, 10, 5010, 500), (64, 10, 5010, 500),
)
LONG_SHAPES = tuple((B, 10, end * 10, end - 1) for B in (16, 64)
                    for end in (101, 202, 303, 404, 501)) + ((16, 10, 1695, None),
                                                             (64, 10, 1695, None))
PHASES = ("mask and queries", "pass 1 (Q.K)", "row max", "exp and row sum", "normalise",
          "pass 2 (P.V)", "output")
# phase boundaries in csrc/decode_attention.cu: (text, stamp after it)
HOOKS = (("  extern __shared__ __align__(16) unsigned char smem[];\n", True),
         ("  // the rest of the first stages - 1 tiles", False),
         ("  // row maxima: warp, then block, then cluster", False),
         ("  // e = exp(s - max) in place", False),
         ("  // p = e / sum with the cluster's sum", False),
         ("  // pass 2: P.V", False),
         ("  float* o_red = reinterpret_cast<float*>(ring);", False),
         ("  cluster_sync();  // no block leaves", False))


def inputs(B, K, M, step, nh=8, hd=32, seed=7):
    """bf16 q/k/v on the card and, when ``step`` is given, a random beam
    ancestry up to ``step`` over M = T*K slots (the rest a dead tail)."""
    g = torch.Generator().manual_seed(seed)
    q = (torch.randn(B, K, nh, hd, generator=g) / hd ** 0.5).cuda().bfloat16()
    k = torch.randn(B, M, nh, hd, generator=g).cuda().bfloat16()
    v = torch.randn(B, M, nh, hd, generator=g).cuda().bfloat16()
    if step is None:
        return q, k, v, None
    T = M // K
    slot = torch.randint(0, K, (B, K, T), generator=g)
    slot[:, :, step] = torch.arange(K)
    sel = torch.nn.functional.one_hot(slot, K).bool() & (torch.arange(T) <= step)[None, None, :, None]
    return q, k, v, sel.reshape(B, K, T * K).cuda()


def graph_ms(fn, reps: int = 20, replays: int = 10) -> float:
    """One call's share of a CUDA graph of ``reps`` calls."""
    stream = torch.cuda.Stream()
    stream.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(stream):
        for _ in range(3):
            fn()
    torch.cuda.current_stream().wait_stream(stream)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(reps):
            fn()
    graph.replay()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    start.record()
    for _ in range(replays):
        graph.replay()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / (reps * replays)


def plans(B, K, M, nh, hd, elem):
    for cluster in range(1, b1.MAX_CLUSTER + 1):
        chunk = -(-(-(-M // cluster)) // b1.TILE) * b1.TILE
        if -(-M // chunk) != cluster:
            continue
        for stages in range(2, 7):
            smem = b1.smem_bytes(K, chunk, stages, hd, elem)
            if smem <= b1.SMEM_LIMIT:
                yield b1.LaunchPlan(cluster, chunk, stages, smem)


def timed_library():
    """A copy of the kernel with a %globaltimer stamp at each phase
    boundary (thread 0 of every block), built into build/."""
    with open(os.path.join(_build.CSRC, b1.SOURCE)) as f:
        src = f.read()
    for text, after in HOOKS:
        if text not in src:
            raise RuntimeError(f"phase boundary not found in the kernel: {text!r}")
    for i, (text, after) in enumerate(HOOKS):
        src = src.replace(text, text + f"  STAMP({i});\n" if after else f"  STAMP({i});\n" + text, 1)
    src = src.replace("namespace {\n", r'''__device__ unsigned long long d2t_stamps[16384][8];
#define STAMP(i) do { if (threadIdx.x == 0) { unsigned long long t_; \
  asm volatile("mov.u64 %0, %%globaltimer;" : "=l"(t_)); \
  const unsigned b_ = blockIdx.y * gridDim.x + blockIdx.x; \
  if (b_ < 16384) d2t_stamps[b_][i] = t_; } } while (0)
namespace {
''', 1) + '''
extern "C" int d2t_read_stamps(void* host) {
  return (int)cudaMemcpyFromSymbol(host, d2t_stamps, sizeof(d2t_stamps));
}
'''
    os.makedirs(_build.BUILD_DIR, exist_ok=True)
    path = os.path.join(_build.BUILD_DIR, "decode_attention_phases")
    with open(path + ".cu", "w") as f:
        f.write(src)
    flags = [f for f in _build.NVCC_FLAGS if f not in ("-Xptxas", "-v")]
    proc = subprocess.run([_build._nvcc(), *flags, "-o", path + ".so", path + ".cu"],
                          capture_output=True, text=True, timeout=_build.NVCC_TIMEOUT_S)
    if proc.returncode:
        raise RuntimeError(proc.stderr)
    lib = ctypes.CDLL(path + ".so")
    lib.d2t_decode_attention.restype = ctypes.c_int
    lib.d2t_decode_attention.argtypes = [ctypes.c_void_p] * 5 + [ctypes.c_int] * 10 + [ctypes.c_void_p]
    return lib


def phase_line(lib, q, k, v, mask, plan) -> str:
    for _ in range(3):
        b1.launch(q, k, v, mask, plan, kernel=lib.d2t_decode_attention)
    torch.cuda.synchronize()
    stamps = np.zeros((16384, 8), dtype=np.uint64)
    if lib.d2t_read_stamps(ctypes.c_void_p(stamps.ctypes.data)):
        raise RuntimeError("reading the stamps failed")
    t = stamps[: q.shape[0] * q.shape[2] * plan.cluster].astype(np.int64)
    t0 = t[:, 0].min()
    d = np.diff(t, axis=1).mean(axis=0) / 1e3
    return (f"    phases (µs, mean of blocks): "
            + ", ".join(f"{n} {x:.2f}" for n, x in zip(PHASES, d))
            + f"; block {(t[:, 7] - t[:, 0]).mean() / 1e3:.1f} µs; last block starts at "
            f"{(t[:, 0].max() - t0) / 1e3:.1f} µs; kernel {(t[:, 7].max() - t0) / 1e3:.1f} µs")


def time_wrapper(decode_attention, shapes=SHAPES) -> dict:
    """µs per call of ``decode_attention`` (any commit's wrapper) at
    ``shapes``, keyed by the shape's repr."""
    out = {}
    for B, K, M, step in shapes:
        q, k, v, mask = inputs(B, K, M, step)
        out[repr((B, K, M, step))] = graph_ms(lambda: decode_attention(q, k, v, mask)) * 1e3
    return out


def time_other(checkout: str) -> dict:
    """time_wrapper on another checkout's decode_attention, in a process of
    its own that imports only that checkout."""
    code = "\n".join([
        "import json, torch", "import numpy as np",
        "from doc2tex_tpu_torch.ops.decode_attention import decode_attention",
        f"SHAPES = {SHAPES!r}",
        inspect.getsource(inputs), inspect.getsource(graph_ms), inspect.getsource(time_wrapper),
        "print(json.dumps(time_wrapper(decode_attention)))",
    ])
    env = dict(os.environ, PYTHONPATH=os.path.abspath(checkout))
    proc = subprocess.run([sys.executable, "-c", code], cwd=checkout, env=env,
                          capture_output=True, text=True, timeout=900)
    if proc.returncode:
        raise RuntimeError(f"timing {checkout} failed:\n{proc.stderr}")
    return json.loads(proc.stdout.strip().splitlines()[-1])


def ptxas_summary(info: dict) -> str:
    """Registers, stack and spills of each kernel instance, from nvcc's
    -Xptxas -v report of this process's build."""
    if not info["built"]:
        return f"kernel loaded from {info['path']} (built earlier: no ptxas report)"
    lines, name = [], None
    for line in info["ptxas"].splitlines():
        if "Compiling entry function" in line:
            inst = line.split("decode_attention_kernelI", 1)[-1].split("EEEv", 1)[0]
            name = ("bf16" if "bfloat16" in inst else "f16" if "half" in inst else "f32") \
                + " hd" + inst.rsplit("Li", 1)[-1]
        elif name and ("spill" in line or "registers" in line):
            lines.append(f"{name}: {line.split(':', 1)[-1].strip()}")
    return "ptxas: " + "; ".join(lines)


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--sweep", action="store_true")
    ap.add_argument("--phases", action="store_true")
    ap.add_argument("--against", default=None, metavar="OTHER_CHECKOUT")
    ap.add_argument("--long", action="store_true",
                    help="the synthetic_long decode's shapes in place of the main path's")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        raise SystemExit("bench_decode_attention needs a CUDA card")
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True).stdout.strip()
    print(f"{torch.cuda.get_device_name(0)}; nvidia-smi: {smi}", flush=True)
    print(ptxas_summary(b1.build()), flush=True)
    lib = timed_library() if args.phases else None
    for B, K, M, step in (LONG_SHAPES if args.long else SHAPES):
        q, k, v, mask = inputs(B, K, M, step)
        plan = b1.launch_plan(B, K, M, 8, 32, torch.bfloat16)
        ms = graph_ms(lambda: b1.launch(q, k, v, mask, plan))
        line = (f"B{B} K{K} M{M} {'step ' + str(step) if step is not None else 'no mask'}: "
                f"{ms * 1e3:.1f} µs with {plan}")
        if args.sweep:
            times = {p: graph_ms(lambda p=p: b1.launch(q, k, v, mask, p))
                     for p in plans(B, K, M, 8, 32, 2)}
            fast = min(times, key=times.get)
            line += f"; fastest {times[fast] * 1e3:.1f} µs with {fast}"
        print(line, flush=True)
        if lib is not None:
            print(phase_line(lib, q, k, v, mask, plan), flush=True)
    if args.against:
        runs = [time_other(args.against), time_wrapper(b1.decode_attention),
                time_wrapper(b1.decode_attention), time_other(args.against)]
        for shape in runs[0]:
            print(f"{shape}: µs per call (other, this, this, other): "
                  + ", ".join(f"{r[shape]:.1f}" for r in runs), flush=True)


if __name__ == "__main__":
    main()
