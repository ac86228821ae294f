"""Device time of the beam decode attention kernel (B1) on a CUDA card.

    python -m doc2tex_tpu_torch.tools.bench_decode_attention [--int8] [--dtype float32]
        [--sweep] [--phases] [--against OTHER_CHECKOUT] [--long | --zoo]

Times the kernel in bf16 at the shapes of the ``synthetic_tfm_big`` main
path (batch 64, beam 10, nh 8, hd 32: self-attention at M 310, 620, 930 and
1510 with a beam-ancestry mask at the step that ends each cache chunk, and
cross-attention at M 623) and where ``launch_plan`` splits M (batch 1 and
8; M 5010); with ``--long`` at the ``synthetic_long`` decode's shapes
instead (batch 16, the release eval's, and 64, a 16-crop call's snapped
batch: self-attention at the end of each of the 5 cache chunks of a
501-step decode, M up to 5010, and cross-attention over a 448x960
bucket, M 1695); with ``--zoo`` at head dim 64, the ``zoo_cnn_tfm`` block's
(d_model 512, nh 8 over a 2D ResNet map; ``tests/torch_port_zoo.yaml``):
batch 1 and 8, self-attention at the end of each cache chunk of a 201-step
decode (M up to 2010) and cross-attention over the 13 x 177 and 13 x 241
maps of the 224x704 and 224x960 buckets.  ``--int8`` times the int8 K/V
form instead (bf16 q; K and V quantized per vector as the decoder stores
them, ``quant.quantize_kv``), with the bf16 form's time at the same shape
beside it; ``--dtype float32`` times float32 q (and the float32 form).
Each time is one launch's share of a CUDA graph of 20 launches, so no host
time between launches is counted.  ``--sweep`` also
times every plan that fits (cluster 1..8 x ring of 2 to 6 tiles; with
``--int8`` the int8 form's rings of 2 to 8 tiles of 256 positions) and
prints the fastest beside ``launch_plan``'s, and every plan's time to
``chiprun_out/``.  ``--phases`` builds a copy of the kernel with a device
timestamp at each phase boundary (with ``--int8`` at its own boundaries,
which split the mask's phase where its wait begins) and prints each
phase's mean time over the blocks, and the blocks' spread of start times.
``--against`` loads the ``decode_attention`` of another checkout (another
commit of this repository; its package under another name, its sources
and build directory its own) into this process and times it beside this
one's at the same shapes and inputs, in the order other, this, this,
other.  Prints one line per shape with the card's name and power limit
first.  Needs a card; fails without one.
"""

from __future__ import annotations

import argparse
import ctypes
import importlib
import importlib.util
import json
import os
import subprocess
import sys

import numpy as np
import torch

from .. import _build
from ..ops import decode_attention as b1
from ..ops.quant import quantize_kv

SHAPES = (  # (B, K, M, step; None = no mask)
    (64, 10, 310, 30), (64, 10, 620, 61), (64, 10, 930, 71), (64, 10, 1510, 150),
    (64, 10, 623, None), (1, 10, 1510, 150), (8, 10, 1510, 150), (1, 10, 623, None),
    (8, 10, 623, None), (1, 10, 5010, 500), (64, 10, 5010, 500),
)
LONG_SHAPES = tuple((B, 10, end * 10, end - 1) for B in (16, 64)
                    for end in (101, 202, 303, 404, 501)) + ((16, 10, 1695, None),
                                                             (64, 10, 1695, None))
ZOO_SHAPES = tuple((B, 10, end * 10, end - 1) for B in (1, 8)
                   for end in (41, 82, 123, 164, 201)) + tuple(
    (B, 10, 13 * w, None) for B in (1, 8) for w in (177, 241))
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
# the int8 form's (--int8): the mask phase split where the queries are in
# and the mask's wait begins
INT8_PHASES = ("mask issue and queries", "mask wait and bits") + PHASES[1:]
INT8_HOOKS = HOOKS[:1] + (("  for (int t = tid; t < n_tiles; t += kThreads) tflag[t]", False),) \
    + HOOKS[1:]


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


def int8_inputs(B, K, M, step, nh=8, hd=32, seed=7):
    """``inputs`` with K and V quantized per vector: (q, k, v, mask, k8,
    v8, k_scale, v_scale)."""
    q, k, v, mask = inputs(B, K, M, step, nh, hd, seed)
    (k8, ks), (v8, vs) = quantize_kv(k.float()), quantize_kv(v.float())
    return q, k, v, mask, k8, v8, ks, vs


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


def plans(B, K, M, nh, hd, elem, kelem=None):
    """Every plan that fits: cluster 1..8 x ring of 2 to 6 tiles (the int8
    K/V form with bf16 q, ``kelem`` 1: 2 to 8 tiles of its own size)."""
    for cluster in range(1, b1.MAX_CLUSTER + 1):
        chunk = -(-(-(-M // cluster)) // b1.TILE) * b1.TILE
        if -(-M // chunk) != cluster:
            continue
        for stages in range(2, 9 if b1.packed_int8(elem, kelem or elem) else 7):
            smem = b1.smem_bytes(K, chunk, stages, hd, elem, kelem)
            if smem <= b1.SMEM_LIMIT:
                yield b1.LaunchPlan(cluster, chunk, stages, smem)


def timed_library(hooks=HOOKS):
    """A copy of the kernel with a %globaltimer stamp at each boundary of
    ``hooks`` (thread 0 of every block), built into build/."""
    with open(os.path.join(_build.CSRC, b1.SOURCE)) as f:
        src = f.read()
    for text, after in hooks:
        if src.count(text) != 1:
            raise RuntimeError(f"phase boundary not found once in the kernel: {text!r}")
    for i, (text, after) in enumerate(hooks):
        src = src.replace(text, text + f"  STAMP({i});\n" if after else f"  STAMP({i});\n" + text, 1)
    src = src.replace("namespace {\n", r'''__device__ unsigned long long d2t_stamps[16384][16];
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
    path = os.path.join(_build.BUILD_DIR, f"decode_attention_phases{len(hooks)}")
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
    lib.d2t_decode_attention_int8.restype = ctypes.c_int
    lib.d2t_decode_attention_int8.argtypes = ([ctypes.c_void_p] * 7 + [ctypes.c_int] * 10
                                              + [ctypes.c_void_p])
    lib.phases = PHASES if hooks is HOOKS else INT8_PHASES
    return lib


def phase_line(lib, q, k, v, mask, plan, scales=None) -> str:
    """The stamped copy's phases at one launch of ``plan`` (the int8 K/V
    form with ``scales``)."""
    kernel = lib.d2t_decode_attention if scales is None else lib.d2t_decode_attention_int8
    for _ in range(3):
        b1.launch(q, k, v, mask, plan, kernel=kernel, scales=scales)
    torch.cuda.synchronize()
    stamps = np.zeros((16384, 16), dtype=np.uint64)
    if lib.d2t_read_stamps(ctypes.c_void_p(stamps.ctypes.data)):
        raise RuntimeError("reading the stamps failed")
    n = len(lib.phases)
    t = stamps[: q.shape[0] * q.shape[2] * plan.cluster, : n + 1].astype(np.int64)
    t0 = t[:, 0].min()
    d = np.diff(t, axis=1).mean(axis=0) / 1e3
    return (f"    phases (µs, mean of blocks): "
            + ", ".join(f"{name} {x:.2f}" for name, x in zip(lib.phases, d))
            + f"; block {(t[:, n] - t[:, 0]).mean() / 1e3:.1f} µs; last block starts at "
            f"{(t[:, 0].max() - t0) / 1e3:.1f} µs; kernel {(t[:, n].max() - t0) / 1e3:.1f} µs")


def load_other(checkout: str):
    """Another checkout's ``doc2tex_tpu_torch.ops.decode_attention``,
    imported under the package name ``other_doc2tex_tpu_torch`` (its
    relative imports, sources and build directory its own)."""
    name = "other_doc2tex_tpu_torch"
    pkg = os.path.join(os.path.abspath(checkout), "doc2tex_tpu_torch")
    spec = importlib.util.spec_from_file_location(name, os.path.join(pkg, "__init__.py"),
                                                  submodule_search_locations=[pkg])
    module = importlib.util.module_from_spec(spec)
    sys.modules[name] = module
    spec.loader.exec_module(module)
    return importlib.import_module(f"{name}.ops.decode_attention")


def ptxas_summary(info: dict) -> str:
    """Registers, stack and spills of each kernel instance, from nvcc's
    -Xptxas -v report of this process's build."""
    if not info["built"]:
        return f"kernel loaded from {info['path']} (built earlier: no ptxas report)"
    lines, name = [], None
    for line in info["ptxas"].splitlines():
        if "Compiling entry function" in line:
            inst = line.split("decode_attention_kernelI", 1)[-1].split("EEEv", 1)[0]
            types, head_dim = inst.rsplit("Li", 1)
            name = (("bf16" if "bfloat16" in inst else "f16" if "half" in inst else "f32")
                    + (" q int8 K/V" if types.endswith("a") else "") + " hd" + head_dim)
        elif name and ("spill" in line or "registers" in line):
            lines.append(f"{name}: {line.split(':', 1)[-1].strip()}")
    return "ptxas: " + "; ".join(lines)


def shape_line(args, shape, hd, lib, other, sweep_rows) -> str:
    """One shape's times: the form's plan (and with --sweep every plan), the
    bf16 form beside the int8 form, the phases, and another checkout's."""
    B, K, M, step = shape
    dtype = getattr(torch, args.dtype)
    line = (f"B{B} K{K} M{M} hd{hd} {'step ' + str(step) if step is not None else 'no mask'} "
            f"{args.dtype}: ")
    if args.int8:
        q, k, v, mask, k8, v8, ks, vs = int8_inputs(B, K, M, step, hd=hd)
        q = q.to(dtype)
        scales, kv, kelem = (ks, vs), (k8, v8), 1
        plan = b1.launch_plan(B, K, M, 8, hd, dtype, torch.int8)
        line += "int8 K/V "
    else:
        q, k, v, mask = (t if t is None or t.dtype == torch.bool else t.to(dtype)
                         for t in inputs(B, K, M, step, hd=hd))
        scales, kv, kelem = None, (k, v), None
        plan = b1.launch_plan(B, K, M, 8, hd, dtype)
    ms = graph_ms(lambda: b1.launch(q, *kv, mask, plan, scales=scales))
    line += f"{ms * 1e3:.1f} µs with {plan}"
    if args.int8:
        k, v = k.to(dtype), v.to(dtype)
        line += (f"; {args.dtype} form "
                 f"{graph_ms(lambda: b1.decode_attention(q, k, v, mask)) * 1e3:.1f} µs")
    if args.sweep:
        times = {p: graph_ms(lambda p=p: b1.launch(q, *kv, mask, p, scales=scales))
                 for p in plans(B, K, M, 8, hd, dtype.itemsize, kelem)}
        fast = min(times, key=times.get)
        line += f"; fastest {times[fast] * 1e3:.1f} µs with {fast}"
        sweep_rows += [{"shape": list(shape), "hd": hd, "int8": args.int8, "plan": list(p),
                        "us": t * 1e3, "chosen": p == plan} for p, t in times.items()]
    if lib is not None:
        line += "\n" + phase_line(lib, q, *kv, mask, plan, scales=scales)
    if other is not None:
        extra = scales or ()
        theirs = lambda: other.decode_attention(q, *kv, mask, *extra)   # noqa: E731
        mine = lambda: b1.decode_attention(q, *kv, mask, *extra)        # noqa: E731
        line += ("\n    µs per call (other, this, this, other): "
                 + ", ".join(f"{graph_ms(f) * 1e3:.1f}" for f in (theirs, mine, mine, theirs)))
    return line


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--int8", action="store_true",
                    help="the int8 K/V form (bf16 q) in place of the bf16 form")
    ap.add_argument("--dtype", default="bfloat16", choices=["bfloat16", "float32"],
                    help="q's type (and K/V's in the float form)")
    ap.add_argument("--sweep", action="store_true")
    ap.add_argument("--phases", action="store_true")
    ap.add_argument("--against", default=None, metavar="OTHER_CHECKOUT")
    group = ap.add_mutually_exclusive_group()
    group.add_argument("--long", action="store_true",
                       help="the synthetic_long decode's shapes in place of the main path's")
    group.add_argument("--zoo", action="store_true",
                       help="the zoo_cnn_tfm decode's shapes (head dim 64)")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        raise SystemExit("bench_decode_attention needs a CUDA card")
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True).stdout.strip()
    print(f"{torch.cuda.get_device_name(0)}; nvidia-smi: {smi}", flush=True)
    print(ptxas_summary(b1.build()), flush=True)
    lib = (timed_library(INT8_HOOKS if args.int8 else HOOKS)) if args.phases else None
    other = load_other(args.against) if args.against else None
    hd = 64 if args.zoo else 32
    sweep_rows: list = []
    for shape in LONG_SHAPES if args.long else ZOO_SHAPES if args.zoo else SHAPES:
        print(shape_line(args, shape, hd, lib, other, sweep_rows), flush=True)
    if sweep_rows:
        os.makedirs("chiprun_out", exist_ok=True)
        path = os.path.join("chiprun_out", f"b1_sweep{'_int8' if args.int8 else ''}"
                            f"{'_long' if args.long else '_zoo' if args.zoo else ''}.json")
        with open(path, "w") as f:
            json.dump({"device": torch.cuda.get_device_name(0), "nvidia_smi": smi,
                       "rows": sweep_rows}, f)
        print(f"every plan's time: {path}", flush=True)


if __name__ == "__main__":
    main()
