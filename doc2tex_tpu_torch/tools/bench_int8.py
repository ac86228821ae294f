"""The int8 encoder's layers on a CUDA card: where ``quantize: int8`` spends
its time in a 16-crop call.

    python -m doc2tex_tpu_torch.tools.bench_int8 [--version synthetic_tfm_big]
        [--out result.json]

Runs the release's encoder as it ships (bf16, ``quantize: int8``) on the
batches that MathRecognition builds from the first 16 seeded crops (the
crops ``chip_smoke.py`` decodes), records every int8 layer's input with forward
hooks, and times at each layer's shape (CUDA events over 10 calls after 3
warm-up calls):

- ``int_mm``: the integer product alone (``torch._int_mm``);
- ``product``: the same product in the compute type (x @ w, cuBLAS);
- ``int8_layer``: the whole int8 layer (quantize, window gather, product,
  rescale, bias);
- ``layer``: the same layer unquantized (cuDNN convolution or matmul);

and the encoder over the call's batches with and without int8.  Prints
one JSON object (also to ``--out``).  Needs a card; fails without one.
"""

from __future__ import annotations

import argparse
import copy
import json
import os
import subprocess

import torch

from ..data.synthetic import seeded_crops
from ..models.layers import Dense
from ..models.resnet import Conv
from ..ops import quant
from ..recognition import MathRecognition, load_recog_config
from ..transforms.augment import normalize


def event_ms(fn, reps: int = 10, warmup: int = 3) -> float:
    """Mean milliseconds of ``fn`` over ``reps`` back-to-back calls."""
    for _ in range(warmup):
        fn()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def record_inputs(model, batches) -> list[tuple[str, torch.nn.Module, torch.Tensor]]:
    """(name, layer, input) of every int8 layer call while ``model``
    encodes ``batches`` (normalized tensors on the model's device)."""
    seen = []
    hooks = [layer.register_forward_hook(
        lambda m, args, out, name=name: seen.append((name, m, args[0].detach())))
        for name, layer in model.seqmodeler.int8_modules() if layer.takes_int8()]
    try:
        with torch.inference_mode():
            for x in batches:
                model.encode(x)
    finally:
        for h in hooks:
            h.remove()
    return seen


def call_batches(rec: MathRecognition, crops) -> list[torch.Tensor]:
    """The normalized batches MathRecognition decodes ``crops`` in."""
    prepped = [rec._preprocess(c) for c in crops]
    return [normalize(torch.from_numpy(rec.make_batch([prepped[i] for i in idxs], b))
                      .to(rec.device))
            for b, idxs in rec.group(prepped).items()]


def int8_operands(layer, x: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """(int8 activations (M, K), int8 weights (N, K), compute-type x (M, K))
    of the product ``layer`` makes from input ``x``."""
    dtype = layer.dtype
    if isinstance(layer, Dense):
        w_q, _ = quant.quantize_weight(layer.kernel, dtype)
        a = x.to(dtype).reshape(-1, x.shape[-1])
    else:
        w_q, _ = quant.quantize_conv_weight(layer.kernel, dtype)
        (kh, kw), (sh, sw), (ph, pw) = layer.kernel.shape[2:], layer.stride, layer.padding
        cols = torch.nn.functional.unfold(x.to(dtype), (kh, kw), padding=(ph, pw),
                                          stride=(sh, sw))      # (B, C*kh*kw, L)
        a = cols.transpose(1, 2).reshape(-1, cols.shape[1])
    a_q, _ = quant.quantize(a)
    return a_q, w_q, a


N_CROPS = 16


def bench(version: str) -> dict:
    if not torch.cuda.is_available():
        raise SystemExit("bench_int8 needs a CUDA card")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    cfg, weights = load_recog_config(version=version)
    rec = MathRecognition(cfg, weights, beam_size=1, device="cuda")
    crops = [img for _, img, _ in seeded_crops(N_CROPS)]
    batches = call_batches(rec, crops)
    calls = record_inputs(rec.model, batches)
    layers = []
    for name, layer, x in calls:
        a_q, w_q, a = int8_operands(layer, x)
        # the kernel in the compute type as a (K, N) matrix
        w_t = (layer.kernel.to(layer.dtype).reshape(layer.kernel.shape[0], -1).t().contiguous()
               if isinstance(layer, Conv) else layer.kernel.to(layer.dtype))
        plain = copy.deepcopy(layer)
        plain.int8 = False
        with torch.inference_mode():
            row = {
                "layer": name, "M": a_q.shape[0], "K": a_q.shape[1], "N": w_q.shape[0],
                "int_mm_ms": event_ms(lambda: quant.int_mm(a_q, w_q)),
                "product_ms": event_ms(lambda: a @ w_t),
                "int8_layer_ms": event_ms(lambda: layer(x)),
                "layer_ms": event_ms(lambda: plain(x)),
            }
        layers.append(row)
        del a_q, w_q, a, w_t, plain

    def encoder_ms(mode):
        rec.model.set_quantize(mode)
        with torch.inference_mode():
            return event_ms(lambda: [rec.model.encode(x) for x in batches], reps=5)

    encode = {"int8": encoder_ms("int8"), "unquantized": encoder_ms(None)}
    rec.model.set_quantize("int8")
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, timeout=60).stdout.strip()
    totals = {k: sum(r[k] for r in layers)
              for k in ("int_mm_ms", "product_ms", "int8_layer_ms", "layer_ms")}
    return {
        "device": torch.cuda.get_device_name(0), "nvidia_smi": smi, "version": version,
        "dtype": cfg["dtype"], "crops": N_CROPS,
        "batches": [list(x.shape) for x in batches], "int8_layer_calls": len(layers),
        "per_call_ms": totals, "encoder_ms": encode, "layers": layers,
    }


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--version", default="synthetic_tfm_big",
                    choices=["synthetic_tfm_big", "synthetic"])
    ap.add_argument("--out", default=None)
    args = ap.parse_args()
    result = bench(args.version)
    if args.out:
        os.makedirs(os.path.dirname(args.out) or ".", exist_ok=True)
        with open(args.out, "w") as f:
            json.dump(result, f, indent=1)
    print(json.dumps(result))


if __name__ == "__main__":
    main()
