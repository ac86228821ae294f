"""Where the time of one page goes, on a CUDA card.

    python -m doc2tex_tpu_torch.tools.profile_page [--version synthetic_tfm_big]
        [--pages 3] [--out result.json]

Runs ``app.App`` (the released detector in float32, which turns cuDNN's
TF32 off for its forward; the version block's recognizer as it ships,
``quantize: int8``, beam 10; the process's TF32 settings as torch leaves
them, as in the app and the server) on the first
``--pages`` pages of the page eval (seed 35, 1024x1280, 35 windows each).
Per page, after a warm-up: SSD512's forward over the page's windows and
the per-window decode + NMS (CUDA events) beside the SSD's bound (its
convolutions' float32 operations at 67 TFLOP/s); the page NMS, the whole
``detect_page``, ``detect_and_crop`` and the recognizer on its crops (host
clock around calls that end on the host); B1's launches.  Then one page under
``torch.profiler``: device busy time (sum of kernel times; one stream) and
idle share of each half, and the kernels that took the most device time.
Prints JSON (also to ``--out``).  Needs a card; fails without one.
"""

from __future__ import annotations

import argparse
import json
import os
import time

import numpy as np
import torch

from ..app import App
from ..detection.boxes import batched_detect
from ..ops.decode_attention import decode_attention
from ..recognition import MathRecognition, load_recog_config
from .page_eval import EVAL_SEED, synth_labelled_page
from .profile_slice import _device_us
from .release_eval import card

F32_FLOPS = 67e12   # H100 SXM float32 rate outside the tensor cores
REPS = 5            # CUDA-event times are the mean of this many calls after one warm-up


def ssd_flops(model, window: int = 512) -> int:
    """Multiply-adds x 2 of every convolution of one window's forward."""
    from ..detection.ssd import Conv2d

    total = [0]

    def hook(mod, inputs, out):
        cout, cin, kh, kw = mod.kernel.shape
        total[0] += 2 * out[0].numel() * cin * kh * kw

    hooks = [m.register_forward_hook(hook) for m in model.modules() if isinstance(m, Conv2d)]
    try:
        with torch.inference_mode():
            dev = next(model.parameters()).device
            model(torch.zeros(1, 3, window, window, device=dev))
    finally:
        for h in hooks:
            h.remove()
    return total[0]


def event_ms(fn, reps: int = REPS) -> float:
    """Mean device time of ``fn()`` over ``reps`` calls, CUDA events, after
    one warm-up call."""
    fn()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


@torch.inference_mode()
def detect_timings(detector, page: np.ndarray) -> dict:
    """The detector's parts on one page: SSD forward (the path's own input
    and precision) and per-window decode + NMS (CUDA events), page NMS and
    ``detect_page`` whole (host clock around calls that end on the host),
    beside the SSD's bound."""
    windows, info = detector.page_windows(page)
    x = detector.model_input(windows)
    loc, conf = detector.ssd(x)
    ssd_ms = event_ms(lambda: detector.ssd(x))
    nms_ms = event_ms(lambda: batched_detect(loc, conf, detector.priors,
                                             conf_thresh=detector.conf_thresh,
                                             iou_thresh=detector.iou_thresh))
    candidates = detector.page_candidates(page)
    detector.page_nms(*candidates, page.shape[:2])
    t = time.perf_counter()
    for _ in range(REPS):
        detector.page_nms(*candidates, page.shape[:2])
    page_nms_ms = (time.perf_counter() - t) / REPS * 1e3
    detector.detect_page(page)
    t = time.perf_counter()
    for _ in range(REPS):
        detector.detect_page(page)
    detect_page_ms = (time.perf_counter() - t) / REPS * 1e3
    flops = ssd_flops(detector.model) * len(info)
    return {"windows": len(info), "ssd_ms": ssd_ms, "window_nms_ms": nms_ms,
            "page_nms_ms": page_nms_ms, "page_nms_boxes": len(candidates[0]),
            "detect_page_ms": detect_page_ms, "ssd_gflop": flops / 1e9,
            "ssd_bound_ms": flops / F32_FLOPS * 1e3,
            "ssd_tflop_per_s": flops / (ssd_ms * 1e-3) / 1e12}


def _profiled(fn) -> tuple[dict, object]:
    acts = [torch.profiler.ProfilerActivity.CPU, torch.profiler.ProfilerActivity.CUDA]
    with torch.profiler.profile(activities=acts) as prof:
        t = time.perf_counter()
        out = fn()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t
    kernels = [e for e in prof.key_averages() if e.device_type == torch.autograd.DeviceType.CUDA]
    busy = sum(_device_us(e) for e in kernels) / 1e6
    top = sorted(kernels, key=_device_us, reverse=True)[:8]
    return {"wall_s": wall, "device_busy_s": busy, "device_idle_share": 1.0 - busy / wall,
            "top_kernels": [{"name": e.key[:200], "device_s": _device_us(e) / 1e6,
                             "count": e.count} for e in top]}, out


def profile(version: str = "synthetic_tfm_big", n_pages: int = 3) -> dict:
    if not torch.cuda.is_available():
        raise SystemExit("profile_page needs a CUDA card")
    cfg, weights = load_recog_config(version=version)
    app = App(recognizer=MathRecognition(cfg, weights, device="cuda"), device="cuda")
    rng = np.random.default_rng(EVAL_SEED)
    pages = [synth_labelled_page(rng)[0] for _ in range(n_pages)]
    rows = []
    for page in pages:
        app(page)                                     # warm-up: the page's buckets
        row = detect_timings(app.detector, page)
        t = time.perf_counter()
        boxes, crops = app.detect_and_crop(page)
        t_detect = time.perf_counter() - t
        decode_attention.launches = 0
        t = time.perf_counter()
        app.recognizer(crops)
        row.update(detect_and_crop_s=t_detect, recognize_s=time.perf_counter() - t,
                   crops=len(crops), b1_launches=decode_attention.launches)
        rows.append(row)
    detect_prof, (_, crops) = _profiled(lambda: app.detect_and_crop(pages[0]))
    recog_prof, _ = _profiled(lambda: app.recognizer(crops))
    busy = detect_prof["device_busy_s"] + recog_prof["device_busy_s"]
    wall = detect_prof["wall_s"] + recog_prof["wall_s"]
    return {**card(), "version": version, "quantize": cfg.get("quantize"),
            "dtype": cfg.get("dtype"), "beam": app.recognizer.beam_size,
            "tf32": torch.backends.cudnn.allow_tf32,
            "pages": rows, "profiled_page": {"detect": detect_prof, "recognize": recog_prof,
                                             "device_busy_s": busy, "wall_s": wall,
                                             "device_idle_share": 1.0 - busy / wall}}


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--version", default="synthetic_tfm_big")
    ap.add_argument("--pages", type=int, default=3)
    ap.add_argument("--out", default=None)
    args = ap.parse_args()
    result = profile(args.version, args.pages)
    if args.out:
        os.makedirs(os.path.dirname(args.out) or ".", exist_ok=True)
        with open(args.out, "w") as f:
            json.dump(result, f, indent=1)
    print(json.dumps(result, indent=1))


if __name__ == "__main__":
    main()
