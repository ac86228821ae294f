"""Recognition serving on the card: an HTTP front over the micro-batching
server (counterpart of the repository's ``api/serve.py``).

    python -m doc2tex_tpu_torch.api.serve --model_version synthetic --port 8080

Endpoints:
    GET  /                 the browser demo (demo/web/index.html)
    GET  /config           {"model_version": ..., "beam_size": ..., "detect": bool}
    POST /recognize        PNG bytes -> {"latex": ..., "ms": ...}
    POST /recognize_page   (``--detect``) PNG page -> {"regions": [{"box": [x1, y1, x2, y2],
                           "latex": ...}, ...], "ms": ...}
    GET  /stats            dispatcher counters and latency percentiles
    GET  /healthz          liveness

The release's version block is served as it ships (``quantize: int8``);
``--bf16`` turns its quantization off.  With ``--detect`` a page thread
detects page after page (``serving.PageServer``, the released detector or
``--detect_weights``) and sends each page's crops through the same
dispatcher as ``/recognize`` traffic; ``--stitch`` gives the page's regions
by the voting stitch instead of the page NMS (``app.App(stitch=True)``).
``--selftest N`` pushes N synthetic crops through the dispatcher (no HTTP),
with ``--detect`` also two white 640x1280 pages, and prints one JSON line of
stats.  The models run on ``--device`` (default ``cuda``).
``--data_parallel N`` shards every decode batch, and with ``--detect`` the
detector's windows, over the first N cards (``--device cpu``: N CPU ranks):
this process is rank 0 and runs the HTTP front and the dispatcher, and N-1
follower processes decode their rows (``parallel.mesh.lead``).
``--platform`` picks a JAX platform and raises.
"""

from __future__ import annotations

import argparse
import hashlib
import json
import os
import sys
import time
import zlib
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer

import numpy as np

from ..serving import PageServer, RecognitionServer, ServerOverloaded
from ..utils.png import decode_png

_ROOT = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
UI_PATH = os.path.join(_ROOT, "demo", "web", "index.html")


def build_handler(server: RecognitionServer, page_server: PageServer | None = None,
                  max_body: int = 32 << 20, config_info: dict | None = None):
    """A BaseHTTPRequestHandler subclass bound to ``server`` and, with
    detection on, ``page_server``."""
    ui_html = None
    if os.path.exists(UI_PATH):
        with open(UI_PATH, "rb") as f:
            ui_html = f.read()
    cfg_payload = dict(config_info or {})
    cfg_payload.setdefault("detect", page_server is not None)

    class Handler(BaseHTTPRequestHandler):
        protocol_version = "HTTP/1.1"

        def _reply(self, code: int, payload: dict) -> None:
            body = json.dumps(payload).encode()
            self.send_response(code)
            self.send_header("Content-Type", "application/json")
            self.send_header("Content-Length", str(len(body)))
            self.end_headers()
            self.wfile.write(body)

        def do_GET(self):  # noqa: N802 (http.server API)
            if self.path == "/healthz":
                self._reply(200, {"ok": True})
            elif self.path == "/config":
                self._reply(200, cfg_payload)
            elif self.path in ("/", "/index.html") and ui_html is not None:
                self.send_response(200)
                self.send_header("Content-Type", "text/html; charset=utf-8")
                self.send_header("Content-Length", str(len(ui_html)))
                self.end_headers()
                self.wfile.write(ui_html)
            elif self.path == "/stats":
                self._reply(200, (page_server or server).stats())
            else:
                self._reply(404, {"error": "unknown path"})

        def do_POST(self):  # noqa: N802
            if self.path == "/recognize":
                handler = self._handle_crop
            elif self.path == "/recognize_page" and page_server is not None:
                handler = self._handle_page
            else:
                self._reply(404, {"error": "unknown path"})
                return
            length = int(self.headers.get("Content-Length", 0))
            if not 0 < length <= max_body:
                self._reply(413, {"error": f"bad Content-Length {length}"})
                return
            data = self.rfile.read(length)
            t0 = time.monotonic()
            try:
                image = decode_png(data)
            except (ValueError, zlib.error) as exc:
                self._reply(400, {"error": f"undecodable image: {exc}"})
                return
            try:
                payload = handler(image)
            except ServerOverloaded as exc:
                self._reply(503, {"error": str(exc)})
                return
            except Exception as exc:  # noqa: BLE001 (reported to the client)
                self._reply(500, {"error": str(exc)})
                return
            payload["ms"] = round((time.monotonic() - t0) * 1e3, 1)
            self._reply(200, payload)

        def _handle_crop(self, image) -> dict:
            return {"latex": server.recognize(image, timeout=120.0)}

        def _handle_page(self, image) -> dict:
            regions = page_server.recognize_page(image, timeout=300.0)
            return {"regions": [{"box": [int(v) for v in box], "latex": latex}
                                for box, latex in regions]}

        def log_message(self, fmt, *args):  # quiet by default
            pass

    return Handler


def parse_args(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n", 1)[0])
    ap.add_argument("--recog_config", default=None,
                    help="recognizer config yaml (default demo/recog_cfg.yaml)")
    ap.add_argument("--model_version", default="synthetic",
                    help="version block in the recog config (synthetic, synthetic_tfm_big)")
    ap.add_argument("--beam_size", type=int, default=None)
    ap.add_argument("--bf16", action="store_true",
                    help="turn the version block's `quantize:` mode off")
    ap.add_argument("--host", default="127.0.0.1")
    ap.add_argument("--port", type=int, default=8080)
    ap.add_argument("--max_batch", type=int, default=64)
    ap.add_argument("--window_ms", type=float, default=5.0)
    ap.add_argument("--max_queue", type=int, default=512)
    ap.add_argument("--coalesce_ratio", type=float, default=None,
                    help="bucket-coalescing area-ratio guard (default: the version "
                    "block's `coalesce_ratio`, else off)")
    ap.add_argument("--device", default="cuda", help="torch device of the model")
    ap.add_argument("--selftest", type=int, default=0, metavar="N",
                    help="skip HTTP: submit N synthetic crops open-loop and print stats")
    ap.add_argument("--selftest_rate", type=float, default=0.0, metavar="RPS",
                    help="pace selftest submissions at this rate (0 = burst)")
    ap.add_argument("--detect", action="store_true",
                    help="enable POST /recognize_page: detection per page, crops through "
                    "the shared dispatcher")
    ap.add_argument("--detect_weights", default=None,
                    help="detector msgpack (default: the released saved_models/math_detect)")
    ap.add_argument("--stitch", action="store_true",
                    help="with --detect: voting-stitch the page's regions instead of the page NMS")
    ap.add_argument("--data_parallel", type=int, default=0, metavar="N",
                    help="shard every decode batch (and, with --detect, the detector's "
                    "windows) over the first N cards, or N CPU ranks with --device cpu "
                    "(0 = one device)")
    ap.add_argument("--platform", default=None, help="a JAX platform; use --device")
    args = ap.parse_args(argv)
    for name in ("detect_weights", "stitch"):
        if getattr(args, name) and not args.detect:
            raise SystemExit(f"--{name} needs --detect")
    if args.platform:
        raise NotImplementedError("--platform picks a JAX platform and is not ported; "
                                  "use --device")
    return args


def start_mesh(args, argv):
    """With ``--data_parallel N``: this process as rank 0 of N, the
    followers started (each runs ``_follow(mesh, argv)``); else None."""
    n = args.data_parallel
    if n <= 1:
        return None
    if args.device.startswith("cuda"):
        import torch

        have = torch.cuda.device_count() if torch.cuda.is_available() else 0
        if n > have:
            raise SystemExit(f"--data_parallel {n}: {have} card(s) visible")
        devices = [f"cuda:{i}" for i in range(n)]
    else:
        devices = [args.device] * n
    from ..parallel.mesh import lead

    mesh = lead(devices, _follow, (list(argv),), mesh_shape={"data": n, "model": 1})
    print(f"data-parallel over {n} ranks ({mesh.backend})", file=sys.stderr, flush=True)
    return mesh


def _follow(mesh, argv) -> None:
    """A follower rank: the same recognizer (and detector) as rank 0, then
    the calls rank 0 makes."""
    args = parse_args(argv)
    recog = build_recognizer(args, mesh)
    build_app(args, recog, mesh)
    mesh.follow()


def build_recognizer(args, mesh=None):
    """The MathRecognition of the parsed ``args`` (sharded over ``mesh``)."""
    from ..recognition import MathRecognition, load_recog_config

    cfg, weights = load_recog_config(args.recog_config, args.model_version)
    if args.bf16:
        cfg["quantize"] = None
    return MathRecognition(cfg, weights, beam_size=args.beam_size, device=args.device,
                           coalesce_ratio=args.coalesce_ratio, mesh=mesh)


def build_server(args, mesh=None):
    """(MathRecognition, RecognitionServer) for the parsed ``args``."""
    recog = build_recognizer(args, mesh)
    server = RecognitionServer(
        recog, max_batch=args.max_batch, batch_window_ms=args.window_ms,
        max_queue=args.max_queue,
        bucket_key=recog.bucket_key,   # shape-pure batches: one decode per dispatch
        coalesce_ratio=recog.coalesce_ratio)
    return recog, server


def build_app(args, recog, mesh=None):
    """With ``--detect``: the App that shares ``recog`` (one model copy),
    its detector sharded over ``mesh``; else None."""
    if not args.detect:
        return None
    from ..app import App

    return App(detect_weights=args.detect_weights, stitch=args.stitch, recognizer=recog,
               device=args.device, detect_mesh=mesh)


def build_page_server(args, recog, server: RecognitionServer, mesh=None) -> PageServer | None:
    """With ``--detect``: a PageServer whose App shares ``recog`` and sends
    its crops through ``server``; else None."""
    app = build_app(args, recog, mesh)
    return None if app is None else PageServer(app.detect_and_crop, server)


def selftest(server: RecognitionServer, n: int, rate: float = 0.0,
             page_server: PageServer | None = None) -> dict:
    """Submit ``n`` flat synthetic crops open-loop (a burst, or paced at
    ``rate`` per second), wait for every answer and return the stats; with
    ``page_server``, then push two white 640x1280 pages through it."""
    from ..data.synthetic import synth_sample

    rng = np.random.default_rng(0)
    crops = [synth_sample(rng)[0] for _ in range(n)]
    t0 = time.monotonic()
    futures = []
    for i, crop in enumerate(crops):
        if rate > 0:
            delay = t0 + i / rate - time.monotonic()
            if delay > 0:
                time.sleep(delay)
        futures.append(server.submit(crop))
    out = [f.result(timeout=1800.0) for f in futures]
    wall = time.monotonic() - t0
    if not all(isinstance(s, str) for s in out):
        raise RuntimeError("a selftest request returned no string")
    stats = {"selftest": n, "wall_s": round(wall, 3), "crops_per_s": round(n / wall, 3),
             "answers_sha1": hashlib.sha1("\n".join(out).encode()).hexdigest(),
             **server.stats()}
    if page_server is not None:
        pages = [np.full((640, 1280), 255, np.uint8) for _ in range(2)]
        regions = [page_server.recognize_page(p, timeout=600.0) for p in pages]
        stats["pages"] = page_server.stats()["pages"]
        stats["selftest_pages"] = [len(r) for r in regions]
    return stats


def main(argv=None) -> int:
    argv = sys.argv[1:] if argv is None else list(argv)
    args = parse_args(argv)
    mesh = start_mesh(args, argv)
    try:
        return _serve(args, mesh)
    finally:
        if mesh is not None:
            mesh.shutdown()


def _serve(args, mesh) -> int:
    recog, server = build_server(args, mesh)
    page_server = build_page_server(args, recog, server, mesh)
    if args.selftest:
        try:
            stats = selftest(server, args.selftest, args.selftest_rate, page_server)
        finally:
            if page_server is not None:
                page_server.close()
            server.close()
        print(json.dumps({"model_version": args.model_version, "device": args.device,
                          "quantize": recog.config.get("quantize"),
                          "data_parallel": args.data_parallel, **stats}), flush=True)
        return 0
    httpd = ThreadingHTTPServer(
        (args.host, args.port),
        build_handler(server, page_server, config_info={"model_version": args.model_version,
                                                        "beam_size": int(recog.beam_size)}))
    print(f"serving {args.model_version} on http://{args.host}:{httpd.server_address[1]} "
          f"({args.device}, quantize {recog.config.get('quantize')}, beam {recog.beam_size}, "
          f"max_batch {args.max_batch}, window {args.window_ms} ms, detect {args.detect})",
          flush=True)
    try:
        httpd.serve_forever()
    except KeyboardInterrupt:
        pass
    finally:
        httpd.server_close()
        if page_server is not None:
            page_server.close()
        server.close()
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
