"""Production inference server: micro-batched detection over HTTP — the
port of `second_tpu/serve.py`.

The serving counterpart of the training CLI — the reference has no serving
story beyond the kittiviewer backend (`second/kittiviewer/backend.py`); this
adds the piece a deployment needs: a persistent process that owns the card,
warms the kernels, aggregates concurrent requests into device batches
(micro-batching window), and reports latency statistics.

Endpoints (JSON unless noted):
  POST /v1/detect   {"points": [[x, y, z, intensity], ...]} → detections
                    (or raw little-endian float32 body with
                     Content-Type: application/octet-stream, N*4 floats)
  GET  /healthz     liveness + model info
  GET  /stats       request count, batch-size histogram, latency quantiles

Usage:
  python -m second_tpu_torch.serve --config_path CFG --model_dir DIR \
      [--port 8500] [--max_batch 8] [--batch_window_ms 5] [--device cpu]
"""

from __future__ import annotations

import argparse
import json
import queue
import threading
import time
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from typing import Dict, Optional

import numpy as np


class _Pending:
    __slots__ = ("points", "event", "result", "error", "t_enqueue")

    def __init__(self, points):
        self.points = points
        self.event = threading.Event()
        self.result = None
        self.error: Optional[str] = None
        self.t_enqueue = time.perf_counter()


class MicroBatcher:
    """Aggregates concurrent requests into device batches.

    A dedicated worker drains the queue: it takes the first waiting request,
    then collects more for up to `window_ms` or until `max_batch`, and runs
    ONE forward over the batch as it is (`InferenceContext.inference_batch`,
    which enters `torch.inference_mode` on this thread). No padding: JAX
    pads to a power of two only to bound its compiles per batch size, and
    each frame's detections do not depend on the others of its batch. The
    warmup pass runs `max_batch` and 1 once."""

    def __init__(self, ctx, max_batch: int = 8, window_ms: float = 5.0):
        self.ctx = ctx
        self.max_batch = max_batch
        self.window_s = window_ms / 1000.0
        self.q: "queue.Queue[_Pending]" = queue.Queue()
        self.lock = threading.Lock()
        self.stats: Dict = {"requests": 0, "batches": 0,
                            "batch_hist": {}, "latency_ms": []}
        self._thread = threading.Thread(target=self._loop, daemon=True)
        self._stop = False
        self._thread.start()

    def warmup(self):
        dummy = np.zeros((128, 4), np.float32)
        for bs in (self.max_batch, 1):
            self.ctx.inference_batch([dummy] * bs)

    def submit(self, points) -> Dict:
        p = _Pending(points)
        self.q.put(p)
        p.event.wait()
        if p.error:
            raise RuntimeError(p.error)
        return p.result

    def close(self):
        self._stop = True
        self._thread.join()

    def _loop(self):
        while not self._stop:
            try:
                first = self.q.get(timeout=0.1)
            except queue.Empty:
                continue
            batch = [first]
            deadline = time.perf_counter() + self.window_s
            while len(batch) < self.max_batch:
                remaining = deadline - time.perf_counter()
                if remaining <= 0:
                    break
                try:
                    batch.append(self.q.get(timeout=remaining))
                except queue.Empty:
                    break
            try:
                results = self.ctx.inference_batch([p.points for p in batch])
                for p, r in zip(batch, results):
                    p.result = r
            except Exception as e:  # propagate per-request
                for p in batch:
                    p.error = f"{type(e).__name__}: {e}"
            now = time.perf_counter()
            with self.lock:
                self.stats["requests"] += len(batch)
                self.stats["batches"] += 1
                h = self.stats["batch_hist"]
                h[len(batch)] = h.get(len(batch), 0) + 1
                for p in batch:
                    lat = (now - p.t_enqueue) * 1000
                    self.stats["latency_ms"].append(lat)
                self.stats["latency_ms"] = self.stats["latency_ms"][-10000:]
            for p in batch:
                p.event.set()

    def summary(self) -> Dict:
        with self.lock:
            lat = sorted(self.stats["latency_ms"])
            out = {
                "requests": self.stats["requests"],
                "batches": self.stats["batches"],
                "batch_hist": dict(self.stats["batch_hist"]),
            }
            if lat:
                q = lambda f: round(lat[min(len(lat) - 1,
                                            int(f * len(lat)))], 2)
                out["latency_ms"] = {"p50": q(0.5), "p90": q(0.9),
                                     "p99": q(0.99)}
            return out


def make_handler(batcher: MicroBatcher, model_info: Dict):
    class Handler(BaseHTTPRequestHandler):
        def log_message(self, *args):   # quiet access log
            pass

        def _send(self, code: int, payload: Dict):
            body = json.dumps(payload).encode()
            self.send_response(code)
            self.send_header("Content-Type", "application/json")
            self.send_header("Content-Length", str(len(body)))
            self.end_headers()
            self.wfile.write(body)

        def do_GET(self):
            if self.path == "/healthz":
                self._send(200, {"status": "ok", **model_info})
            elif self.path == "/stats":
                self._send(200, batcher.summary())
            else:
                self._send(404, {"error": "unknown path"})

        def do_POST(self):
            if self.path != "/v1/detect":
                self._send(404, {"error": "unknown path"})
                return
            try:
                n = int(self.headers.get("Content-Length", 0))
                raw = self.rfile.read(n)
                ctype = self.headers.get("Content-Type", "application/json")
                if ctype.startswith("application/octet-stream"):
                    pts = np.frombuffer(raw, np.float32).reshape(-1, 4)
                else:
                    pts = np.asarray(json.loads(raw)["points"], np.float32)
                    if pts.ndim != 2 or pts.shape[1] < 3:
                        raise ValueError("points must be [N, >=3]")
                det = batcher.submit(pts)
                self._send(200, {
                    "status": "ok",
                    "num_detections": int(len(det["scores"])),
                    "boxes": np.asarray(det["boxes"],
                                        np.float64).round(4).tolist(),
                    "scores": np.asarray(det["scores"],
                                         np.float64).round(4).tolist(),
                    "class_names": det["class_names"],
                })
            except Exception as e:
                self._send(400, {"status": "error",
                                 "error": f"{type(e).__name__}: {e}"})

    return Handler


def build_server(config_path, model_dir=None, port: int = 8500,
                 max_batch: int = 8, window_ms: float = 5.0,
                 max_points: int = 25000, device="cuda"):
    """Returns (ThreadingHTTPServer, MicroBatcher) — caller runs
    serve_forever(). Split from main() so tests can drive it in-process.
    The net runs on `device`, the CUDA card unless the caller asks for the
    CPU."""
    from .core.inference_ctx import InferenceContext
    ctx = InferenceContext(config_path)
    ctx.build(model_dir, max_points=max_points, device=device)
    batcher = MicroBatcher(ctx, max_batch=max_batch, window_ms=window_ms)
    batcher.warmup()
    info = {"config": str(config_path),
            "classes": list(ctx.assigner.classes),
            "max_batch": max_batch}
    server = ThreadingHTTPServer(("0.0.0.0", port),
                                 make_handler(batcher, info))
    return server, batcher


def main(argv=None):
    parser = argparse.ArgumentParser(description=__doc__)
    parser.add_argument("--config_path", required=True)
    parser.add_argument("--model_dir", default=None)
    parser.add_argument("--port", type=int, default=8500)
    parser.add_argument("--max_batch", type=int, default=8)
    parser.add_argument("--batch_window_ms", type=float, default=5.0)
    parser.add_argument("--max_points", type=int, default=25000)
    parser.add_argument("--device", default="cuda",
                        help="torch device; the CUDA card by default")
    args = parser.parse_args(argv)
    server, _ = build_server(args.config_path, args.model_dir, args.port,
                             args.max_batch, args.batch_window_ms,
                             args.max_points, args.device)
    print(f"serving on :{server.server_address[1]} (POST /v1/detect)",
          flush=True)
    server.serve_forever()


if __name__ == "__main__":
    main()
