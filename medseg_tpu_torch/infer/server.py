"""Minimal batched HTTP inference server over the cascade Pipeline.

Counterpart of medseg_tpu/infer/server.py:47-233: a dependency-free HTTP
endpoint (stdlib http.server) that accepts base64-encoded PNG/JPEG images and
returns the cascade verdict (classify -> COVID gate -> segment -> overlay).
Requests within a small window are micro-batched through one forward per
model.  Images are decoded and overlays encoded with PIL, as in the JAX
package.

POST /predict      {"image": <base64>, "segmentation_model": "ResNetUnet",
                    "overlay_opacity": 0.5, "classification_model": "ResNet18"}
  -> {"prediction", "confidence", "analysis", "overlay": <base64 png>|null}
GET  /health       -> {"status": "ok", "models": {...}, "batching": {...}}

Every model of the zoo can be named, CLIP and CLIPSeg included; a request
that fails (an unknown model, a CLIP without prompt features) is answered
with a 400 carrying the error's text.
"""

from __future__ import annotations

import base64
import io
import json
import queue
import threading
import time
from collections import defaultdict
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer

import numpy as np

from medseg_tpu_torch.core.config import EvalConfig
from medseg_tpu_torch.infer.pipeline import Pipeline


def _decode_image(b64: str) -> np.ndarray:
    from PIL import Image

    raw = base64.b64decode(b64)
    return np.asarray(Image.open(io.BytesIO(raw)).convert("RGB"))


def _encode_png(arr: np.ndarray) -> str:
    from PIL import Image

    buf = io.BytesIO()
    Image.fromarray(arr).save(buf, format="PNG")
    return base64.b64encode(buf.getvalue()).decode()


class InferenceServer:
    """Micro-batching server: handler threads enqueue decoded images; one
    worker drains the queue (up to Pipeline.MAX_BATCH within a ~10 ms
    window), groups compatible requests, and runs one forward per model
    for the whole group."""

    BATCH_WINDOW_S = 0.010
    # ceiling on one queued request's wall time; expired waits return 503
    # instead of holding the handler thread forever
    REQUEST_TIMEOUT_S = 1800.0

    def __init__(self, cfg: EvalConfig = EvalConfig(), **pipeline_kwargs):
        """pipeline_kwargs go to Pipeline (device: the card unless "cpu")."""
        self.pipeline = Pipeline(cfg, **pipeline_kwargs)
        self.lock = threading.Lock()  # the pipeline serves one group at a time
        # optional static GET routes: path -> (content_type, bytes)
        self.ui_routes: dict = {}
        self._queue: queue.Queue = queue.Queue()
        self.stats = {"requests": 0, "batches": 0, "max_batch": 0,
                      "worker_errors": 0}
        self._worker = threading.Thread(target=self._worker_loop, daemon=True)
        self._worker.start()

    def _worker_loop(self):
        # The entire iteration body is fenced: an exception anywhere must
        # fail the in-flight group, not kill the single worker thread (a
        # dead worker would deadlock every later request).
        while True:
            group = [self._queue.get()]
            try:
                deadline = time.time() + self.BATCH_WINDOW_S
                while len(group) < Pipeline.MAX_BATCH:
                    remaining = deadline - time.time()
                    if remaining <= 0:
                        break
                    try:
                        group.append(self._queue.get(timeout=remaining))
                    except queue.Empty:
                        break
                # one forward per (models, opacity)-compatible bucket
                buckets = defaultdict(list)
                for item in group:
                    buckets[item["key"]].append(item)
                self.stats["batches"] += len(buckets)
                for (cls_name, seg_name, opacity), items in buckets.items():
                    self.stats["max_batch"] = max(self.stats["max_batch"],
                                                  len(items))
                    self.stats["requests"] += len(items)
                    try:
                        with self.lock:
                            self.pipeline._load_models(cls_name, seg_name)
                            outs = self.pipeline.process_batch(
                                [it["img"] for it in items], seg_name,
                                overlay_opacity=opacity)
                    except Exception as e:  # noqa: BLE001
                        self.stats["worker_errors"] += 1
                        outs = [e] * len(items)
                    for item, out in zip(items, outs):
                        item["result"] = out
                        item["event"].set()
            except Exception as e:  # noqa: BLE001 — outer fence
                self.stats["worker_errors"] += 1
                for item in group:
                    if not item["event"].is_set():
                        item["result"] = e
                        item["event"].set()

    def warmup(self, cls_name: str = "ResNet18", seg_name: str = "ResNetUnet",
               batch_sizes=None, log=print):
        """Load the model pair and run both forwards at every micro-batch
        shape the server can route to (B in {1,2,4,8}), before accepting
        traffic, for any pair of the zoo.  On the card this is where the
        photometric kernel is built and loaded, and cuDNN picks its plans
        for each shape; after it, a full MAX_BATCH burst meets no new batch
        shape."""
        if batch_sizes is None:
            batch_sizes = []
            b = 1
            while b <= Pipeline.MAX_BATCH:
                batch_sizes.append(b)
                b *= 2
        t0 = time.time()
        with self.lock:
            p = self.pipeline
            p._load_models(cls_name, seg_name)
            for b in batch_sizes:
                tb = time.time()
                batch = np.zeros((b, 64, 64, 3), np.uint8)
                # drive both forwards directly: process_image reaches the
                # segmentation forward only behind the COVID gate
                cls_size, cls_method = p.input_grid(cls_name)
                seg_size, seg_method = p.input_grid(seg_name)
                p._predict_classification(p._to_grid(batch, cls_size, p.device, cls_method))
                p._predict_segmentation(p._to_grid(batch, seg_size, p.device, seg_method))
                log(f"[serve] warmup B={b} ({cls_name}+{seg_name}) "
                    f"{time.time() - tb:.1f}s")
        log(f"[serve] warmup done: B={batch_sizes} for both models in "
            f"{time.time() - t0:.1f}s")

    def handle_predict(self, payload: dict) -> dict:
        img = _decode_image(payload["image"])  # host decode off the hot lock
        seg_name = payload.get("segmentation_model", "ResNetUnet")
        cls_name = payload.get("classification_model", "ResNet18")
        opacity = float(payload.get("overlay_opacity", 0.5))
        item = {"img": img, "key": (cls_name, seg_name, opacity),
                "event": threading.Event(), "result": None}
        self._queue.put(item)
        if not item["event"].wait(timeout=self.REQUEST_TIMEOUT_S):
            raise TimeoutError(
                f"inference did not complete within {self.REQUEST_TIMEOUT_S:.0f}s")
        if isinstance(item["result"], Exception):
            raise item["result"]
        pred, conf, overlay, text = item["result"]
        return {
            "prediction": pred,
            "confidence": conf,
            "analysis": text,
            "overlay": _encode_png(overlay) if overlay is not None else None,
        }

    def handler_class(self):
        server = self

        class Handler(BaseHTTPRequestHandler):
            def _send(self, code: int, body: dict):
                data = json.dumps(body).encode()
                self.send_response(code)
                self.send_header("Content-Type", "application/json")
                self.send_header("Content-Length", str(len(data)))
                self.end_headers()
                self.wfile.write(data)

            def do_GET(self):
                if self.path in server.ui_routes:
                    ctype, data = server.ui_routes[self.path]
                    self.send_response(200)
                    self.send_header("Content-Type", ctype)
                    self.send_header("Content-Length", str(len(data)))
                    self.end_headers()
                    self.wfile.write(data)
                elif self.path == "/health":
                    cls = server.pipeline._cls
                    seg = server.pipeline._seg
                    self._send(200, {"status": "ok", "models": {
                        "classification": cls[0] if cls else None,
                        "segmentation": seg[0] if seg else None},
                        "batching": dict(server.stats)})
                else:
                    self._send(404, {"error": "not found"})

            def do_POST(self):
                if self.path != "/predict":
                    self._send(404, {"error": "not found"})
                    return
                try:
                    n = int(self.headers.get("Content-Length", 0))
                    payload = json.loads(self.rfile.read(n))
                    self._send(200, server.handle_predict(payload))
                except TimeoutError as e:
                    self._send(503, {"error": str(e)})
                except Exception as e:  # noqa: BLE001
                    self._send(400, {"error": str(e)})

            def log_message(self, *args):  # quiet
                pass

        return Handler

    def serve(self, host: str = "127.0.0.1", port: int = 8000):
        httpd = ThreadingHTTPServer((host, port), self.handler_class())
        print(f"[serve] listening on http://{host}:{port}")
        httpd.serve_forever()

    def start_background(self, host: str = "127.0.0.1", port: int = 0):
        """Start on an ephemeral port; returns (server, port)."""
        httpd = ThreadingHTTPServer((host, port), self.handler_class())
        t = threading.Thread(target=httpd.serve_forever, daemon=True)
        t.start()
        return httpd, httpd.server_address[1]
