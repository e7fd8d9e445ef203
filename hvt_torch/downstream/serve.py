"""Inference server: config → HTTP top-k endpoint — port of
``hvt/downstream/serve.py`` (live-model engine).

Endpoints:
* ``GET /healthz`` → ``{"status": "ok", "model": ..., "classes": N, ...}``
* ``GET /stats`` → request/dispatch counters, batch occupancy, mean step time
* ``POST /predict`` (body: an image Pillow can read; optional ``?topk=K``) →
  ``{"classes": [...], "class_ids": [...], "probs": [...]}`` (+ ``tier_ids``
  with hierarchical decoding).

The forward runs at one fixed batch shape. Server threads decode and crop
their image, then enqueue it; a single batcher thread owns the device and
coalesces up to ``batch`` waiting requests (2 ms grace window) into one
forward, padding the batch with zero rows.
"""

from __future__ import annotations

import io
import json
import queue as queue_lib
import threading
import time
from concurrent.futures import ThreadPoolExecutor
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from typing import Optional

import numpy as np

from hvt_torch import config as config_lib
from hvt_torch import device as device_lib
from hvt_torch import parallel
from hvt_torch.data import DevicePrep, build_loader
from hvt_torch.downstream import predict as predict_lib
from hvt_torch.models import build_model


class InferenceEngine:
    """Owns the model on its device; thread-safe ``predict_image()``.

    ``quantize="int8"`` serves the w8a8 forward (:mod:`hvt_torch.ops.quant`);
    ``calibrate=N`` gives it static activation scales from the first N eval
    batches, calibrated before the warm-up (hvt's checks: calibrate without
    int8 raises). ``device`` None means the CUDA card (an error without
    one); pass ``device="cpu"`` to serve through the kernels' plain
    versions."""

    def __init__(self, config: config_lib.Config, *, batch: int = 1, use_ema: bool = True,
                 hierarchical: bool = False, topk: int = 5, quantize: "str | None" = None,
                 calibrate: int = 0, device=None):
        if calibrate and quantize != "int8":
            raise ValueError("calibrate requires quantize='int8'")
        parallel.one_process_entry(config, "serving")
        self.device = device_lib.resolve(device)
        self.config = config
        self.model_name = config.model.name
        self.native_artifact = False
        self.batch = max(1, batch)

        loader, info = build_loader(config, is_train=False)
        self.classes = list(getattr(loader.dataset, "classes", ()))
        self.num_classes = info.num_classes
        data_cfg = config.eval_dataset
        self.transform = loader.transform
        model = build_model(config, info.num_classes)
        unsupported = self.device.type == "cuda" and model.cuda_unsupported(data_cfg.crop_size)
        if unsupported:
            raise NotImplementedError(
                f"{config.model.name} {dict(config.model.args)} at {data_cfg.crop_size} px "
                "does not run on the CUDA kernels yet: " + "; ".join(unsupported)
            )
        self.model = predict_lib._resolve_weights(config, model, use_ema).to(self.device).eval()
        prep = DevicePrep.from_config(data_cfg, config.precision)
        lookups = (predict_lib.taxonomy_lookups(self.classes, info.num_classes)
                   if hierarchical else None)
        self.hierarchical = hierarchical
        self._k = min(topk, info.fine_grained_num_classes)
        self._crop = data_cfg.crop_size
        self.quantize = quantize
        self.act_scales = (predict_lib.live_act_scales(self.model, prep, loader, calibrate)
                           if calibrate else None)
        self._step = predict_lib.build_topk_step(self.model, prep, lookups, self._k, self.device,
                                                 quantize=quantize, act_scales=self.act_scales)
        self._warm_and_start()

    def _warm_and_start(self) -> None:
        self._step(np.zeros((self.batch, self._crop, self._crop, 3), np.uint8))  # builds kernels
        self._queue: queue_lib.Queue = queue_lib.Queue()
        self._closed = False
        self._stats_lock = threading.Lock()
        self._stats = {"requests": 0, "errors": 0, "dispatches": 0, "rows": 0, "step_ms_sum": 0.0}
        self._batcher = threading.Thread(target=self._batch_loop, daemon=True)
        self._batcher.start()

    def stats(self) -> dict:
        """Serving counters: requests, dispatches (forwards), mean rows per
        dispatch, batch occupancy, mean step wall time."""
        with self._stats_lock:
            s = dict(self._stats)
        d = max(1, s["dispatches"])
        return {
            "model": self.model_name,
            "batch": self.batch,
            "requests": s["requests"],
            "errors": s["errors"],
            "dispatches": s["dispatches"],
            "mean_rows_per_dispatch": round(s["rows"] / d, 2),
            "mean_occupancy": round(s["rows"] / (d * self.batch), 3),
            "mean_step_ms": round(s["step_ms_sum"] / d, 2),
        }

    def _batch_loop(self):
        while True:
            first = self._queue.get()
            if first is None:  # close() sentinel
                return
            pendings = [first]
            closing = False
            while len(pendings) < self.batch:
                try:
                    item = self._queue.get(timeout=0.002)
                except queue_lib.Empty:
                    break
                if item is None:  # sentinel raced a burst: finish, then exit
                    closing = True
                    break
                pendings.append(item)
            images = np.zeros((self.batch, self._crop, self._crop, 3), np.uint8)
            for row, p in enumerate(pendings):
                images[row] = p["arr"]
            t0 = time.perf_counter()
            try:
                out = self._step(images)
                for row, p in enumerate(pendings):
                    p["result"] = (row, out)
            except Exception as e:  # surfaced to every waiting request
                for p in pendings:
                    p["error"] = e
            finally:
                step_ms = (time.perf_counter() - t0) * 1e3
                with self._stats_lock:
                    self._stats["dispatches"] += 1
                    self._stats["rows"] += len(pendings)
                    self._stats["step_ms_sum"] += step_ms
                    self._stats["errors"] += sum("error" in p for p in pendings)
                for p in pendings:
                    p["event"].set()
            if closing:
                return

    def close(self) -> None:
        """Retire the batcher thread (idempotent); queued requests fail cleanly."""
        self._closed = True
        if self._batcher.is_alive():
            self._queue.put(None)
            self._batcher.join(timeout=10)
        while True:
            try:
                p = self._queue.get_nowait()
            except queue_lib.Empty:
                return
            if p is not None:
                p["error"] = RuntimeError("InferenceEngine is closed")
                with self._stats_lock:
                    self._stats["errors"] += 1
                p["event"].set()

    def predict_image(self, data: bytes, topk: Optional[int] = None) -> dict:
        """One encoded image → top-k record (decode runs in the calling thread)."""
        from PIL import Image

        if topk is not None and topk <= 0:
            raise ValueError(f"topk must be positive, got {topk}")
        if self._closed:
            raise RuntimeError("InferenceEngine is closed")
        with self._stats_lock:
            self._stats["requests"] += 1
        try:
            with Image.open(io.BytesIO(data)) as img:
                arr = self.transform(img.convert("RGB"))
        except Exception:
            with self._stats_lock:
                self._stats["errors"] += 1
            raise
        pending = {"arr": arr, "event": threading.Event()}
        self._queue.put(pending)
        while not pending["event"].wait(timeout=0.5):
            if self._closed and not self._batcher.is_alive():
                raise RuntimeError("InferenceEngine is closed")
        if "error" in pending:
            raise RuntimeError(f"inference failed: {pending['error']}")
        row, (top_i, top_p, tiers, n_allowed) = pending["result"]
        k = self._k if topk is None else min(topk, self._k)
        return predict_lib.topk_record(self.classes, row, top_i, top_p, tiers, n_allowed, k)


def make_server(engine: InferenceEngine, host: str = "127.0.0.1", port: int = 0,
                pool_threads: int = 16) -> ThreadingHTTPServer:
    """→ a ready (unstarted) HTTP server on a fixed worker pool; port 0 picks a free port."""

    class Handler(BaseHTTPRequestHandler):
        def log_message(self, fmt, *args):  # quiet by default
            pass

        def _send(self, code: int, payload: dict):
            body = json.dumps(payload).encode()
            self.send_response(code)
            self.send_header("Content-Type", "application/json")
            self.send_header("Content-Length", str(len(body)))
            self.end_headers()
            self.wfile.write(body)

        def do_GET(self):
            path = self.path.split("?")[0]
            if path == "/healthz":
                self._send(200, {
                    "status": "ok",
                    "model": engine.model_name,
                    "classes": (list(engine.num_classes) if isinstance(engine.num_classes, tuple)
                                else engine.num_classes),
                    "hierarchical": engine.hierarchical,
                    "native_artifact": engine.native_artifact,
                })
            elif path == "/stats":
                self._send(200, engine.stats())
            else:
                self._send(404, {"error": f"unknown path {self.path!r}"})

        def do_POST(self):
            path, _, query = self.path.partition("?")
            if path != "/predict":
                self._send(404, {"error": f"unknown path {self.path!r}"})
                return
            topk = None
            for part in query.split("&"):
                if part.startswith("topk="):
                    try:
                        topk = int(part[5:])
                    except ValueError:
                        self._send(400, {"error": f"bad topk {part[5:]!r}"})
                        return
                    if topk <= 0:
                        self._send(400, {"error": f"topk must be positive, got {topk}"})
                        return
            length = int(self.headers.get("Content-Length") or 0)
            if length <= 0:
                self._send(400, {"error": "empty body (expected image bytes)"})
                return
            data = self.rfile.read(length)
            try:
                rec = engine.predict_image(data, topk=topk)
            except Exception as e:  # bad image etc. → client error, not 500
                self._send(400, {"error": f"cannot decode image: {e}"})
                return
            self._send(200, rec)

    class PooledHTTPServer(ThreadingHTTPServer):
        daemon_threads = True
        # listen backlog: socketserver's default of 5 drops the connections of a
        # burst of concurrent clients, which then retry a second later
        request_queue_size = 128

        def __init__(self, *a, **kw):
            super().__init__(*a, **kw)
            self._pool = ThreadPoolExecutor(max_workers=pool_threads,
                                            thread_name_prefix="hvt-serve")

        def process_request(self, request, client_address):
            self._pool.submit(self.process_request_thread, request, client_address)

        def server_close(self):
            super().server_close()
            self._pool.shutdown(wait=False)

    return PooledHTTPServer((host, port), Handler)


def serve(config: config_lib.Config, *, host: str = "127.0.0.1", port: int = 8000,
          **engine_kwargs) -> None:
    engine = InferenceEngine(config, **engine_kwargs)
    server = make_server(engine, host, port)
    print(f"[{config.run_name}] serving {engine.model_name} on {engine.device} at "
          f"http://{host}:{server.server_address[1]} (POST /predict, GET /healthz, GET /stats)",
          flush=True)
    try:
        server.serve_forever()
    finally:  # Ctrl-C / shutdown(): retire the batcher cleanly
        server.server_close()
        engine.close()
