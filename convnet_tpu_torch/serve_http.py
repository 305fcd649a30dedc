"""HTTP serving endpoint around ``serve.Predictor`` (counterpart of
convnet_tpu/serve_http.py).

A stdlib-only threaded HTTP server that accepts images and returns class
predictions, with request micro-batching: concurrent requests are coalesced
into one padded device batch (the Predictor's batch), so serving throughput
approaches the offline batch rate instead of paying one forward a request.
The batcher thread runs each forward in inference mode.

Endpoints:
  GET  /healthz          → {"status": "ok", "batch_size": N, ...}
  POST /predict          body = JPEG/PNG bytes (Content-Type image/*)
                           or a raw npy array (application/x-npy,
                           HWC uint8/float or NHWC batch)
                         → {"topk": [[class_idx, logit], ...],
                            "decoder": "npy" | "native" | "pil"}
                           (one list per image for batched npy input)

Query params: ``topk`` (default 5).

Usage:
    server = PredictionServer(predictor, port=8000).start()
    ...
    server.stop()

or ``python -m convnet_tpu_torch.serve_http --model resnet --checkpoint ...``
(``--exported`` serves a ``Predictor.export`` artifact instead).
"""

from __future__ import annotations

import io
import json
import logging
import queue
import threading
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from typing import Optional

import numpy as np
import torch

log = logging.getLogger(__name__)


class _Request:
    __slots__ = ("image", "event", "logits", "error")

    def __init__(self, image):
        self.image = image          # (H, W, C) uint8/float
        self.event = threading.Event()
        self.logits = None
        self.error: Optional[str] = None


class _Batcher:
    """Coalesce concurrent single-image requests into one device batch.

    A worker thread drains the queue: it takes the first pending
    request, then greedily collects more for up to ``max_wait_ms`` or
    until ``batch_size`` is reached, and runs ONE ``predict_logits``
    call. Under load the wait never triggers (the queue is non-empty);
    at low rates a lone request pays at most ``max_wait_ms`` extra
    latency. ``batches`` counts the device batches formed."""

    def __init__(self, predictor, max_wait_ms: float = 5.0):
        self.predictor = predictor
        self.max_wait = max_wait_ms / 1e3
        self.q: "queue.Queue[_Request]" = queue.Queue()
        self.batches = 0
        self._stop = threading.Event()
        self._thread = threading.Thread(target=self._run, daemon=True,
                                        name="serve-batcher")
        self._thread.start()

    def submit(self, image) -> _Request:
        r = _Request(image)
        self.q.put(r)
        return r

    def stop(self):
        self._stop.set()
        self.q.put(None)  # wake the worker
        self._thread.join()

    @torch.inference_mode()
    def _run(self):
        bs = self.predictor.batch_size
        while not self._stop.is_set():
            first = self.q.get()
            if first is None:
                continue
            batch = [first]
            deadline = self.max_wait
            while len(batch) < bs:
                try:
                    r = self.q.get(timeout=deadline)
                except queue.Empty:
                    break
                if r is None:
                    break
                batch.append(r)
            try:
                x = np.stack([r.image for r in batch])
                logits = self.predictor.predict_logits(x)
                self.batches += 1
                for r, l in zip(batch, logits):
                    r.logits = l
            except Exception as e:  # surface to every waiting request
                for r in batch:
                    r.error = f"{type(e).__name__}: {e}"
            for r in batch:
                r.event.set()


def _decode_image(body: bytes, content_type: str, input_size: int):
    """Returns (images, batched, decoder): images = (N, H, W, C) float/uint8;
    decoder, what read the body: "npy", "native" (``csrc/jpegdec.cpp``) or
    "pil"."""
    if content_type == "application/x-npy":
        arr = np.load(io.BytesIO(body), allow_pickle=False)
        if arr.ndim == 3:
            return arr[None], False, "npy"
        if arr.ndim == 4:
            return arr, True, "npy"
        raise ValueError(f"npy input must be HWC or NHWC, got {arr.shape}")
    # image bytes: native C++ JPEG fast path, PIL fallback (handles PNG…)
    from convnet_tpu_torch.data import native
    out = native.decode_blobs([body], train=False, out_size=input_size)
    if out is not None:
        batch, fail = out
        if not fail[0]:
            return batch, False, "native"
    from convnet_tpu_torch.serve import _decode_jpeg_pil
    return _decode_jpeg_pil(body, input_size)[None], False, "pil"


class _HTTPServer(ThreadingHTTPServer):
    # socketserver's listen backlog of 5 (the reference's) drops the connects
    # of more concurrent clients than that: their SYN is sent again a second
    # later, or the connection is reset. 16 client threads met a p99 of
    # about 1 s.
    daemon_threads = True
    request_queue_size = 128


class PredictionServer:
    def __init__(self, predictor, host: str = "127.0.0.1", port: int = 8000,
                 max_wait_ms: float = 5.0):
        self.predictor = predictor
        self.batcher = _Batcher(predictor, max_wait_ms)
        outer = self

        class Handler(BaseHTTPRequestHandler):
            protocol_version = "HTTP/1.1"

            def log_message(self, fmt, *args):  # route through logging
                log.debug("%s " + fmt, self.address_string(), *args)

            def _send(self, code: int, payload: dict):
                body = json.dumps(payload).encode()
                self.send_response(code)
                self.send_header("Content-Type", "application/json")
                self.send_header("Content-Length", str(len(body)))
                self.end_headers()
                self.wfile.write(body)

            def do_GET(self):
                if self.path.split("?")[0] == "/healthz":
                    self._send(200, {
                        "status": "ok",
                        "batch_size": outer.predictor.batch_size,
                        "input_size": outer.predictor.input_size})
                else:
                    self._send(404, {"error": "unknown path"})

            def do_POST(self):
                path, _, query = self.path.partition("?")
                if path != "/predict":
                    return self._send(404, {"error": "unknown path"})
                try:
                    n = int(self.headers.get("Content-Length", 0))
                    body = self.rfile.read(n)
                    ctype = (self.headers.get("Content-Type") or
                             "image/jpeg").split(";")[0].strip()
                    topk = 5
                    for kv in query.split("&"):
                        if kv.startswith("topk="):
                            topk = max(1, int(kv[5:]))
                    images, batched, decoder = _decode_image(
                        body, ctype, outer.predictor.input_size)
                    sz = outer.predictor.input_size
                    if images.shape[1:3] != (sz, sz):
                        # the batcher coalesces requests into ONE stacked
                        # batch — mixed spatial sizes would poison it
                        raise ValueError(
                            f"input must be {sz}x{sz} (got "
                            f"{images.shape[1]}x{images.shape[2]}); image "
                            f"uploads are resized server-side, npy is not")
                except Exception as e:
                    return self._send(400, {"error": f"bad request: {e}"})
                reqs = [outer.batcher.submit(img) for img in images]
                for r in reqs:
                    r.event.wait()
                if any(r.error for r in reqs):
                    return self._send(500,
                                      {"error": next(r.error for r in reqs
                                                     if r.error)})
                results = []
                for r in reqs:
                    idx = np.argsort(-r.logits)[:topk]
                    results.append([[int(i), float(r.logits[i])]
                                    for i in idx])
                self._send(200, {"topk": results if batched else results[0],
                                 "decoder": decoder})

        self._httpd = _HTTPServer((host, port), Handler)
        self._serve_thread = None

    @property
    def port(self) -> int:  # resolved port (use port=0 for ephemeral)
        return self._httpd.server_address[1]

    def start(self) -> "PredictionServer":
        self._serve_thread = threading.Thread(
            target=self._httpd.serve_forever, daemon=True,
            name="serve-http")
        self._serve_thread.start()
        log.info("serving on %s:%d (batch %d, input %d)",
                 self._httpd.server_address[0], self.port,
                 self.predictor.batch_size, self.predictor.input_size)
        return self

    def stop(self):
        self._httpd.shutdown()
        self._httpd.server_close()
        if self._serve_thread is not None:
            self._serve_thread.join()
        self.batcher.stop()

    def serve_forever(self):  # blocking entry for __main__
        self.start()
        try:
            self._serve_thread.join()
        except KeyboardInterrupt:
            self.stop()


def _main(argv=None):
    import argparse
    p = argparse.ArgumentParser(description="convnet_tpu_torch model server")
    p.add_argument("--model", required=False, default="")
    p.add_argument("--model-config", default="")
    p.add_argument("--checkpoint", default="")
    p.add_argument("--exported", default="",
                   help="serve a Predictor.export artifact (torch.export) "
                        "instead of model+checkpoint")
    p.add_argument("--dtype", default="bf16")
    p.add_argument("--batch-size", type=int, default=64)
    p.add_argument("--input-size", type=int, default=None,
                   help="default: inferred from the checkpoint's dataset")
    def _devices_arg(v):
        if v == "all":
            return v
        try:
            n = int(v)
        except ValueError:
            raise argparse.ArgumentTypeError(
                f"--devices accepts 'all' or a positive device count, "
                f"got {v!r}")
        if n <= 0:
            raise argparse.ArgumentTypeError(
                f"--devices count must be positive, got {n}")
        return n

    p.add_argument("--devices", default=None, type=_devices_arg,
                   help="data-parallel serving: 'all' or a CUDA device "
                        "count (a replica on each, the batch split evenly)")
    p.add_argument("--host", default="127.0.0.1")
    p.add_argument("--port", type=int, default=8000)
    args = p.parse_args(argv)
    logging.basicConfig(level=logging.INFO)
    if args.exported:
        from convnet_tpu_torch.serve import load_exported
        predictor = load_exported(args.exported)
    else:
        import ast
        from convnet_tpu_torch.serve import Predictor
        predictor = Predictor(
            args.model or None,  # omitted → rebuilt from the checkpoint
            ast.literal_eval(args.model_config) if args.model_config else {},
            checkpoint=args.checkpoint or None, dtype=args.dtype,
            batch_size=args.batch_size, input_size=args.input_size,
            devices=args.devices)  # parser validated: None|'all'|int>0
    PredictionServer(predictor, args.host, args.port).serve_forever()


if __name__ == "__main__":
    _main()
