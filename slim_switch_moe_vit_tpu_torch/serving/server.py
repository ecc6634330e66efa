"""Dynamic-batching inference server over an exported artifact.

Stdlib-only serving front end for ``serving/export.py`` artifacts, the
JAX package's ``serving/server.py`` with its import pointed at this
package's ``export``:

- ``DynamicBatcher`` — the serving core: concurrent requests queue up,
  a single worker coalesces them (up to ``max_batch``, waiting at most
  ``max_wait_ms`` for stragglers) and runs ONE bucketed ``Predictor.predict``
  per coalesced batch. One device stream, full batches, no lock contention
  on the accelerator.
- ``serve`` / CLI — a threaded HTTP JSON endpoint:
    GET  /v1/health            -> {"status": "ok", ...manifest summary}
    POST /v1/predict           body {"instances": [img, ...], "k": optional}
      img = nested-list (H, W, 3) in the artifact's input dtype convention.
      Response {"predictions": [[logits...], ...]} or, with "k",
      {"classes": [[...]], "scores": [[...]]}.
"""
from __future__ import annotations

import json
import queue
import threading
import typing as typ

import numpy as np

from .export import Predictor, load_predictor


class DynamicBatcher:
    """Coalesce concurrent predict calls into single device batches."""

    _STOP = object()

    def __init__(self, predictor: Predictor, *,
                 max_batch: typ.Optional[int] = None,
                 max_wait_ms: float = 5.0):
        self._predictor = predictor
        self._max_batch = max_batch or max(predictor.batch_sizes)
        self._max_wait = max_wait_ms / 1000.0
        self._q: "queue.Queue" = queue.Queue()
        self._closed = False
        # serializes the closed-check+enqueue against close(): without it a
        # predict() that passed the check could enqueue after close()'s
        # drain and block forever on done.wait()
        self._close_lock = threading.Lock()
        img = int(predictor.manifest.get("img_size", 0))
        self._want_shape = (img, img, 3) if img else None
        self._worker = threading.Thread(target=self._run, daemon=True)
        self._worker.start()

    def predict(self, images: np.ndarray) -> np.ndarray:
        """Thread-safe; blocks until this request's rows come back.

        Shape is validated HERE, before coalescing — a malformed request
        must fail alone, never poison the valid requests batched with it."""
        if self._closed:
            raise RuntimeError("DynamicBatcher is closed")
        images = np.asarray(images)
        if images.ndim == 3:
            images = images[None]
        if self._want_shape and (images.ndim != 4
                                 or tuple(images.shape[1:])
                                 != self._want_shape):
            raise ValueError(
                f"request shape {images.shape} does not match the "
                f"artifact's (n, {', '.join(map(str, self._want_shape))})")
        done = threading.Event()
        slot: dict = {}
        with self._close_lock:
            if self._closed:
                raise RuntimeError("DynamicBatcher is closed")
            self._q.put((images, slot, done))
        done.wait()
        if "error" in slot:
            raise slot["error"]
        return slot["result"]

    def close(self):
        with self._close_lock:
            self._closed = True  # new predict() calls fail fast, never hang
            self._q.put(self._STOP)
        self._worker.join(timeout=10)
        # If the worker is still mid-batch (join timed out — a first-batch
        # compile can take longer), fail any queued requests now rather than
        # leave their callers blocked; the lock guarantees nothing new lands.
        while True:
            try:
                item = self._q.get_nowait()
            except queue.Empty:
                break
            if item is self._STOP:
                continue
            _, slot, done = item
            slot["error"] = RuntimeError("DynamicBatcher is closed")
            done.set()
        if self._worker.is_alive():
            # the drain may have consumed _STOP before the worker saw it —
            # re-arm so the worker terminates when its current batch finishes
            self._q.put(self._STOP)

    def _run(self):
        import time

        carry = None  # request that would have overflowed the last batch
        while True:
            item = carry if carry is not None else self._q.get()
            carry = None
            if item is self._STOP:
                return
            batch = [item]
            rows = item[0].shape[0]
            deadline = time.monotonic() + self._max_wait
            while rows < self._max_batch:
                remaining = deadline - time.monotonic()
                if remaining <= 0:
                    break
                try:
                    nxt = self._q.get(timeout=remaining)
                except queue.Empty:
                    break
                if nxt is self._STOP:
                    self._q.put(self._STOP)  # re-arm for the outer loop
                    break
                if rows + nxt[0].shape[0] > self._max_batch:
                    carry = nxt  # keep the coalesced batch <= max_batch
                    break        # (a single oversized request still runs
                    #              alone; Predictor chunks it internally)
                batch.append(nxt)
                rows += nxt[0].shape[0]
            try:
                preds = self._predictor.predict(
                    np.concatenate([b[0] for b in batch], axis=0))
            except Exception as e:  # noqa: BLE001 - fan the error out
                for _, slot, done in batch:
                    slot["error"] = e
                    done.set()
                continue
            i = 0
            for images, slot, done in batch:
                n = images.shape[0]
                slot["result"] = preds[i:i + n]
                i += n
                done.set()


def _make_handler(batcher: DynamicBatcher, predictor: Predictor):
    from http.server import BaseHTTPRequestHandler

    class Handler(BaseHTTPRequestHandler):
        def _send(self, code: int, payload: dict):
            body = json.dumps(payload).encode()
            self.send_response(code)
            self.send_header("Content-Type", "application/json")
            self.send_header("Content-Length", str(len(body)))
            self.end_headers()
            self.wfile.write(body)

        def do_GET(self):  # noqa: N802 - http.server API
            if self.path.rstrip("/") == "/v1/health":
                m = predictor.manifest
                self._send(200, {
                    "status": "ok", "model": m.get("model_name"),
                    "platform": m.get("platform"),
                    "batch_sizes": m.get("batch_sizes"),
                })
            else:
                self._send(404, {"error": "not found"})

        def do_POST(self):  # noqa: N802
            if self.path.rstrip("/") != "/v1/predict":
                self._send(404, {"error": "not found"})
                return
            try:
                try:
                    length = int(self.headers.get("Content-Length", "0"))
                    req = json.loads(self.rfile.read(length))
                    dtype = predictor.manifest["input_dtype"]
                    images = np.asarray(req["instances"],
                                        np.uint8 if dtype == "uint8" else
                                        np.float32)
                except Exception as e:  # noqa: BLE001 - client payload
                    self._send(400, {"error": f"{type(e).__name__}: {e}"})
                    return
                try:
                    logits = batcher.predict(images)
                except ValueError as e:  # shape validation = client error
                    self._send(400, {"error": f"{type(e).__name__}: {e}"})
                    return
                k = req.get("k")
                if k is not None:
                    try:
                        k = int(k)
                    except (TypeError, ValueError):
                        self._send(400, {"error": f"invalid k: {k!r}"})
                        return
                    if k < 1:
                        self._send(400, {"error": f"k must be >= 1, got {k}"})
                        return
                    k = min(k, logits.shape[1])
                    idx = np.argsort(-logits, axis=1)[:, :k]
                    z = logits - logits.max(axis=1, keepdims=True)
                    p = np.exp(z)
                    p /= p.sum(axis=1, keepdims=True)
                    self._send(200, {
                        "classes": idx.tolist(),
                        "scores": np.take_along_axis(p, idx, 1).tolist(),
                    })
                else:
                    self._send(200, {"predictions": logits.tolist()})
            except Exception as e:  # noqa: BLE001 - predict-path/runtime
                # failure: a 5xx so clients retry and monitoring sees it
                self._send(500, {"error": f"{type(e).__name__}: {e}"})

        def log_message(self, *a):  # quiet by default
            pass

    return Handler


def make_server(predictor: Predictor, host: str = "127.0.0.1",
                port: int = 0, **batcher_kwargs):
    """Build (server, batcher); call ``server.serve_forever()`` to run.

    port=0 binds an ephemeral port (``server.server_address[1]``)."""
    from http.server import ThreadingHTTPServer

    batcher = DynamicBatcher(predictor, **batcher_kwargs)
    server = ThreadingHTTPServer(
        (host, port), _make_handler(batcher, predictor))
    return server, batcher


def main(argv=None):
    import argparse

    p = argparse.ArgumentParser(
        description="Serve an exported artifact over HTTP")
    p.add_argument("--artifact", required=True)
    p.add_argument("--host", default="127.0.0.1")
    p.add_argument("--port", type=int, default=8000)
    p.add_argument("--max-wait-ms", type=float, default=5.0)
    p.add_argument("--device", default="cuda", choices=["cuda", "cpu"])
    args = p.parse_args(argv)

    predictor = load_predictor(args.artifact, device=args.device)
    server, _ = make_server(predictor, args.host, args.port,
                            max_wait_ms=args.max_wait_ms)
    print(json.dumps({"serving": predictor.manifest.get("model_name"),
                      "port": server.server_address[1]}), flush=True)
    server.serve_forever()


if __name__ == "__main__":
    main()
