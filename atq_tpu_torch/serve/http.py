"""Stdlib HTTP front for the micro-batching serving engine.

Port of the classification half of atq_tpu/serve/http.py: a threaded HTTP
server whose handlers submit into :class:`~atq_tpu_torch.serve.engine.
BatchServer` futures, so concurrent requests batch onto the GPU. Routes are
plain callables ``payload_dict -> result_dict`` (raise ``ValueError`` for a
400). The retrieval and search routes come with the retrieval slice.
"""

from __future__ import annotations

import json
import threading
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from typing import Callable, Dict, Optional

import numpy as np

from atq_tpu_torch.data.mnist import FASHION_STATS, MNIST_STATS


class _Handler(BaseHTTPRequestHandler):
    routes: Dict[str, Callable] = {}
    stats_fn: Optional[Callable] = None

    def log_message(self, fmt, *args):  # quiet by default
        pass

    def _send(self, code: int, obj) -> None:
        body = json.dumps(obj).encode()
        self.send_response(code)
        self.send_header("Content-Type", "application/json")
        self.send_header("Content-Length", str(len(body)))
        self.end_headers()
        self.wfile.write(body)

    def do_GET(self):  # noqa: N802 (http.server API)
        if self.path == "/healthz":
            out = {"ok": True}
            if self.stats_fn is not None:
                out["stats"] = self.stats_fn()
            self._send(200, out)
        else:
            self._send(404, {"error": f"no route {self.path}"})

    def do_POST(self):  # noqa: N802
        fn = self.routes.get(self.path)
        if fn is None:
            self._send(404, {"error": f"no route {self.path}"})
            return
        try:
            length = int(self.headers.get("Content-Length", 0))
            payload = json.loads(self.rfile.read(length) or b"{}")
            self._send(200, fn(payload))
        except (ValueError, KeyError) as e:
            self._send(400, {"error": str(e)})
        except Exception as e:  # engine/backend failure: a 500, not a crash
            self._send(500, {"error": f"{type(e).__name__}: {e}"})


class _Server(ThreadingHTTPServer):
    # socketserver listens with a backlog of 5: a burst of more concurrent
    # clients than that loses connection attempts, which the clients' TCP
    # retries about a second later (a 1 s tail on every burst).
    request_queue_size = 128


def make_http_server(routes: Dict[str, Callable],
                     host: str = "127.0.0.1", port: int = 8712,
                     stats_fn: Optional[Callable] = None
                     ) -> ThreadingHTTPServer:
    """Build (but don't start) the threaded server. ``port=0`` picks a
    free port (``server.server_address[1]``)."""
    # staticmethod: a bare function in a class dict would bind as a
    # method and receive the handler as an unwanted first argument.
    handler = type("Handler", (_Handler,),
                   {"routes": dict(routes),
                    "stats_fn": (staticmethod(stats_fn)
                                 if stats_fn is not None else None)})
    return _Server((host, port), handler)


def start_in_thread(server: ThreadingHTTPServer) -> threading.Thread:
    t = threading.Thread(target=server.serve_forever, daemon=True)
    t.start()
    return t


# Per-dataset normalization stats (mean, std) of the training loaders.
DATASET_STATS = {"mnist": MNIST_STATS, "fashion_mnist": FASHION_STATS}


def make_classifier_routes(server, dataset: str = "fashion_mnist",
                           timeout: float = 60.0) -> Dict[str, Callable]:
    """``POST /predict {"image": [[...]] (28x28 or 28x28x1),
    "normalize": bool}`` -> logits + argmax class.

    ``server`` is a BatchServer over a ``(B, 28, 28, 1) -> (B, 10)``
    forward; with ``normalize`` the dataset's train-time mean/std are
    applied (send pixel values in [0, 1])."""
    mean, std = DATASET_STATS[dataset]

    def predict(payload):
        img = np.asarray(payload["image"], np.float32)
        if img.ndim == 2:
            img = img[..., None]
        if img.ndim != 3:
            raise ValueError(f"image must be HxW or HxWxC, got shape "
                             f"{img.shape}")
        if payload.get("normalize"):
            img = (img - mean) / std
        logits = np.asarray(server.submit(img).result(timeout=timeout))
        e = np.exp(logits - logits.max())
        return {"logits": logits.tolist(),
                "probs": (e / e.sum()).tolist(),
                "class": int(np.argmax(logits))}

    return {"/predict": predict}
