"""Stdlib HTTP front for the micro-batching serving engine.

Port of atq_tpu/serve/http.py: a threaded HTTP server whose handlers
submit into :class:`~atq_tpu_torch.serve.engine.BatchServer` futures, so
concurrent requests batch onto the GPU. Routes are plain callables
``payload_dict -> result_dict`` (raise ``ValueError`` for a 400): the
classifier's ``/predict``, the retrieval model's ``/embed_image`` and
``/embed_text``, and ``/index/add`` and ``/search`` over an
:class:`~atq_tpu_torch.serve.index.EmbeddingIndex`.
"""

from __future__ import annotations

import json
import threading
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from typing import Callable, Dict, Optional

import numpy as np

from atq_tpu_torch.data.flickr8k import (
    END,
    IMAGENET_MEAN,
    IMAGENET_STD,
    PAD,
    START,
    UNK,
    clean_caption,
    tokenize,
)
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


def make_retrieval_routes(image_server, text_server,
                          word_to_idx: Optional[Dict[str, int]] = None,
                          max_length: int = 50,
                          timeout: float = 60.0) -> Dict[str, Callable]:
    """Routes for the retrieval model's two encoders.

    - ``POST /embed_image {"image": HxWx3, "normalize": bool}`` (with
      ``normalize`` the ImageNet mean/std are applied);
    - ``POST /embed_text {"tokens": [...]}`` or, with a vocabulary,
      ``{"text": "a dog runs"}``, tokenized as in training (clean,
      tokenize, START/END, PAD to ``max_length``).

    Both return L2-normalized embeddings; their dot product is the
    retrieval score.
    """

    def embed_image(payload):
        img = np.asarray(payload["image"], np.float32)
        if img.ndim != 3 or img.shape[-1] != 3:
            raise ValueError(f"image must be HxWx3, got {img.shape}")
        if payload.get("normalize"):
            img = (img - IMAGENET_MEAN) / IMAGENET_STD
        emb = np.asarray(image_server.submit(img).result(timeout=timeout))
        return {"embedding": emb.tolist()}

    def embed_text(payload):
        if "tokens" in payload:
            ids = [int(t) for t in payload["tokens"]]
        elif "text" in payload:
            if word_to_idx is None:
                raise ValueError("server has no vocabulary; send "
                                 "'tokens' instead of 'text'")
            toks = tokenize(clean_caption(payload["text"]))
            ids = [START] + [word_to_idx.get(t, UNK) for t in toks] + [END]
        else:
            raise ValueError("payload needs 'tokens' or 'text'")
        ids = ids[:max_length]
        length = len(ids)
        ids = ids + [PAD] * (max_length - len(ids))
        tokens = np.asarray(ids, np.int32)
        emb = np.asarray(text_server.submit(
            tokens, np.asarray(length, np.int32)).result(timeout=timeout))
        return {"embedding": emb.tolist(), "length": length}

    return {"/embed_image": embed_image, "/embed_text": embed_text}


def make_search_routes(index, embed_routes: Dict[str, Callable]
                       ) -> Dict[str, Callable]:
    """Corpus-side retrieval on top of the embed routes (whose servers
    batch the embeds like any other request).

    - ``POST /index/add {"id": "...", "image"|"text"|"tokens": ...}``:
      embed and add to the corpus;
    - ``POST /search {"image"|"text"|"tokens": ..., "k": 5}``: the top-k
      corpus ids by cosine score.
    """

    def _embed(payload) -> np.ndarray:
        if "image" in payload:
            out = embed_routes["/embed_image"](payload)
        elif "text" in payload or "tokens" in payload:
            out = embed_routes["/embed_text"](payload)
        else:
            raise ValueError("payload needs 'image', 'text' or 'tokens'")
        return np.asarray(out["embedding"], np.float32)

    def index_add(payload):
        if "id" not in payload:
            raise ValueError("payload needs 'id'")
        count = index.add([str(payload["id"])], _embed(payload)[None, :])
        return {"count": count}

    def search(payload):
        emb = _embed(payload)
        ids, scores = index.search(emb, k=int(payload.get("k", 5)))
        return {"results": [{"id": i, "score": float(s)}
                            for i, s in zip(ids, scores)],
                "count": len(index)}

    return {"/index/add": index_add, "/search": search}
