"""Serving CLI of the port: checkpoint -> micro-batched HTTP endpoint.

    python -m atq_tpu_torch.serve --task classification \\
        --checkpoint checkpoints/atq_model_fashion_mnist.npz --use-rpb \\
        --packed --port 8712
    python -m atq_tpu_torch.serve --task retrieval \\
        --checkpoint outputs/run/best_model.npz --use_residual --packed

The port of the JAX package's ``serve.py``, flag for flag: loads a JAX-
layout ``.npz`` checkpoint (utils/jax_interop.py; a scanned text stack is
unrolled first), builds the model on ``--device`` (default ``cuda``), and
fronts it with micro-batching ``BatchServer``s.

- ``--task classification``: ``POST /predict``; ``--packed`` serves the
  quantized head from 2-bit planes.
- ``--task retrieval``: ``POST /embed_image``, ``/embed_text``,
  ``/index/add`` and ``/search`` (one server for images, one for
  (tokens, length)); ``--packed`` serves every ternary projection from
  2-bit planes (``ATQ_PACK32=1`` at start-up: int32 planar32 words), and
  ``--int8_trunk`` (the default) the ResNet trunk from int8. The vocabulary
  comes from ``--vocab_file`` or the ``vocab.json`` beside the checkpoint.
  ``--moe_experts N`` builds the text tower with the ternary-expert MoE
  FFN; as in JAX, ``--packed`` packs only the 2-D quantized layers, so the
  expert planes stay dense and the batched order statistic ternarizes
  them on every text batch.
- both: ``GET /healthz``.

``--aot DIR`` serves each program (``predict``; ``embed_image`` and
``embed_text``) from ``DIR/<name>``, an artifact of serve/aot.py
(``torch.export``'s ``.pt2``, the kernels as registered ops): loaded when
it is there, in which case the model is not built, and otherwise exported
there from the live model first (example batch 2, as in ``serve.py``).
Each prints ``{"aot": "exported"|"loaded", "path", "batch_polymorphic"}``.
An artifact that fails to load raises; nothing is exported again behind
it.

Unlike ``serve.py``, no route installs a dense ``fallback_fn``: a kernel
failure fails its requests instead of being re-served dense.
"""

from __future__ import annotations

import argparse
import json
import os

import numpy as np
import torch

from atq_tpu_torch.utils.platform import resolve_device


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(description="Serve an ATQ checkpoint "
                                            "(PyTorch/CUDA port)")
    p.add_argument("--task", type=str, required=True,
                   choices=["classification", "retrieval"])
    p.add_argument("--checkpoint", type=str, required=True)
    p.add_argument("--dataset", type=str, default="fashion_mnist",
                   choices=["mnist", "fashion_mnist"],
                   help="normalization stats for /predict")
    p.add_argument("--image_size", type=int, default=160,
                   help="(retrieval) the image side of the --aot example "
                        "batch")
    p.add_argument("--max_seq_length", type=int, default=50)
    p.add_argument("--embed_dim", type=int, default=192)
    p.add_argument("--hidden_dim", type=int, default=384)
    p.add_argument("--use_residual", action="store_true")
    p.add_argument("--use-rpb", dest="use_rpb", action="store_true")
    p.add_argument("--wider-layers", dest="wider_layers",
                   action="store_true")
    p.add_argument("--moe_experts", type=int, default=0,
                   help="(retrieval) the checkpoint's ternary-expert MoE "
                        "FFN: experts per text layer (0: dense FFN); the "
                        "expert planes stay dense under --packed and are "
                        "ternarized on every text batch")
    p.add_argument("--grad-mode", "--grad_mode", dest="grad_mode",
                   type=str, default="auto",
                   choices=["auto", "parity", "ste", "ttq"])
    p.add_argument("--aot", type=str, default=None, metavar="DIR",
                   help="serve from ahead-of-time exported programs "
                        "(serve/aot.py): loaded from DIR when there (the "
                        "model is not built), otherwise exported there "
                        "first, then served")
    p.add_argument("--packed", action="store_true",
                   help="serve the quantized layers from exported 2-bit "
                        "planes (no dense fallback)")
    p.add_argument("--int8_trunk", action="store_true", default=True,
                   help="(retrieval) serve the ResNet trunk from "
                        "per-channel int8 weights with BatchNorm folded "
                        "(on by default)")
    p.add_argument("--no_int8_trunk", dest="int8_trunk",
                   action="store_false",
                   help="(retrieval) serve the ResNet trunk in float32")
    p.add_argument("--vocab_file", type=str, default=None,
                   help="vocab.json (retrieval); defaults to the one next "
                        "to the checkpoint")
    p.add_argument("--index_file", type=str, default=None,
                   help="embedding-index .npz to preload into the /search "
                        "corpus (retrieval)")
    p.add_argument("--index_int8", action="store_true",
                   help="hold the device search corpus as per-row int8")
    p.add_argument("--host", type=str, default="127.0.0.1")
    p.add_argument("--port", type=int, default=8712)
    p.add_argument("--max_batch", type=int, default=32)
    p.add_argument("--max_wait_ms", type=float, default=2.0)
    p.add_argument("--device", type=str, default="cuda",
                   help="'cuda' (default) or 'cpu' (plain PyTorch path)")
    return p


def _params_have_ttq_scales(params) -> bool:
    """True if any layer carries TTQ's asymmetric wp/wn scale params."""
    if isinstance(params, dict):
        if "wp" in params and "wn" in params:
            return True
        return any(_params_have_ttq_scales(v) for v in params.values())
    return False


def resolve_grad_mode(requested: str, params) -> str:
    """Resolve --grad-mode against what the checkpoint contains (a copy of
    evaluate.py:resolve_grad_mode). A TTQ checkpoint served without
    grad_mode='ttq' would silently use the untrained alpha, so a mismatch
    is fatal."""
    has_ttq = _params_have_ttq_scales(params)
    if requested == "auto":
        return "ttq" if has_ttq else "parity"
    if has_ttq and requested != "ttq":
        raise SystemExit(
            f"checkpoint contains TTQ wp/wn scales but --grad-mode="
            f"{requested} was requested; evaluating it without "
            f"grad_mode='ttq' would silently use the untrained alpha. "
            f"Pass --grad-mode ttq (or auto).")
    if not has_ttq and requested == "ttq":
        raise SystemExit(
            "--grad-mode ttq requested but the checkpoint has no wp/wn "
            "scales; it was not trained with TTQ.")
    return requested


def build_classifier(args, ckpt, grad_mode, device):
    """The eval classifier on ``device`` with the checkpoint's weights,
    serving its head from 2-bit planes when ``args.packed``."""
    from atq_tpu_torch.models.image_classifier import ATQImageClassifier
    from atq_tpu_torch.serve.packed_model import (
        attach_packed_collection,
        export_packed_collection,
    )
    from atq_tpu_torch.utils.jax_interop import from_jax_variables

    model = ATQImageClassifier(
        use_rpb=args.use_rpb,
        hidden_size=256 if args.wider_layers else 128,
        grad_mode=grad_mode, device=device)
    model.load_state_dict(from_jax_variables(ckpt))
    if args.packed:
        attach_packed_collection(model, export_packed_collection(
            ckpt["params"], ckpt.get("quant"), device=device))
    return model


def aot_program(args, name: str, build, example_args):
    """``--aot``: the program ``name`` from ``<args.aot>/<name>``, loaded
    when its manifest is there; otherwise ``build()`` (the live function)
    is exported there first. Returns the ``AOTServing``, which takes and
    gives numpy arrays as a ``BatchServer`` apply function."""
    from atq_tpu_torch.serve.aot import AOTServing, export_serving

    path = os.path.join(args.aot, name)
    if os.path.exists(os.path.join(path, "manifest.json")):
        aot, status = AOTServing.load(path), "loaded"
    else:
        aot, status = export_serving(build(), example_args), "exported"
        aot.save(path)
    print(json.dumps({"aot": status, "path": path,
                      "batch_polymorphic": aot.batch_polymorphic}),
          flush=True)
    return aot


def build_classifier_routes(args, ckpt, grad_mode, device):
    """``(routes, servers)`` for ``--task classification``."""
    from atq_tpu_torch.serve.engine import BatchServer
    from atq_tpu_torch.serve.http import make_classifier_routes

    if args.aot:
        forward = aot_program(
            args, "predict",
            lambda: build_classifier(args, ckpt, grad_mode, device),
            (torch.zeros((2, 28, 28, 1), device=device),))
    else:
        model = build_classifier(args, ckpt, grad_mode, device)

        @torch.inference_mode()
        def forward(x):
            x = torch.from_numpy(np.ascontiguousarray(x, np.float32))
            return model(x.to(device)).cpu().numpy()

    server = BatchServer(forward, max_batch=args.max_batch,
                         max_wait_ms=args.max_wait_ms).start()
    return make_classifier_routes(server, dataset=args.dataset), [server]


def build_retrieval(args, ckpt, grad_mode, device, vocab_size: int):
    """The retrieval model on ``device`` with the checkpoint's weights, its
    ternary layers served from 2-bit planes when ``args.packed`` and its
    trunk from int8 when ``args.int8_trunk``."""
    from atq_tpu_torch.models.retrieval import ATQMultimodalRetrieval
    from atq_tpu_torch.serve.int8_trunk import (
        attach_int8_collection,
        export_int8_collection,
    )
    from atq_tpu_torch.serve.packed_model import (
        attach_packed_collection,
        export_packed_collection,
    )

    model = ATQMultimodalRetrieval(
        vocab_size=vocab_size, embed_dim=args.embed_dim,
        hidden_dim=args.hidden_dim, use_residual=args.use_residual,
        max_seq_length=args.max_seq_length,
        text_moe_experts=args.moe_experts, grad_mode=grad_mode,
        device=device)
    model.load_jax_variables(ckpt)
    if args.packed:
        # Serving never runs the fusion, so its layers are not packed.
        params = {k: v for k, v in ckpt["params"].items() if k != "fusion"}
        attach_packed_collection(model, export_packed_collection(
            params, ckpt.get("quant"), device=device))
    if args.int8_trunk:
        attach_int8_collection(model, export_int8_collection(
            ckpt["params"], ckpt.get("batch_stats", {}), device=device))
    return model


def build_retrieval_routes(args, ckpt, grad_mode, device):
    """``(routes, servers)`` for ``--task retrieval``."""
    from atq_tpu_torch.data.flickr8k import load_vocab_file
    from atq_tpu_torch.serve.engine import BatchServer
    from atq_tpu_torch.serve.http import (
        make_retrieval_routes,
        make_search_routes,
    )
    from atq_tpu_torch.serve.index import EmbeddingIndex

    vocab_file = args.vocab_file
    if vocab_file is None:
        vocab_file = os.path.join(os.path.dirname(args.checkpoint),
                                  "vocab.json")
        if not os.path.exists(vocab_file):
            raise SystemExit("retrieval serving needs a vocab.json "
                             "(--vocab_file, or next to the checkpoint)")
    word_to_idx = load_vocab_file(vocab_file)
    built = []

    def model():  # built once, and not at all when --aot loads both
        if not built:
            built.append(build_retrieval(args, ckpt, grad_mode, device,
                                         len(word_to_idx)))
        return built[0]

    if args.aot:
        side, seq = args.image_size, args.max_seq_length
        embed_images = aot_program(
            args, "embed_image", lambda: model().encode_image,
            (torch.zeros((2, side, side, 3), device=device),))
        embed_texts = aot_program(
            args, "embed_text", lambda: model().encode_text,
            (torch.zeros((2, seq), dtype=torch.int64, device=device),
             torch.full((2,), 5, dtype=torch.int64, device=device)))
    else:
        live = model()

        @torch.inference_mode()
        def embed_images(images):
            x = torch.from_numpy(np.ascontiguousarray(images, np.float32))
            return live.encode_image(x.to(device)).cpu().numpy()

        @torch.inference_mode()
        def embed_texts(tokens, lengths):
            tok = torch.from_numpy(np.asarray(tokens, np.int64)).to(device)
            ln = torch.from_numpy(np.asarray(lengths, np.int64)).to(device)
            return live.encode_text(tok, ln).cpu().numpy()

    servers = [BatchServer(fn, max_batch=args.max_batch,
                           max_wait_ms=args.max_wait_ms).start()
               for fn in (embed_images, embed_texts)]
    routes = make_retrieval_routes(*servers, word_to_idx=word_to_idx,
                                   max_length=args.max_seq_length)
    quantize = "int8" if args.index_int8 else "none"
    if args.index_file:
        index = EmbeddingIndex.load(args.index_file, quantize=quantize,
                                    device=device)
        if index.dim != args.embed_dim:
            raise SystemExit(f"--index_file has dim {index.dim}, model "
                             f"has embed_dim {args.embed_dim}")
    else:
        index = EmbeddingIndex(dim=args.embed_dim, quantize=quantize,
                               device=device)
    return {**routes, **make_search_routes(index, routes)}, servers


def build_server(argv=None):
    """Parse ``argv`` and build (but do not start) the HTTP server:
    ``(httpd, servers, info)``."""
    from atq_tpu_torch.nn.transformer import normalize_checkpoint
    from atq_tpu_torch.serve.http import make_http_server
    from atq_tpu_torch.utils.jax_interop import load_checkpoint

    args = build_parser().parse_args(argv)
    device = resolve_device(args.device)
    ckpt = load_checkpoint(args.checkpoint)
    grad_mode = resolve_grad_mode(args.grad_mode, ckpt.get("params", {}))
    ckpt, _ = normalize_checkpoint(ckpt)
    build = (build_classifier_routes if args.task == "classification"
             else build_retrieval_routes)
    routes, servers = build(args, ckpt, grad_mode, device)

    def stats():
        return {f"server_{i}": s.stats for i, s in enumerate(servers)}

    httpd = make_http_server(routes, host=args.host, port=args.port,
                             stats_fn=stats)
    host, port = httpd.server_address[:2]
    info = {"serving": args.task, "host": host, "port": port,
            "routes": sorted(routes), "packed": args.packed,
            "grad_mode": grad_mode, "device": str(device)}
    return httpd, servers, info


def main(argv=None):
    httpd, servers, info = build_server(argv)
    print(json.dumps(info), flush=True)
    try:
        httpd.serve_forever()
    except KeyboardInterrupt:
        pass
    finally:
        httpd.shutdown()
        httpd.server_close()
        for s in servers:
            s.stop()


if __name__ == "__main__":
    main()
