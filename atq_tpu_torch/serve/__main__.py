"""Serving CLI of the port: checkpoint -> micro-batched HTTP endpoint.

    python -m atq_tpu_torch.serve --task classification \\
        --checkpoint checkpoints/atq_model_fashion_mnist.npz --use-rpb \\
        --packed --port 8712

The classification half of the JAX package's ``serve.py``: loads a JAX-
layout ``.npz`` checkpoint (utils/jax_interop.py), builds the classifier
on ``--device`` (default ``cuda``), optionally exports the quantized head to
2-bit planes (``--packed``), fronts the forward with the micro-batching
``BatchServer`` and serves ``POST /predict`` and ``GET /healthz``.

Unlike ``serve.py``, ``--packed`` installs no dense ``fallback_fn``: a
packed-kernel failure fails its requests instead of being re-served dense.
``--task retrieval`` and ``--aot`` are not ported yet and exit with a
message.
"""

from __future__ import annotations

import argparse
import json

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
    p.add_argument("--use-rpb", dest="use_rpb", action="store_true")
    p.add_argument("--wider-layers", dest="wider_layers",
                   action="store_true")
    p.add_argument("--grad-mode", "--grad_mode", dest="grad_mode",
                   type=str, default="auto",
                   choices=["auto", "parity", "ste", "ttq"])
    p.add_argument("--aot", type=str, default=None, metavar="DIR",
                   help="not ported yet")
    p.add_argument("--packed", action="store_true",
                   help="serve the quantized head from exported 2-bit "
                        "planes (no dense fallback)")
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


def build_classifier_routes(args, ckpt, grad_mode, device):
    """``(routes, servers)`` for ``--task classification``."""
    from atq_tpu_torch.serve.engine import BatchServer
    from atq_tpu_torch.serve.http import make_classifier_routes

    model = build_classifier(args, ckpt, grad_mode, device)

    @torch.inference_mode()
    def forward(x):
        x = torch.from_numpy(np.ascontiguousarray(x, np.float32))
        return model(x.to(device)).cpu().numpy()

    server = BatchServer(forward, max_batch=args.max_batch,
                         max_wait_ms=args.max_wait_ms).start()
    return make_classifier_routes(server, dataset=args.dataset), [server]


def build_server(argv=None):
    """Parse ``argv`` and build (but do not start) the HTTP server:
    ``(httpd, servers, info)``."""
    from atq_tpu_torch.serve.http import make_http_server
    from atq_tpu_torch.utils.jax_interop import load_checkpoint

    args = build_parser().parse_args(argv)
    if args.task != "classification":
        raise SystemExit("atq_tpu_torch.serve: --task retrieval is not "
                         "ported yet (ROADMAP.md); serve it with serve.py")
    if args.aot:
        raise SystemExit("atq_tpu_torch.serve: --aot is not ported yet "
                         "(ROADMAP.md)")
    device = resolve_device(args.device)
    ckpt = load_checkpoint(args.checkpoint)
    grad_mode = resolve_grad_mode(args.grad_mode, ckpt.get("params", {}))
    routes, servers = build_classifier_routes(args, ckpt, grad_mode, device)

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
