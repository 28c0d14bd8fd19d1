"""Evaluation CLI of the port: a checkpoint's accuracy or Recall@K.

    python -m atq_tpu_torch.evaluate --task classification \\
        --checkpoint checkpoints/atq_model_fashion_mnist.npz --use-rpb \\
        [--packed] [--output metrics.json]
    python -m atq_tpu_torch.evaluate --task retrieval \\
        --checkpoint outputs/run/best_model.npz --use_residual --packed \\
        --int8_trunk --save_index index.npz

The port of the JAX package's ``evaluate.py``, flag for flag, plus
``--device`` (default ``cuda``). It loads a JAX-layout ``.npz`` checkpoint
(utils/jax_interop.py; a scanned text stack is unrolled first, and a
checkpoint without ``constants`` gets its positional table), builds the
model as the serving CLI does (serve/__main__.py ``build_classifier``,
``build_retrieval``: ``--packed`` serves every quantized layer from 2-bit
planes, ``--int8_trunk`` the ResNet trunk from int8) and evaluates it with
the trainers' own loops (train/classifier.py ``_run_eval``,
train/retrieval.py ``evaluate_model``). ``--save_index`` embeds the
split's unique images into an ``EmbeddingIndex`` ``.npz`` that
``python -m atq_tpu_torch.serve --index_file`` preloads. A TTQ checkpoint
evaluated without ``--grad-mode ttq`` (or auto) exits, as does a
``vocab.json`` stamped by another tokenizer than the active one.
``--moe_experts N`` builds the text tower with the ternary-expert MoE FFN
(its expert planes stay dense under ``--packed``, as in JAX).
"""

from __future__ import annotations

import argparse
import json
import os
import warnings

from atq_tpu_torch.serve.__main__ import (
    build_classifier,
    build_retrieval,
    resolve_grad_mode,
)
from atq_tpu_torch.utils.platform import resolve_device


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(description="Evaluate an ATQ checkpoint "
                                            "(PyTorch/CUDA port)")
    p.add_argument("--task", type=str, required=True,
                   choices=["classification", "retrieval"])
    p.add_argument("--checkpoint", type=str, required=True,
                   help="Path to a .npz checkpoint")
    p.add_argument("--dataset", type=str, default="fashion_mnist",
                   choices=["mnist", "fashion_mnist"])
    p.add_argument("--split", type=str, default="test",
                   choices=["val", "test"])
    p.add_argument("--batch_size", type=int, default=256)
    p.add_argument("--image_size", type=int, default=160)
    p.add_argument("--max_seq_length", type=int, default=50)
    p.add_argument("--embed_dim", type=int, default=192)
    p.add_argument("--hidden_dim", type=int, default=384)
    p.add_argument("--use_residual", action="store_true")
    p.add_argument("--use-rpb", dest="use_rpb", action="store_true")
    p.add_argument("--wider-layers", dest="wider_layers",
                   action="store_true")
    p.add_argument("--data_dir", type=str, default=None)
    p.add_argument("--vocab_file", type=str, default=None,
                   help="vocab.json forcing identical token ids "
                        "(retrieval); defaults to the vocab.json next to "
                        "the checkpoint when present")
    p.add_argument("--moe_experts", type=int, default=0,
                   help="(retrieval) the checkpoint's ternary-expert MoE "
                        "FFN: experts per text layer (0: dense FFN)")
    p.add_argument("--grad-mode", "--grad_mode", dest="grad_mode",
                   type=str, default="auto",
                   choices=["auto", "parity", "ste", "ttq"],
                   help="gradient mode the checkpoint was trained with; "
                        "'auto' detects TTQ checkpoints by their wp/wn "
                        "scales")
    p.add_argument("--packed", action="store_true",
                   help="evaluate every quantized layer from exported "
                        "2-bit planes + sparse correction")
    p.add_argument("--int8_trunk", action="store_true",
                   help="(retrieval) the ResNet trunk from per-channel "
                        "int8 weights with BatchNorm folded")
    p.add_argument("--output", type=str, default=None,
                   help="Optional JSON file for the metrics")
    p.add_argument("--save_index", type=str, default=None,
                   help="(retrieval) also embed the split's unique images "
                        "and save them as an EmbeddingIndex .npz, "
                        "servable via `python -m atq_tpu_torch.serve "
                        "--index_file`")
    p.add_argument("--device", type=str, default="cuda",
                   help="'cuda' (default) or 'cpu' (plain PyTorch path)")
    return p


def _evaluate_classifier(args, ckpt, grad_mode, device):
    from atq_tpu_torch.data.mnist import (
        get_fashion_mnist_data,
        get_mnist_data,
    )
    from atq_tpu_torch.train.classifier import _run_eval

    get_data = (get_mnist_data if args.dataset == "mnist"
                else get_fashion_mnist_data)
    _, val_loader, test_loader = get_data(
        args.batch_size, args.data_dir or "./data", subset_fraction=1.0)
    loader = val_loader if args.split == "val" else test_loader
    model = build_classifier(args, ckpt, grad_mode, device)
    acc, loss = _run_eval(model, loader, device)
    print(f"{args.dataset} {args.split} accuracy: {acc:.2f}%")
    return {"accuracy": acc, "loss": loss}


def _vocab_file(args):
    """The vocabulary to force, after the tokenizer-stamp guard: a vocab
    stamped by another tokenizer than the active one exits; a missing or
    unstamped one warns."""
    from atq_tpu_torch.data.flickr8k import (
        active_tokenizer_variant,
        read_vocab_tokenizer,
        tokenizer_variants_compatible,
    )

    vocab_file = args.vocab_file
    if vocab_file is None:
        candidate = os.path.join(os.path.dirname(args.checkpoint),
                                 "vocab.json")
        vocab_file = candidate if os.path.exists(candidate) else None
    active = active_tokenizer_variant()
    if vocab_file is None:
        warnings.warn(
            "no vocab.json found next to the checkpoint and no "
            "--vocab_file given: rebuilding the vocabulary from the train "
            f"captions under tokenizer '{active}'. If the checkpoint was "
            "trained under a different tokenizer, token ids will NOT match "
            "and the metrics below are meaningless; pass the training "
            "run's vocab.json.")
        return None
    saved = read_vocab_tokenizer(vocab_file)
    if saved is None:
        warnings.warn(
            f"{vocab_file} carries no tokenizer stamp. Forcing its exact "
            "token ids is still correct; just ensure the checkpoint really "
            "was trained with this vocabulary.")
    elif not tokenizer_variants_compatible(saved, active):
        raise SystemExit(
            f"vocab {vocab_file} was built with tokenizer '{saved}' but the "
            f"active tokenizer is '{active}' (ATQ_SPLIT_TOKENIZER="
            f"{os.environ.get('ATQ_SPLIT_TOKENIZER', '0')}). Evaluating "
            "with mismatched tokenization produces silently wrong "
            "metrics; align the environment before re-running.")
    return vocab_file


def _save_index(args, loader, embed_fn, device) -> None:
    """Embed each unique image of the split (five caption rows share one
    image; the eval loader is unshuffled, so row order follows
    ``dataset.items``) into an ``EmbeddingIndex`` file."""
    from atq_tpu_torch.serve.index import EmbeddingIndex
    from atq_tpu_torch.train.retrieval import _batch_to

    names = [n for n, _ in loader.dataset.items]
    index = EmbeddingIndex(dim=args.embed_dim, device=device)
    seen, row = set(), 0
    for batch in loader:
        img_emb, _ = embed_fn(_batch_to(batch, device))
        for emb in img_emb.cpu().numpy():
            name = names[row]
            row += 1
            if name not in seen:
                seen.add(name)
                index.add([name], emb[None, :])
    index.save(args.save_index)
    print(f"saved image index: {len(index)} unique images -> "
          f"{args.save_index}")


def _evaluate_retrieval(args, ckpt, grad_mode, device):
    from atq_tpu_torch.data.flickr8k import prepare_flickr8k_dataloaders
    from atq_tpu_torch.train.retrieval import build_embed_fn, evaluate_model

    vocab_file = _vocab_file(args)
    _, val_loader, test_loader, vocab_size, _ = prepare_flickr8k_dataloaders(
        batch_size=args.batch_size, image_size=args.image_size,
        max_length=args.max_seq_length,
        root_dir=args.data_dir or "./data/flickr8k", vocab_file=vocab_file)
    loader = val_loader if args.split == "val" else test_loader
    model = build_retrieval(args, ckpt, grad_mode, device, vocab_size)
    embed_fn = build_embed_fn(model)
    metrics = evaluate_model(embed_fn, loader, device)
    for k, v in metrics.items():
        print(f"{k}: {v:.2f}")
    if args.save_index:
        _save_index(args, loader, embed_fn, device)
    return metrics


def main(argv=None):
    from atq_tpu_torch.nn.transformer import normalize_checkpoint
    from atq_tpu_torch.utils.jax_interop import load_checkpoint

    args = build_parser().parse_args(argv)
    device = resolve_device(args.device)
    ckpt = load_checkpoint(args.checkpoint)
    grad_mode = resolve_grad_mode(args.grad_mode, ckpt.get("params", {}))
    ckpt, _ = normalize_checkpoint(ckpt)
    evaluate = (_evaluate_classifier if args.task == "classification"
                else _evaluate_retrieval)
    metrics = evaluate(args, ckpt, grad_mode, device)
    if args.output:
        with open(args.output, "w") as f:
            json.dump({k: float(v) for k, v in metrics.items()}, f,
                      indent=4)
    return metrics


if __name__ == "__main__":
    main()
