"""ATQ image-classification training CLI for the port (port of train.py).

    python -m atq_tpu_torch.train --use-rpb --distill --use-l1 --clip-grad
    ATQ_FUSED=1 python -m atq_tpu_torch.train --use-rpb ...   # fused kernels

The flags match train.py's one for one; ``--device`` (default ``cuda``) is
the port's own. Without a GPU the run raises unless ``--device cpu`` is
given. ``--grad-accum-steps N`` averages N microbatches' gradients into one
update; every ``--orbax-freq`` epochs the whole training state goes to
``--checkpoint-dir``/orbax_<dataset>/step_N, and ``--resume`` continues from
the newest one. ``--profile-dir D`` traces the run's first epoch into D
(``python -m atq_tpu_torch.utils.profile_step D`` summarizes it);
``--tensorboard-dir T`` writes the epoch scalars to T. Flags of features
not ported yet (``--dp``/``--tp``/``--fsdp``) raise
``NotImplementedError``. Plots are written when matplotlib is installed and
skipped otherwise.
"""

from __future__ import annotations

import argparse
import os

from atq_tpu_torch.train.classifier import ClassifierConfig, train_classifier
from atq_tpu_torch.utils.platform import resolve_device


def build_parser() -> argparse.ArgumentParser:
    parser = argparse.ArgumentParser(description="ATQ Image Classification")
    parser.add_argument("--dataset", type=str, default="fashion_mnist",
                        choices=["mnist", "fashion_mnist"],
                        help="Dataset to use (default: fashion_mnist)")
    parser.add_argument("--batch-size", type=int, default=256,
                        help="Batch size (default: 256)")
    parser.add_argument("--learning-rate", type=float, default=0.001,
                        help="Learning rate (default: 0.001)")
    parser.add_argument("--epochs", type=int, default=20,
                        help="Number of epochs (default: 20)")
    parser.add_argument("--use-rpb", action="store_true",
                        help="Use Residual Precision Boosting")
    parser.add_argument("--distill", action="store_true",
                        help="Use knowledge distillation")
    parser.add_argument("--sparsity", type=float, default=0.3,
                        help="Target sparsity (0-1, default: 0.3)")
    parser.add_argument("--wider-layers", action="store_true",
                        help="Use wider layers for ATQ model")
    parser.add_argument("--use-cosine-lr", action="store_true",
                        help="Use cosine learning rate schedule")
    parser.add_argument("--l1-factor", type=float, default=1e-5,
                        help="L1 regularization factor")
    parser.add_argument("--use-l1", action="store_true",
                        help="Use L1 regularization for sparsity")
    parser.add_argument("--clip-grad", action="store_true",
                        help="Apply gradient clipping")
    parser.add_argument("--bit-packing", action="store_true",
                        help="Analyze bit-packing compression")
    parser.add_argument("--grad-mode", type=str, default="parity",
                        choices=["parity", "ste", "ttq"],
                        help="Quantizer gradient mode (parity = reference "
                             "semantics, ste = straight-through estimator)")
    parser.add_argument("--data-dir", type=str, default="./data")
    parser.add_argument("--dp", type=int, default=None,
                        help="Data-parallel device count (not ported yet)")
    parser.add_argument("--tp", type=int, default=1,
                        help="Tensor-parallel size (not ported yet)")
    parser.add_argument("--fsdp", action="store_true",
                        help="Fully-sharded data parallelism (not ported "
                             "yet)")
    parser.add_argument("--seed", type=int, default=0)
    parser.add_argument("--subset-fraction", type=float, default=1.0,
                        help="Fraction of the dataset to use (quick runs)")
    parser.add_argument("--resume", action="store_true",
                        help="Resume from the newest full training state")
    parser.add_argument("--profile-dir", type=str, default=None,
                        help="Trace the run's first epoch here "
                             "(torch.profiler, Chrome trace)")
    parser.add_argument("--checkpoint-dir", type=str, default="checkpoints",
                        help="Directory for model checkpoints")
    parser.add_argument("--plots-dir", type=str, default="plots",
                        help="Directory for the training plots")
    parser.add_argument("--orbax-freq", type=int, default=5,
                        help="Epochs between full training-state saves")
    parser.add_argument("--tensorboard-dir", type=str, default=None,
                        help="Write TensorBoard scalars here")
    parser.add_argument("--grad-accum-steps", type=int, default=1,
                        help="Microbatches per update (gradients averaged)")
    parser.add_argument("--device", type=str, default="cuda",
                        help="Device to train on (default: cuda)")
    return parser


def config_from_args(args) -> ClassifierConfig:
    return ClassifierConfig(
        dataset=args.dataset, batch_size=args.batch_size,
        learning_rate=args.learning_rate, epochs=args.epochs,
        use_rpb=args.use_rpb, distill=args.distill, sparsity=args.sparsity,
        wider_layers=args.wider_layers, use_cosine_lr=args.use_cosine_lr,
        l1_factor=args.l1_factor, use_l1=args.use_l1,
        clip_grad=args.clip_grad, bit_packing=args.bit_packing,
        grad_mode=args.grad_mode, data_dir=args.data_dir, dp=args.dp,
        tp=args.tp, fsdp=args.fsdp, seed=args.seed, resume=args.resume,
        profile_dir=args.profile_dir,
        tensorboard_dir=args.tensorboard_dir,
        checkpoint_dir=args.checkpoint_dir, plots_dir=args.plots_dir,
        orbax_freq=args.orbax_freq, grad_accum_steps=args.grad_accum_steps,
        device=args.device,
    )


def main(argv=None):
    """Parse ``argv``, train, report; returns ``(state, results)``."""
    args = build_parser().parse_args(argv)
    cfg = config_from_args(args)
    resolve_device(cfg.device)  # no GPU: raise before loading any data
    loaders = None
    if args.subset_fraction < 1.0:
        from atq_tpu_torch.data.mnist import (
            get_fashion_mnist_data,
            get_mnist_data,
        )

        get_data = (get_mnist_data if cfg.dataset == "mnist"
                    else get_fashion_mnist_data)
        loaders = get_data(cfg.batch_size, cfg.data_dir,
                           subset_fraction=args.subset_fraction)
    state, results = train_classifier(cfg, loaders=loaders)

    if cfg.bit_packing and cfg.use_rpb:
        from atq_tpu_torch.core.packing import TernaryBitPacking
        from atq_tpu_torch.core.quantize import adaptive_ternary_quantization

        print("\nBit-packing analysis:")
        layer = state["atq_model"].classifier_0
        w_t, _ = adaptive_ternary_quantization(
            layer.weight.detach(), alpha=layer.alpha,
            sparsity_target=layer.sparsity_target)
        savings = TernaryBitPacking.compute_memory_savings(w_t)
        print(f"Original FP32 size: {savings['original_bytes'] / 1024:.2f} KB")
        print(f"Bit-packed size: {savings['packed_bytes'] / 1024:.2f} KB")
        print("Theoretical compression ratio: "
              f"{savings['compression_ratio']:.1f}x")

    _save_plots(results, cfg)
    return state, results


def _save_plots(results, cfg):
    try:
        import matplotlib
    except ImportError:
        print("matplotlib is not installed: plots skipped")
        return
    matplotlib.use("Agg")
    import matplotlib.pyplot as plt

    os.makedirs(cfg.plots_dir, exist_ok=True)
    epochs = range(1, len(results["train_accuracies"]) + 1)

    plt.figure(figsize=(10, 5))
    plt.plot(epochs, results["train_accuracies"], label="Train")
    plt.plot(epochs, results["val_accuracies"], label="Validation")
    plt.grid(True)
    plt.xlabel("Epoch")
    plt.ylabel("Accuracy (%)")
    plt.title("Training Progress")
    plt.legend()
    plt.savefig(os.path.join(cfg.plots_dir, "training_curve.png"))
    plt.close()

    plt.figure(figsize=(10, 5))
    plt.plot(epochs, results["sparsity_schedule"])
    plt.grid(True)
    plt.xlabel("Epoch")
    plt.ylabel("Target Sparsity")
    plt.title("Progressive Sparsity Schedule")
    plt.savefig(os.path.join(cfg.plots_dir, "sparsity_schedule.png"))
    plt.close()


if __name__ == "__main__":
    main()
