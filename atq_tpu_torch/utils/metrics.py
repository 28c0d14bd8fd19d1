"""Model metrics (port of atq_tpu/utils/metrics.py): parameter count,
memory, inference time, a FLOP estimate from parameter shapes, top-k
accuracy and the confusion matrix."""

from __future__ import annotations

import time
from typing import Callable, Sequence

import numpy as np
import torch


def count_parameters(module: torch.nn.Module) -> int:
    """Total parameter count."""
    return sum(p.numel() for p in module.parameters())


def measure_model_memory(module: torch.nn.Module) -> float:
    """Parameter memory in MB."""
    total = sum(p.numel() * p.element_size() for p in module.parameters())
    return total / (1024 * 1024)


def _sync(device) -> None:
    if torch.device(device).type == "cuda":
        torch.cuda.synchronize(device)


@torch.inference_mode()
def measure_inference_time(fn: Callable, inputs, num_runs: int = 50,
                           warmup: int = 5) -> float:
    """Mean wall time per call of ``fn(inputs)`` in ms, after ``warmup``
    calls; on CUDA the window starts and ends with a device synchronize, so
    it covers the device work and not just its enqueue."""
    for _ in range(warmup):
        fn(inputs)
    _sync(inputs.device)
    t0 = time.perf_counter()
    for _ in range(num_runs):
        fn(inputs)
    _sync(inputs.device)
    return (time.perf_counter() - t0) / num_runs * 1000.0


def estimate_flops(model: torch.nn.Module, input_size) -> int:
    """The JAX package's rough forward-FLOP estimate from parameter shapes,
    read from the model's JAX layout (utils/jax_interop.py): each 2-D
    ``weight`` or ``kernel`` costs out·in, each conv kernel
    H·W·kh·kw·cin·cout with the output's spatial size taken as the
    input's ``(C, H, W)``; anything else (an embedding, a norm, an MoE
    expert stack) costs nothing."""
    from atq_tpu_torch.utils.jax_interop import to_jax_variables

    h, w = (input_size[1], input_size[2]) if len(input_size) == 3 else (1, 1)
    total = 0

    def walk(node, name):
        nonlocal total
        if isinstance(node, dict):
            for k, v in node.items():
                walk(v, k)
            return
        shape = np.shape(node)
        if name in ("weight", "kernel") and len(shape) == 2:
            total += int(shape[0] * shape[1])
        elif name == "kernel" and len(shape) == 4:
            total += int(h * w * np.prod(shape))

    walk(to_jax_variables(model.state_dict()).get("params", {}), "")
    return total


def accuracy(output, target, topk: Sequence[int] = (1,)):
    """Top-k accuracies in percent, one float per k."""
    output, target = torch.as_tensor(output), torch.as_tensor(target)
    pred = torch.topk(output, max(topk), dim=1).indices
    correct = pred == target[:, None]
    return [float(correct[:, :k].sum() * 100.0 / target.shape[0])
            for k in topk]


def confusion_matrix(preds, labels, num_classes: int | None = None
                     ) -> np.ndarray:
    """Confusion matrix ``[true, pred]`` as int64 numpy."""
    preds, labels = np.asarray(preds), np.asarray(labels)
    if num_classes is None:
        num_classes = int(max(preds.max(), labels.max())) + 1
    conf = np.zeros((num_classes, num_classes), dtype=np.int64)
    np.add.at(conf, (labels, preds), 1)
    return conf
