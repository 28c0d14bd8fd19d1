"""Model metrics for the end-of-run efficiency report (port of
atq_tpu/utils/metrics.py: parameter count, memory, inference time)."""

from __future__ import annotations

import time
from typing import Callable

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
