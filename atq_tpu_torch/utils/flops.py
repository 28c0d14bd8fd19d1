"""MFU (model FLOPs utilization) against the card's published peak (port of
the parts of atq_tpu/utils/flops.py that the production-shape step uses).

MFU = the model's required FLOPs per step / seconds per step / the card's
dense bf16 tensor-core peak. The peak is NVIDIA's H100 SXM data sheet
figure, 989 TFLOP/s dense BF16 (without sparsity), at the 700 W power
limit; a card run below that limit reaches less. The JAX package's TPU
table has no counterpart here: :func:`peak_flops_per_chip` reads the
card's name where JAX reads the device kind.

:func:`counted_flops` takes the place of XLA's cost analysis
(``compiled_flops``): it counts one call with
``torch.utils.flop_counter.FlopCounterMode``, which counts the matrix
products and convolutions that dispatch through PyTorch (not elementwise
work), plus what the hand-written kernels did. Those are launched through
``ctypes`` (ops/_build.py), out of the counter's sight. A kernel behind a
registered op (ops/__init__.py) is counted by the op's FLOP formula, on
the card and on the CPU alike; every other kernel wrapper adds its own
work from its shapes to its ``flops`` count where it launches (ops
``kernel_flops``). Either way the count is what ``FlopCounterMode`` gives
the kernel's plain version at the same shapes, so a step counts the same
on the card as on the CPU, where the wrappers run their plain versions.
"""

from __future__ import annotations

from typing import Callable, Dict, Optional, Tuple

# device-name substring -> dense bf16 tensor-core FLOP/s (data sheets).
_PEAK_BF16 = {"H100": 989e12, "H200": 989e12}


def peak_flops_per_device(device_name: str) -> Optional[float]:
    """Peak dense bf16 FLOP/s of a card by its name, or None."""
    for key, peak in _PEAK_BF16.items():
        if key in device_name:
            return peak
    return None


def peak_flops_per_chip(device=None) -> Optional[float]:
    """Peak dense bf16 FLOP/s of ``device`` (default: the current CUDA
    device), by its name; None on the CPU, on a host without a GPU, or for
    a card not in the table."""
    import torch

    dev = torch.device("cuda" if device is None else device)
    if dev.type != "cuda" or not torch.cuda.is_available():
        return None
    return peak_flops_per_device(torch.cuda.get_device_name(dev))


def mfu(flops_per_step: Optional[float], seconds_per_step: float,
        device_name: str) -> Optional[float]:
    """Model FLOPs utilization in [0, 1]; None for a device without a
    known peak (the CPU among them)."""
    peak = peak_flops_per_device(device_name)
    if peak is None or flops_per_step is None or seconds_per_step <= 0:
        return None
    return flops_per_step / seconds_per_step / peak


def counted_flops(fn: Callable[[], object]) -> Tuple[Dict, object]:
    """``({"total", "traced", "kernels"}, fn())``: the FLOPs of one call of
    ``fn``, as ``FlopCounterMode`` counts what dispatches through PyTorch
    (``traced``) plus each kernel wrapper's own count over the call
    (``kernels``, by kernel)."""
    from torch.utils.flop_counter import FlopCounterMode

    from atq_tpu_torch.ops import kernel_flops

    before = kernel_flops()
    with FlopCounterMode(display=False) as counter:
        out = fn()
    kernels = {k: v - before[k] for k, v in kernel_flops().items()}
    traced = counter.get_total_flops()
    return {"total": traced + sum(kernels.values()), "traced": traced,
            "kernels": kernels}, out
