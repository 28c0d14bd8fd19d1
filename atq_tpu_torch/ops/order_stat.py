"""Exact order statistic of |w|, with its max and sum, in one call.

PyTorch counterpart of atq_tpu/ops/order_stat.py (the Pallas kernel
``_kernel`` behind ``order_statistic_reductions``). On a CUDA tensor the
wrapper launches the radix-select kernel in ``csrc/order_stat.cu``; on a
CPU tensor it takes the plain PyTorch version (sort, max, sum). There is
no other route: a CUDA tensor the kernel cannot take raises.

The JAX side's 12 MiB VMEM budget gate does not apply here: the CUDA
kernel takes any n below 2^31.
"""

from __future__ import annotations

import torch

from atq_tpu_torch.ops._build import check, load_library

_THREADS = 256
_MAX_GRID = 132 * 4  # four blocks on each of the H100's 132 SMs


def order_statistic_plain(abs_flat: torch.Tensor, rank: torch.Tensor):
    """Plain PyTorch version: ``(sort(abs_flat)[rank], max, sum)``."""
    stat = torch.sort(abs_flat).values.gather(
        0, rank.reshape(1).long()).reshape(())
    return stat, abs_flat.max(), abs_flat.sum()


def _check_inputs(abs_flat: torch.Tensor, rank: torch.Tensor) -> None:
    if abs_flat.dtype != torch.float32 or abs_flat.ndim != 1:
        raise ValueError(f"order_statistic_reductions takes a 1-D float32 "
                         f"tensor, got {abs_flat.dtype} "
                         f"{tuple(abs_flat.shape)}")
    if not abs_flat.is_contiguous():
        raise ValueError("order_statistic_reductions needs a contiguous "
                         "tensor")
    if not 0 < abs_flat.numel() < 2 ** 31:
        raise ValueError(f"n = {abs_flat.numel()} out of range [1, 2^31)")
    if rank.dtype != torch.int32 or rank.numel() != 1:
        raise ValueError(f"rank must be one int32 value, got {rank.dtype} "
                         f"{tuple(rank.shape)}")
    if rank.device != abs_flat.device:
        raise ValueError(f"rank on {rank.device}, values on "
                         f"{abs_flat.device}")


def order_statistic_reductions(abs_flat: torch.Tensor, rank: torch.Tensor):
    """``(sorted(abs_flat)[rank], max(abs_flat), sum(abs_flat))`` as three
    0-d float32 tensors. ``abs_flat`` is non-negative float32; ``rank`` is
    a one-element int32 tensor on the same device (clamped to [0, n-1]).
    The statistic is bit-identical to the sort; on CUDA the sum is reduced
    in a fixed order, so it is the same from run to run."""
    _check_inputs(abs_flat, rank)
    if abs_flat.device.type == "cpu":
        return order_statistic_plain(abs_flat, rank)
    if abs_flat.device.type != "cuda":
        raise ValueError(f"unsupported device {abs_flat.device}")
    lib = load_library()
    n = abs_flat.numel()
    grid = max(1, min(_MAX_GRID, -(-n // (_THREADS * 8))))
    device = abs_flat.device
    out = torch.empty(3, dtype=torch.float32, device=device)
    scratch = torch.empty(lib.atq_order_stat_scratch_words(grid),
                          dtype=torch.int32, device=device)
    rank = rank.reshape(1).contiguous()
    check(lib.atq_order_stat(
        device.index if device.index is not None else 0,
        abs_flat.data_ptr(), n, rank.data_ptr(), out.data_ptr(),
        scratch.data_ptr(), grid,
        torch.cuda.current_stream(device).cuda_stream),
        "order_stat kernel")
    order_statistic_reductions.launches += 1
    return out[0], out[1], out[2]


order_statistic_reductions.launches = 0
