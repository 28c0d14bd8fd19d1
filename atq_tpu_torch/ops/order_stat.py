"""Exact order statistic of |w|, with its max and sum, in one call.

PyTorch counterpart of atq_tpu/ops/order_stat.py: the Pallas kernels
``_kernel`` behind ``order_statistic_reductions`` and ``_batched_kernel``
behind ``order_statistic_reductions_batched`` (one statistic per row of a
stacked (L, n) tensor). The single statistic goes through a registered op,
``torch.ops.atq_tpu_torch.order_stat``, so that ``torch.export`` keeps it
as one node (serve/aot.py); the batched one, which no eval forward
reaches, is called directly. On a CUDA tensor each wrapper launches the
radix-select kernel in ``csrc/order_stat.cu``: one thread block cluster a
row, the row read from device memory once (held in the cluster's shared
memory; a row longer than that holds a sample and keeps only the elements
near the rank's bin), one launch a call and no scratch (the only
allocation is the (L, 3) output). On a CPU tensor it takes the plain PyTorch version (sort,
max, sum). There is no other route: a CUDA tensor the kernel cannot take,
or a cluster launch the card refuses, raises. Each wrapper counts its own
launches, and its FLOPs as ``FlopCounterMode`` counts its plain version's
(sort, max, sum: no product, so 0; ops/__init__.py ``kernel_flops``).

The JAX side's 12 MiB VMEM budget gate does not apply here: the CUDA
kernel takes any n below 2^31 and any L below 2^16.
"""

from __future__ import annotations

import ctypes

import torch

from atq_tpu_torch.ops._build import check, load_library


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
    if abs_flat.device.type not in ("cpu", "cuda"):
        raise ValueError(f"unsupported device {abs_flat.device}")
    out = torch.ops.atq_tpu_torch.order_stat(abs_flat, rank)
    return out[0], out[1], out[2]


@torch.library.custom_op("atq_tpu_torch::order_stat", mutates_args=(),
                         device_types="cpu",
                         schema="(Tensor abs_flat, Tensor rank) -> Tensor")
def _order_stat_op(abs_flat, rank):
    """``[stat, max, sum]`` as one (3,) float32 tensor: the registered op
    behind :func:`order_statistic_reductions` (one node under
    ``torch.export``). Its CPU implementation is the plain version."""
    return torch.stack(order_statistic_plain(abs_flat, rank))


@_order_stat_op.register_kernel("cuda")
def _order_stat_cuda(abs_flat, rank):
    out = _launch(abs_flat.reshape(1, -1), rank.reshape(1).contiguous())
    order_statistic_reductions.launches += 1
    return out.reshape(3)


@_order_stat_op.register_fake
def _order_stat_fake(abs_flat, rank):
    return abs_flat.new_empty((3,))


def _device_index(device: torch.device) -> int:
    return device.index if device.index is not None else 0


def _launch(rows: torch.Tensor, ranks: torch.Tensor) -> torch.Tensor:
    """The radix-select kernel over each row of ``rows`` (L, n), one
    cluster launch; returns (L, 3) float32 ``[stat, max, sum]``."""
    lib = load_library()
    lead, n = rows.shape
    device = rows.device
    out = torch.empty((lead, 3), dtype=torch.float32, device=device)
    check(lib.atq_order_stat(
        _device_index(device), rows.data_ptr(), n, lead, ranks.data_ptr(),
        out.data_ptr(), torch.cuda.current_stream(device).cuda_stream),
        "order_stat kernel")
    return out


def kernel_plan(n: int, rows: int, device) -> dict:
    """The cluster size (CTAs a row) the kernel takes for ``rows`` rows of
    ``n`` elements on ``device``, and whether a row is held whole in the
    cluster's shared memory, as the launch picks them."""
    lib = load_library()
    cluster, resident = ctypes.c_int(), ctypes.c_int()
    check(lib.atq_order_stat_plan(_device_index(torch.device(device)), n,
                                  rows, ctypes.byref(cluster),
                                  ctypes.byref(resident)),
          "order_stat plan")
    return {"cluster": cluster.value, "resident": bool(resident.value)}


def order_statistic_batched_plain(abs2d: torch.Tensor, ranks: torch.Tensor):
    """Plain PyTorch version of the batched statistic: a per-row sort and
    gather, with the per-row max and sum."""
    stat = torch.sort(abs2d, dim=1).values.gather(
        1, ranks.reshape(-1, 1).long()).reshape(-1)
    return stat, abs2d.max(dim=1).values, abs2d.sum(dim=1)


def order_statistic_reductions_batched(abs2d: torch.Tensor,
                                       ranks: torch.Tensor):
    """Per row ``l`` of a stacked (L, n) non-negative float32 tensor,
    ``(sorted(abs2d[l])[ranks[l]], max, sum)`` as three (L,) float32
    tensors, in one launch whatever L is. ``ranks`` is
    an (L,) int32 tensor on the same device (each clamped to [0, n-1]).
    Each statistic is bit-identical to the sort; on CUDA each row's sum is
    reduced in a fixed order."""
    if abs2d.dtype != torch.float32 or abs2d.ndim != 2:
        raise ValueError(f"order_statistic_reductions_batched takes a 2-D "
                         f"float32 tensor, got {abs2d.dtype} "
                         f"{tuple(abs2d.shape)}")
    lead, n = abs2d.shape
    if not abs2d.is_contiguous():
        raise ValueError("order_statistic_reductions_batched needs a "
                         "contiguous tensor")
    if not 0 < n < 2 ** 31 or not 0 < lead < 2 ** 16:
        raise ValueError(f"shape {(lead, n)} out of range: 1 <= L < 2^16, "
                         f"1 <= n < 2^31")
    if ranks.dtype != torch.int32 or tuple(ranks.shape) != (lead,):
        raise ValueError(f"ranks must be ({lead},) int32, got {ranks.dtype} "
                         f"{tuple(ranks.shape)}")
    if ranks.device != abs2d.device:
        raise ValueError(f"ranks on {ranks.device}, values on "
                         f"{abs2d.device}")
    if abs2d.device.type == "cpu":
        return order_statistic_batched_plain(abs2d, ranks)
    if abs2d.device.type != "cuda":
        raise ValueError(f"unsupported device {abs2d.device}")
    out = _launch(abs2d, ranks.contiguous())
    order_statistic_reductions_batched.launches += 1
    return out[:, 0], out[:, 1], out[:, 2]


order_statistic_reductions.launches = 0
order_statistic_reductions_batched.launches = 0
# The plain versions hold no product: FlopCounterMode counts them 0, and
# the kernels add nothing.
order_statistic_reductions.flops = 0
order_statistic_reductions_batched.flops = 0
