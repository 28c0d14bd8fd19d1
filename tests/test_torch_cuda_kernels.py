"""The port's CUDA kernels against their plain PyTorch versions, on the card.

Every test here needs an NVIDIA GPU (the kernels have no CPU mode) and
skips without one. The file imports neither JAX nor the JAX package, so it
also runs on a machine without them; there, skip the JAX-importing
conftest:

    python -m pytest --noconftest -q -m cuda tests/test_torch_cuda_kernels.py

Tolerances: the order statistic is bit-exact (max equal, sum within
rtol 1e-6); the packed matmul is held to rtol 1e-5 / atol 5e-3, the JAX
package's own kernel tolerance (tests/test_pallas_interpret.py).
"""

import numpy as np
import pytest
import torch

from atq_tpu_torch.core.packing import pack_planar
from atq_tpu_torch.core.quantize import ternary_threshold
from atq_tpu_torch.ops.order_stat import (
    order_statistic_plain,
    order_statistic_reductions,
)
from atq_tpu_torch.ops.ternary_matmul import (
    ternary_matmul_plain,
    ternary_matmul_planar,
)

pytestmark = pytest.mark.cuda

MM_RTOL, MM_ATOL = 1e-5, 5e-3


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the CUDA kernels have no CPU mode")
    from atq_tpu_torch.utils.platform import resolve_device

    return resolve_device("cuda")  # also turns TF32 off


def _abs_input(kind, n, seed=0):
    rng = np.random.RandomState(seed)
    if kind == "zeros":
        return torch.zeros(n)
    if kind == "dups":
        return torch.from_numpy((rng.randint(0, 6, n) / 4.0).astype(
            np.float32))
    return torch.from_numpy(np.abs(rng.randn(n)).astype(np.float32))


@pytest.mark.parametrize("kind,n", [("randn", 401408), ("randn", 16385),
                                    ("dups", 100000), ("zeros", 20000)])
def test_order_stat_bit_exact_vs_plain(cuda, kind, n):
    x = _abs_input(kind, n).to(cuda)
    for r in sorted({0, 1, int(np.floor(np.float32(0.3) * np.float32(n))),
                     n - 1}):
        rank = torch.tensor([r], dtype=torch.int32, device=cuda)
        got = torch.stack(order_statistic_reductions(x, rank)).cpu()
        want = torch.stack(order_statistic_plain(x, rank)).cpu()
        assert got[0].view(torch.int32) == want[0].view(torch.int32), r
        assert got[1] == want[1]
        assert abs(got[2] - want[2]) <= 1e-6 * abs(want[2])


def test_order_stat_counts_launches_and_rejects_bad_cuda_input(cuda):
    x = _abs_input("randn", 20000).to(cuda)
    rank = torch.tensor([5], dtype=torch.int32, device=cuda)
    before = order_statistic_reductions.launches
    order_statistic_reductions(x, rank)
    assert order_statistic_reductions.launches == before + 1
    with pytest.raises(ValueError):  # no silent fallback for CUDA tensors
        order_statistic_reductions(x.double(), rank)
    with pytest.raises(ValueError):
        order_statistic_reductions(x[::2], rank)


def test_threshold_on_cuda_equals_cpu(cuda):
    w = torch.from_numpy((np.random.RandomState(1).randn(128, 3136) * 0.02)
                         .astype(np.float32))
    for s in (0.0, 0.3, 1.0):
        got = ternary_threshold(w.to(cuda), sparsity_target=s).cpu()
        want = ternary_threshold(w, sparsity_target=s)
        if s == 0.0:  # idx == 0: a mean, summed in another order
            torch.testing.assert_close(got, want, rtol=1e-6, atol=0)
        else:
            assert got.view(torch.int32) == want.view(torch.int32)


@pytest.mark.parametrize("mnk", [(1, 128, 3136), (32, 128, 3136),
                                 (32, 10, 128), (7, 256, 3136),
                                 (128, 128, 8704)])
def test_matmul_matches_plain(cuda, mnk):
    m, n, k = mnk
    g = torch.Generator().manual_seed(k)
    w = torch.randint(-1, 2, (n, k), generator=g).float().to(cuda)
    planes = pack_planar(w)
    x = (torch.randn(m, k, generator=g) * 0.1).to(cuda)
    for avec, asym in (((0.9, 0.9), False), ((0.9, 0.4), True)):
        avec = torch.tensor(avec, device=cuda)
        got = ternary_matmul_planar(x, planes, k, avec, asym)
        want = ternary_matmul_plain(x, planes, k, avec, asym)
        torch.testing.assert_close(got, want, rtol=MM_RTOL, atol=MM_ATOL)


def test_matmul_counts_launches_and_rejects_bad_cuda_input(cuda):
    w = torch.randint(-1, 2, (16, 512)).float().to(cuda)
    planes = pack_planar(w)
    x = torch.randn(4, 512, device=cuda)
    avec = torch.tensor([1.0, 1.0], device=cuda)
    before = ternary_matmul_planar.launches
    ternary_matmul_planar(x, planes, 512, avec)
    assert ternary_matmul_planar.launches == before + 1
    with pytest.raises(ValueError):
        ternary_matmul_planar(x.double(), planes, 512, avec)
    with pytest.raises(ValueError):  # planes on the CPU, x on the card
        ternary_matmul_planar(x, planes.cpu(), 512, avec)
