"""Port order statistic (atq_tpu_torch.ops.order_stat) against the JAX
package's exact bit-bisection (atq_tpu.core.quantize._order_statistic_f32).

On the CPU the wrapper takes its plain version (sort, max, sum); the
statistic must be bit-identical to JAX's. The CUDA kernel itself is held
against the plain version by tests/test_torch_cuda_kernels.py and by
``chip_smoke.py``.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from atq_tpu.core.quantize import _order_statistic_f32
from atq_tpu_torch.ops.order_stat import order_statistic_reductions


def _input(kind, n, seed=0):
    rng = np.random.RandomState(seed)
    if kind == "zeros":
        return np.zeros(n, np.float32)
    if kind == "dups":
        return (rng.randint(0, 6, n) / 4.0).astype(np.float32)
    return np.abs(rng.randn(n)).astype(np.float32)


def _ranks(n):
    return sorted({0, 1, int(np.floor(np.float32(0.3) * np.float32(n))),
                   n - 1})


@pytest.mark.parametrize("kind,n", [("randn", 1000), ("randn", 16385),
                                    ("dups", 20000), ("zeros", 16384)])
def test_plain_path_bit_exact_vs_jax(kind, n):
    x = _input(kind, n)
    xt = torch.from_numpy(x)
    for r in _ranks(n):
        stat, mx, sm = order_statistic_reductions(
            xt, torch.tensor([r], dtype=torch.int32))
        want = np.asarray(_order_statistic_f32(jnp.asarray(x), jnp.int32(r)))
        assert stat.numpy().tobytes() == want.tobytes(), (kind, n, r)
    assert float(mx) == float(x.max())
    np.testing.assert_allclose(float(sm), x.astype(np.float64).sum(),
                               rtol=1e-6)


def test_rank_tensor_stays_on_device_and_is_not_synced():
    x = torch.from_numpy(_input("randn", 4096))
    rank = torch.tensor(7, dtype=torch.int32)  # 0-d is accepted too
    stat, _, _ = order_statistic_reductions(x, rank)
    assert stat.shape == () and float(stat) == float(torch.sort(x)[0][7])


@pytest.mark.parametrize("bad", ["dtype", "ndim", "strided", "rank_dtype",
                                 "empty"])
def test_wrapper_rejects_bad_inputs(bad):
    x = torch.rand(64)
    rank = torch.tensor([3], dtype=torch.int32)
    if bad == "dtype":
        x = x.double()
    elif bad == "ndim":
        x = x.reshape(8, 8)
    elif bad == "strided":
        x = torch.rand(128)[::2]
    elif bad == "rank_dtype":
        rank = rank.long()
    elif bad == "empty":
        x = torch.empty(0)
    with pytest.raises(ValueError):
        order_statistic_reductions(x, rank)
