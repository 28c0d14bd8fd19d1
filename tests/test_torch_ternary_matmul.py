"""Port packed ternary matmul (atq_tpu_torch.ops.ternary_matmul) against
atq_tpu.ops.ternary_matmul.packed_ternary_matmul on the CPU.

Both sides take their plain paths here (unpack, then matmul). The
tolerance, rtol 1e-5 and atol 5e-3, is that of the JAX package's own
kernel test (tests/test_pallas_interpret.py): the sums run in another
order. The CUDA kernel is held against the plain version by
tests/test_torch_cuda_kernels.py and by ``chip_smoke.py``.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from atq_tpu.core.packing import pack_planar as jax_pack_planar
from atq_tpu.ops.ternary_matmul import (
    packed_ternary_matmul as jax_packed_ternary_matmul,
)
from atq_tpu_torch.core.packing import pack_planar
from atq_tpu_torch.ops.ternary_matmul import (
    packed_ternary_matmul,
    ternary_matmul_planar,
)

RTOL, ATOL = 1e-5, 5e-3


def _ternary(shape, seed):
    rng = np.random.RandomState(seed)
    return rng.choice([-1.0, 0.0, 1.0], size=shape,
                      p=[0.35, 0.3, 0.35]).astype(np.float32)


# (M, N, K): the head's first layer, its second (K=128, N=10), the shape
# that routes to _kernel_kblocked in JAX (K=8704), and one below the
# kernel's eligibility (K < 128), which unpacks and matmuls.
@pytest.mark.parametrize("mnk", [(4, 128, 3136), (3, 10, 128),
                                 (2, 16, 8704), (5, 4, 64)])
@pytest.mark.parametrize("ttq", [False, True])
def test_matches_jax_packed_matmul(mnk, ttq):
    m, n, k = mnk
    rng = np.random.RandomState(m * n + k)
    w = _ternary((n, k), seed=k)
    x = (rng.randn(m, k) * 0.1).astype(np.float32)
    alpha_neg = 0.4 if ttq else None
    got = packed_ternary_matmul(torch.from_numpy(x),
                                pack_planar(torch.from_numpy(w)), (n, k),
                                alpha=0.9, alpha_neg=alpha_neg)
    want = jax_packed_ternary_matmul(jnp.asarray(x),
                                     jax_pack_planar(jnp.asarray(w)), (n, k),
                                     alpha=0.9, alpha_neg=alpha_neg)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=RTOL,
                               atol=ATOL)


# 'rows' and 'flat' are not ported yet; 'planar32' is
# (tests/test_torch_packed_kernels.py), and refuses uint8 planes.
@pytest.mark.parametrize("layout,error", [("rows", NotImplementedError),
                                          ("flat", NotImplementedError),
                                          ("planar32", ValueError)],
                         ids=["rows", "flat", "planar32"])
def test_unported_layouts_raise(layout, error):
    with pytest.raises(error, match="ROADMAP" if error is
                       NotImplementedError else "int32"):
        packed_ternary_matmul(torch.zeros(2, 128), torch.zeros(
            8, 128, dtype=torch.uint8), (8, 128), layout=layout)


def test_wrapper_rejects_bad_inputs():
    planes = pack_planar(torch.from_numpy(_ternary((8, 256), seed=1)))
    avec = torch.tensor([1.0, 1.0])
    with pytest.raises(ValueError):  # planes for another K
        ternary_matmul_planar(torch.zeros(2, 700), planes, 700, avec)
    with pytest.raises(ValueError):  # x not float32
        ternary_matmul_planar(torch.zeros(2, 256, dtype=torch.float64),
                              planes, 256, avec)
    with pytest.raises(ValueError):  # alpha vector of one value
        ternary_matmul_planar(torch.zeros(2, 256), planes, 256,
                              torch.tensor([1.0]))
