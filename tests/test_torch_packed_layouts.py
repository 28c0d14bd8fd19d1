"""The ``rows`` and ``flat`` packed layouts of the port
(atq_tpu_torch/core/packing.py, ops/ternary_matmul.py) against the JAX
package's on the CPU.

Packed bytes and decoded values must be equal bit for bit, odd sizes and
K % 4 != 0 included. The matmuls take their plain paths on both sides here
(the port's kernel wrapper its plain version, JAX its XLA fallback);
their tolerance, rtol 1e-5 and atol 5e-3, is the JAX package's own kernel
test's (tests/test_pallas_interpret.py): the sums run in another order.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from atq_tpu.core.packing import TernaryBitPacking as JaxPacking
from atq_tpu.core.packing import pack_rows as jax_pack_rows
from atq_tpu.core.packing import unpack_rows as jax_unpack_rows
from atq_tpu.ops.ternary_matmul import (
    packed_ternary_matmul as jax_packed_ternary_matmul,
)
from atq_tpu_torch.core.packing import (
    TernaryBitPacking,
    pack_planar,
    pack_planar_unchecked,
    pack_rows,
    unpack_rows,
)
from atq_tpu_torch.ops.ternary_matmul import packed_ternary_matmul

RTOL, ATOL = 1e-5, 5e-3
SHAPES = [(1, 1), (3, 5), (7, 13), (8, 128), (5, 130), (2, 1027)]


def _ternary(shape, seed):
    return np.random.RandomState(seed).choice(
        [-1.0, 0.0, 1.0], size=shape).astype(np.float32)


@pytest.mark.parametrize("shape", SHAPES, ids=str)
def test_rows_and_flat_bytes_match_jax(shape):
    w = _ternary(shape, seed=sum(shape))
    rows = pack_rows(torch.from_numpy(w))
    np.testing.assert_array_equal(rows.numpy(),
                                  np.asarray(jax_pack_rows(jnp.asarray(w))))
    np.testing.assert_array_equal(unpack_rows(rows, shape[1]).numpy(), w)
    np.testing.assert_array_equal(
        unpack_rows(rows, shape[1]).numpy(),
        np.asarray(jax_unpack_rows(jnp.asarray(rows.numpy()), shape[1])))
    flat = TernaryBitPacking.pack_ternary_weights(torch.from_numpy(w))
    want = JaxPacking.pack_ternary_weights(jnp.asarray(w))
    np.testing.assert_array_equal(flat["packed_weights"].numpy(),
                                  np.asarray(want["packed_weights"]))
    assert flat["original_shape"] == want["original_shape"]
    assert flat["metadata"] == want["metadata"]
    back = TernaryBitPacking.unpack_ternary_weights(flat)
    np.testing.assert_array_equal(back.numpy(), w)
    jax_back = JaxPacking.unpack_ternary_weights(
        {**want, "packed_weights": jnp.asarray(
            flat["packed_weights"].numpy())})
    np.testing.assert_array_equal(back.numpy(), np.asarray(jax_back))
    # The rows -> planes conversion the kernel route makes on the device.
    np.testing.assert_array_equal(
        pack_planar_unchecked(unpack_rows(rows, shape[1])).numpy(),
        pack_planar(torch.from_numpy(w)).numpy())


def test_flat_padding_decodes_as_minus_one_and_check():
    """The trailing fields of the last byte are 0 (-1 when decoded past
    ``num_values``, as in the reference), and non-ternary input raises."""
    w = torch.tensor([1.0, 0.0, -1.0, 1.0, 0.0])
    packed = TernaryBitPacking.pack_ternary_weights(w)["packed_weights"]
    assert packed.tolist() == [2 | 1 << 2 | 0 << 4 | 2 << 6, 1]
    with pytest.raises(ValueError, match="ternary"):
        TernaryBitPacking.pack_ternary_weights(torch.tensor([0.5, 1.0]))


# Kernel-eligible shapes (K >= 128, N >= 8: the planar kernel's route) and
# shapes below it, with K % 4 = 0 and not.
MNK = [(4, 16, 256), (3, 10, 130), (2, 8, 129), (5, 4, 64), (3, 6, 37)]


@pytest.mark.parametrize("layout", ["rows", "flat"])
@pytest.mark.parametrize("mnk", MNK, ids=str)
@pytest.mark.parametrize("ttq", [False, True], ids=["sym", "ttq"])
def test_packed_matmul_layouts_match_jax(layout, mnk, ttq):
    m, n, k = mnk
    rng = np.random.RandomState(m * n + k)
    w = _ternary((n, k), seed=k)
    x = (rng.randn(m, k) * 0.1).astype(np.float32)
    if layout == "rows":
        packed = np.array(jax_pack_rows(jnp.asarray(w)))
    else:
        packed = np.array(JaxPacking.pack_ternary_weights(
            jnp.asarray(w))["packed_weights"])
    alpha_neg = 0.4 if ttq else None
    got = packed_ternary_matmul(torch.from_numpy(x),
                                torch.from_numpy(packed), (n, k), alpha=0.9,
                                layout=layout, alpha_neg=alpha_neg)
    want = jax_packed_ternary_matmul(jnp.asarray(x), jnp.asarray(packed),
                                     (n, k), alpha=0.9, layout=layout,
                                     alpha_neg=alpha_neg)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=RTOL,
                               atol=ATOL)
    # Every route computes the same product as the dense weight.
    w_eff = (0.9 * np.maximum(w, 0) + (0.4 if ttq else 0.9)
             * np.minimum(w, 0))
    np.testing.assert_allclose(got.numpy(), x @ w_eff.T, rtol=RTOL,
                               atol=ATOL)


@pytest.mark.parametrize("mnk", [(4, 16, 256), (3, 10, 130), (3, 6, 37)],
                         ids=str)
def test_fast_ternary_matmul_matches_jax(mnk):
    m, n, k = mnk
    w = _ternary((n, k), seed=n + k)
    x = np.random.RandomState(m).randn(m, k).astype(np.float32)
    got = TernaryBitPacking.fast_ternary_matmul(
        TernaryBitPacking.pack_ternary_weights(torch.from_numpy(w)),
        torch.from_numpy(x), alpha=0.7)
    want = JaxPacking.fast_ternary_matmul(
        JaxPacking.pack_ternary_weights(jnp.asarray(w)), jnp.asarray(x),
        alpha=0.7)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=RTOL,
                               atol=ATOL)


def test_unknown_layout_raises():
    with pytest.raises(ValueError, match="layout"):
        packed_ternary_matmul(torch.zeros(2, 128), torch.zeros(
            8, 32, dtype=torch.uint8), (8, 128), layout="columns")
