"""Port planar packing (atq_tpu_torch.core.packing) against
atq_tpu.core.packing: the plane bytes must be identical."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from atq_tpu.core.packing import pack_planar as jax_pack_planar
from atq_tpu_torch.core.packing import pack_planar, unpack_planar


def _ternary(shape, seed):
    rng = np.random.RandomState(seed)
    return rng.choice([-1.0, 0.0, 1.0], size=shape,
                      p=[0.35, 0.3, 0.35]).astype(np.float32)


# K a multiple of 512, ragged K (padded), the two head layers, and the
# K-blocked serving shape.
@pytest.mark.parametrize("shape", [(8, 512), (16, 100), (10, 128),
                                   (128, 3136), (4, 8704)])
def test_pack_planar_bytes_identical_to_jax(shape):
    w = _ternary(shape, seed=shape[1])
    got = pack_planar(torch.from_numpy(w))
    want = np.asarray(jax_pack_planar(jnp.asarray(w)))
    assert got.dtype == torch.uint8
    assert got.shape == want.shape
    np.testing.assert_array_equal(got.numpy(), want)
    np.testing.assert_array_equal(
        unpack_planar(got, shape[1]).numpy(), w)


def test_pack_planar_rejects_non_ternary():
    w = torch.from_numpy(_ternary((4, 64), seed=0))
    w[1, 2] = 0.5
    with pytest.raises(ValueError, match="ternary"):
        pack_planar(w)
    with pytest.raises(ValueError):
        pack_planar(torch.zeros(64))
