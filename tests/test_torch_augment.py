"""Port augmentation (atq_tpu_torch.data.augment) against
atq_tpu.data.augment on the CPU.

The two packages draw different random numbers, so the rotation is checked
at fixed angles (atol 1e-5: bilinear weights from float32 trigonometry in
two libraries) and the flip from a given mask (exact). The seeded random
wrappers are checked for their ranges and reproducibility.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from atq_tpu.data.augment import _rotate_bilinear as jax_rotate
from atq_tpu_torch.data import augment as ta


def _images(b=6, h=28, w=28, c=1, seed=0):
    return np.random.RandomState(seed).rand(b, h, w, c).astype(np.float32)


@pytest.mark.parametrize("degrees", [[0, 0, 0, 0, 0, 0],
                                     [5, -5, 2.5, -1, 0.3, 4.9],
                                     [30, -45, 90, 180, 12, -7]])
def test_rotate_bilinear_matches_jax(degrees):
    x = _images()
    theta = np.deg2rad(np.asarray(degrees, np.float64)).astype(np.float32)
    want = np.asarray(jax_rotate(jnp.asarray(x), jnp.asarray(theta)))
    got = ta._rotate_bilinear(torch.from_numpy(x),
                              torch.from_numpy(theta)).numpy()
    np.testing.assert_allclose(got, want, atol=1e-5, rtol=0)
    if not any(degrees):
        np.testing.assert_array_equal(got, x)  # exact identity at 0


def test_rotate_multichannel_and_rectangular_match_jax():
    x = _images(b=3, h=12, w=20, c=3, seed=1)
    theta = np.float32([0.05, -0.08, 0.02])
    want = np.asarray(jax_rotate(jnp.asarray(x), jnp.asarray(theta)))
    got = ta._rotate_bilinear(torch.from_numpy(x),
                              torch.from_numpy(theta)).numpy()
    np.testing.assert_allclose(got, want, atol=1e-5, rtol=0)


def test_hflip_from_a_given_mask():
    x = _images(b=4, seed=2)
    flips = np.array([True, False, True, False])
    got = ta.hflip(torch.from_numpy(x), torch.from_numpy(flips)).numpy()
    want = np.where(flips[:, None, None, None], x[:, :, ::-1, :], x)
    np.testing.assert_array_equal(got, want)


def test_seeded_augment_is_reproducible_and_in_range():
    x = torch.from_numpy(_images(b=64, seed=3))

    def run(seed):
        return ta.classifier_augment(
            x, torch.Generator().manual_seed(seed), flip=True)

    a, b, c = run(0), run(0), run(1)
    assert torch.equal(a, b)
    assert not torch.equal(a, c)
    assert a.shape == x.shape
    # Rotations of at most 5 degrees move the center pixel's value little.
    center = x[:, 13:15, 13:15].mean()
    assert abs(a[:, 13:15, 13:15].mean() - center) < 0.1
    mnist = ta.classifier_augment(x, torch.Generator().manual_seed(0),
                                  flip=False)
    assert mnist.shape == x.shape
