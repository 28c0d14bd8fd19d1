"""The port's tie-splitting max pool (ops/fast_pool.py) against
atq_tpu/ops/fast_pool.py on the CPU, case for case with
tests/test_fast_pool.py (the port in NCHW, JAX in NHWC).

The forward is max pooling bit for bit. With unique maxima the backward is
PyTorch's (and XLA's); with tied maxima it splits a window's gradient
equally among them, so the gradient sum is kept, as JAX's does.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.nn.functional as F

from atq_tpu.ops import fast_pool as jf
from atq_tpu_torch.ops import fast_pool as tf

WINDOW, STRIDES, PAD = (3, 3), (2, 2), ((1, 1), (1, 1))


def _torch_pool(x):
    return F.max_pool2d(x, WINDOW, stride=STRIDES, padding=1)


def _unique_max_input(shape, seed):
    """Random NCHW input with (almost surely) unique in-window maxima."""
    rng = np.random.RandomState(seed)
    return (rng.permutation(np.prod(shape)).reshape(shape)
            .astype(np.float32) / np.prod(shape))


def _nhwc(t):
    return np.ascontiguousarray(t.permute(0, 2, 3, 1).detach().numpy())


@pytest.mark.parametrize("shape", [(2, 8, 80, 80), (1, 3, 7, 9)])
def test_forward_bitwise(shape):
    x = torch.from_numpy(np.random.RandomState(0).randn(*shape).astype(
        np.float32))
    y = tf.fast_max_pool(x, WINDOW, STRIDES, PAD)
    np.testing.assert_array_equal(y.numpy(), _torch_pool(x).numpy())
    np.testing.assert_array_equal(_nhwc(y), np.asarray(jf.fast_max_pool(
        jnp.asarray(_nhwc(x)), WINDOW, STRIDES, PAD)))


@pytest.mark.parametrize("shape", [(2, 4, 16, 16), (1, 3, 7, 9)])
def test_backward_matches_torch_when_unique(shape):
    x = _unique_max_input(shape, 1)
    g = np.random.RandomState(2).randn(
        *_torch_pool(torch.from_numpy(x)).shape).astype(np.float32)
    grads = []
    for pool in (lambda a: tf.fast_max_pool(a, WINDOW, STRIDES, PAD),
                 _torch_pool):
        xt = torch.from_numpy(x).requires_grad_()
        pool(xt).backward(torch.from_numpy(g))
        grads.append(xt.grad.numpy())
    np.testing.assert_allclose(grads[0], grads[1], rtol=0, atol=1e-6)


def test_tied_maxima_split_equally_and_preserve_sum():
    x = np.zeros((1, 1, 3, 3), np.float32)
    x[0, 0, 0, 0] = x[0, 0, 1, 1] = 5.0  # tied inside output window (0, 0)
    xt = torch.from_numpy(x).requires_grad_()
    y = tf.fast_max_pool(xt, (3, 3), (2, 2), ((1, 1), (1, 1)))
    g = torch.zeros_like(y)
    g[0, 0, 0, 0] = 1.0
    y.backward(g)
    assert float(xt.grad[0, 0, 0, 0]) == pytest.approx(0.5)
    assert float(xt.grad[0, 0, 1, 1]) == pytest.approx(0.5)
    xt.grad = None
    y = tf.fast_max_pool(xt, (3, 3), (2, 2), ((1, 1), (1, 1)))
    y.backward(torch.ones_like(y))
    assert float(xt.grad.sum()) == pytest.approx(float(y.numel()), rel=1e-6)
    _, vjp = jax.vjp(lambda a: jf.fast_max_pool(a, (3, 3), (2, 2),
                                                ((1, 1), (1, 1))),
                     jnp.asarray(_nhwc(torch.from_numpy(x))))
    want = np.asarray(vjp(jnp.ones((1, 2, 2, 1), jnp.float32))[0])
    np.testing.assert_array_equal(_nhwc(xt.grad), want)


def test_ties_at_zero_after_relu_match_jax():
    """Post-ReLU maps tie at 0: the split backward against JAX's."""
    x = np.maximum(np.random.RandomState(3).randn(2, 4, 12, 12), 0).astype(
        np.float32)
    g = np.random.RandomState(4).randn(2, 4, 6, 6).astype(np.float32)
    xt = torch.from_numpy(x).requires_grad_()
    tf.fast_max_pool(xt).backward(torch.from_numpy(g))
    _, vjp = jax.vjp(jf.fast_max_pool, jnp.asarray(_nhwc(
        torch.from_numpy(x))))
    want = np.asarray(vjp(jnp.asarray(_nhwc(torch.from_numpy(g))))[0])
    np.testing.assert_allclose(_nhwc(xt.grad), want, rtol=1e-6, atol=1e-7)


def test_grad_in_bf16():
    x = torch.from_numpy(_unique_max_input((2, 4, 16, 16), 3)).to(
        torch.bfloat16).requires_grad_()
    (tf.fast_max_pool(x) ** 2).sum().backward()
    assert x.grad.dtype == torch.bfloat16
    assert torch.isfinite(x.grad.float()).all()


def test_env_dispatch(monkeypatch):
    x = torch.from_numpy(_unique_max_input((1, 2, 8, 8), 4))
    monkeypatch.setenv("ATQ_FAST_POOL", "1")
    fast = tf.max_pool(x)
    monkeypatch.setenv("ATQ_FAST_POOL", "0")
    np.testing.assert_array_equal(fast.numpy(), tf.max_pool(x).numpy())
