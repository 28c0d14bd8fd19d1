"""Port fused quantize+matmul op (atq_tpu_torch.ops.fused_linear) against
atq_tpu.ops.fused_linear.fused_quantized_linear on the CPU.

On the CPU the JAX op runs its custom_vjp through the XLA math (the JAX
package's own plain path) and the port's autograd op through its kernels'
plain PyTorch versions. Same seeded numpy inputs; forward and every
gradient (dx, dw, dalpha) within rtol/atol 1e-5, the JAX tests' tolerance
(tests/test_fused_linear.py). The threshold is the quantizer's, computed
by each package from the same weights (bit-identical).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from atq_tpu.core.quantize import ternary_threshold as jax_threshold
from atq_tpu.ops.fused_linear import (
    fused_quantized_linear as jax_fused_quantized_linear,
)
from atq_tpu_torch.core.quantize import ternary_threshold
from atq_tpu_torch.nn.layers import ResidualPrecisionBoostLinear
from atq_tpu_torch.ops import fused_linear as fl

TOL = dict(rtol=1e-5, atol=1e-5)


def _inputs(m, n, k, with_mask, seed, lead=None):
    rng = np.random.RandomState(seed)
    x = rng.randn(*(lead or (m,)), k).astype(np.float32)
    w = rng.randn(n, k).astype(np.float32)
    alpha = np.asarray([0.7], np.float32)
    mask = (rng.rand(n, k) < 0.1) if with_mask else None
    g = rng.randn(*(lead or (m,)), n).astype(np.float32)
    return x, w, alpha, mask, g


def _jax(x, w, alpha, mask, g, grad_mode, sparsity=0.3):
    def loss(x, w, alpha):
        thr = jax_threshold(w, sparsity_target=sparsity)
        y = jax_fused_quantized_linear(
            x, w, alpha, thr,
            mask=None if mask is None else jnp.asarray(mask, jnp.float32),
            grad_mode=grad_mode)
        return jnp.sum(y * g), y

    (_, y), grads = jax.value_and_grad(loss, argnums=(0, 1, 2),
                                       has_aux=True)(
        jnp.asarray(x), jnp.asarray(w), jnp.asarray(alpha))
    return [np.asarray(t) for t in (y, *grads)]


def _port(x, w, alpha, mask, g, grad_mode, sparsity=0.3):
    xt, wt, at = (torch.from_numpy(a).requires_grad_()
                  for a in (x, w, alpha))
    thr = ternary_threshold(wt, sparsity_target=sparsity)
    y = fl.fused_quantized_linear(
        xt, wt, at, thr, mask=None if mask is None else torch.from_numpy(mask),
        grad_mode=grad_mode)
    (y * torch.from_numpy(g)).sum().backward()
    return [t.detach().numpy() for t in (y, xt.grad, wt.grad, at.grad)]


@pytest.mark.parametrize("grad_mode", ["parity", "ste"])
@pytest.mark.parametrize("with_mask", [True, False])
def test_forward_and_grads_match_jax(grad_mode, with_mask):
    args = _inputs(16, 24, 40, with_mask, seed=0)
    want = _jax(*args, grad_mode)
    got = _port(*args, grad_mode)
    for name, a, b in zip(("y", "dx", "dw", "dalpha"), got, want):
        assert a.shape == b.shape, name
        np.testing.assert_allclose(a, b, err_msg=name, **TOL)


def test_nd_input_matches_jax_and_flat():
    args = _inputs(None, 12, 24, True, seed=3, lead=(2, 5))
    want = _jax(*args, "ste")
    got = _port(*args, "ste")
    assert got[0].shape == (2, 5, 12)
    for name, a, b in zip(("y", "dx", "dw", "dalpha"), got, want):
        np.testing.assert_allclose(a, b, err_msg=name, **TOL)
    x, w, alpha, mask, g = args
    flat = _port(x.reshape(10, 24), w, alpha, mask, g.reshape(10, 12),
                 "ste")
    np.testing.assert_allclose(got[0].reshape(10, 12), flat[0], rtol=1e-6)


def test_parity_latent_grad_is_exact_zero():
    x, w, alpha, _, g = _inputs(8, 16, 32, False, seed=1)
    _, _, dw, _ = _port(x, w, alpha, None, g, "parity")
    assert np.all(dw == 0.0)
    assert np.all(_jax(x, w, alpha, None, g, "parity")[2] == 0.0)


def test_rpb_parity_grad_only_on_masked_entries():
    x, w, alpha, mask, g = _inputs(8, 16, 32, True, seed=2)
    _, _, dw, _ = _port(x, w, alpha, mask, g, "parity")
    assert np.all(dw[~mask] == 0.0)
    assert np.any(dw[mask] != 0.0)


def test_threshold_and_mask_get_no_gradient():
    x, w, alpha, mask, g = _inputs(6, 10, 20, True, seed=4)
    wt = torch.from_numpy(w).requires_grad_()
    thr = torch.tensor(0.5, requires_grad=True)
    y = fl.fused_quantized_linear(torch.from_numpy(x), wt,
                                  torch.from_numpy(alpha), thr,
                                  mask=torch.from_numpy(mask))
    (y * torch.from_numpy(g)).sum().backward()
    assert torch.equal(thr.grad, torch.zeros(()))


def test_unknown_grad_mode_raises():
    x, w, alpha, _, _ = _inputs(4, 8, 16, False, seed=5)
    with pytest.raises(ValueError, match="grad_mode"):
        fl.fused_quantized_linear(torch.from_numpy(x), torch.from_numpy(w),
                                  torch.from_numpy(alpha), torch.tensor(0.1),
                                  grad_mode="ttq")


@pytest.mark.parametrize("ste", [False, True])
@pytest.mark.parametrize("with_mask", [True, False])
def test_plain_versions_are_the_dense_paths_gradients(ste, with_mask):
    """The kernels' plain versions equal autograd through the port's dense
    quantize -> blend -> matmul (parity: no gradient through the pattern;
    STE: straight through)."""
    from atq_tpu_torch.nn.layers import _quantize

    x, w, alpha, mask, g = (
        None if a is None else torch.from_numpy(a)
        for a in _inputs(9, 14, 33, with_mask, seed=6))
    thr = ternary_threshold(w, sparsity_target=0.3)
    scal = fl.scalars(alpha, thr)
    wr = w.clone().requires_grad_()
    ar = alpha.clone().requires_grad_()
    w_t, a = _quantize(wr, ar, 0.3, "ste" if ste else "parity")
    if mask is None:
        w_eff = w_t * a
    else:
        m = mask.float()
        w_eff = w_t * a * (1.0 - m) + wr * m
    (torch.matmul(x, w_eff.T) * g).sum().backward()
    dw, da = fl.dwda_plain(g, x, w, mask, scal, ste)
    want_dw = wr.grad if wr.grad is not None else torch.zeros_like(w)
    np.testing.assert_allclose(dw.numpy(), want_dw.numpy(), **TOL)
    np.testing.assert_allclose(da.numpy(), ar.grad.numpy()[0], **TOL)
    np.testing.assert_allclose(fl.dx_plain(g, w, mask, scal).numpy(),
                               torch.matmul(g, w_eff.detach()).numpy(), **TOL)


@pytest.mark.parametrize("fused", [False, True])
def test_rpb_layer_fused_flag_follows_env(monkeypatch, fused):
    """``fused=None`` reads ATQ_FUSED; both paths give the same output and
    gradients from one init."""
    monkeypatch.setenv("ATQ_FUSED", "1" if fused else "0")
    calls = []
    real = fl.fused_quantized_linear
    monkeypatch.setattr(fl, "fused_quantized_linear",
                        lambda *a, **k: calls.append(1) or real(*a, **k))
    x = torch.from_numpy(np.random.RandomState(7).randn(6, 20).astype(
        np.float32))
    outs = []
    for flag in (None, not fused):
        layer = ResidualPrecisionBoostLinear(
            20, 10, precision_ratio=0.1, fused=flag, device="cpu",
            generator=torch.Generator().manual_seed(0))
        y = layer(x)
        (y ** 2).sum().backward()
        outs.append((y.detach(), layer.weight.grad, layer.alpha.grad,
                     layer.bias.grad))
    assert len(calls) == 1  # exactly one of the two layers went fused
    for a, b in zip(*outs):
        np.testing.assert_allclose(a.numpy(), b.numpy(), **TOL)
