"""Port quantizer (atq_tpu_torch.core.quantize) against atq_tpu.core.quantize.

Same seeded numpy weights through both packages on the CPU. Thresholds
and ternary patterns must be bit-identical; alpha and the idx == 0
fallback threshold (a mean, summed in another order) are held to
rtol 1e-6.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from atq_tpu.core import quantize as jq
from atq_tpu_torch.core import quantize as tq


def _weights(shape, seed, duplicates=False):
    rng = np.random.RandomState(seed)
    if duplicates:
        return (rng.randint(-4, 5, size=shape) / 8.0).astype(np.float32)
    return (rng.randn(*shape) * 0.05).astype(np.float32)


def _both(w, sparsity):
    thr_j = np.asarray(jq.ternary_threshold(jnp.asarray(w),
                                            sparsity_target=sparsity))
    thr_t = tq.ternary_threshold(torch.from_numpy(w),
                                 sparsity_target=sparsity).numpy()
    wt_j, a_j = jq.adaptive_ternary_quantization(jnp.asarray(w),
                                                 sparsity_target=sparsity)
    wt_t, a_t = tq.adaptive_ternary_quantization(torch.from_numpy(w),
                                                 sparsity_target=sparsity)
    return thr_j, thr_t, np.asarray(wt_j), wt_t.numpy(), a_j, a_t


# (40, 25): n = 1000 takes the sort; (128, 128) and (96, 300) reach the
# order-statistic path (n >= 16,384).
@pytest.mark.parametrize("shape", [(40, 25), (128, 128), (96, 300)])
@pytest.mark.parametrize("sparsity", [0.0, 0.3, 1.0])
def test_threshold_pattern_alpha_match_jax(shape, sparsity):
    w = _weights(shape, seed=shape[0] + int(10 * sparsity))
    thr_j, thr_t, wt_j, wt_t, a_j, a_t = _both(w, sparsity)
    if sparsity == 0.0:  # idx == 0: 0.05 * mean|w|, a sum in another order
        np.testing.assert_allclose(thr_t, thr_j, rtol=1e-6, atol=0)
    else:
        assert thr_t.tobytes() == thr_j.tobytes()
    np.testing.assert_array_equal(wt_t, wt_j)
    np.testing.assert_allclose(float(a_t), float(a_j), rtol=1e-6)
    if sparsity == 1.0:  # idx >= n: max|w| + 1, nothing survives
        assert not wt_t.any()


@pytest.mark.parametrize("shape", [(30, 30), (128, 160)])
def test_duplicates_match_jax(shape):
    w = _weights(shape, seed=7, duplicates=True)
    thr_j, thr_t, wt_j, wt_t, a_j, a_t = _both(w, 0.3)
    assert thr_t.tobytes() == thr_j.tobytes()
    np.testing.assert_array_equal(wt_t, wt_j)
    np.testing.assert_allclose(float(a_t), float(a_j), rtol=1e-6)


# floor(float32(s) * float32(n)) differs from Python's int(s * n) here.
@pytest.mark.parametrize("sparsity,shape", [(0.57, (10, 10)),
                                            (0.29, (20, 20))])
def test_index_is_computed_in_float32(sparsity, shape):
    n = shape[0] * shape[1]
    assert int(np.floor(np.float32(sparsity) * np.float32(n))) \
        != int(sparsity * n)
    w = _weights(shape, seed=3)
    thr_j, thr_t, wt_j, wt_t, _, _ = _both(w, sparsity)
    assert thr_t.tobytes() == thr_j.tobytes()
    np.testing.assert_array_equal(wt_t, wt_j)


def test_traced_sparsity_tensor_matches_float():
    w = torch.from_numpy(_weights((64, 64), seed=5))
    a = tq.ternary_threshold(w, sparsity_target=0.4)
    b = tq.ternary_threshold(w, sparsity_target=torch.tensor(0.4))
    assert a.item() == b.item()


def test_large_tensors_route_to_order_statistic(monkeypatch):
    from atq_tpu_torch.ops import order_stat

    calls = []
    real = order_stat.order_statistic_reductions

    def spy(flat, rank):
        calls.append(flat.numel())
        return real(flat, rank)

    monkeypatch.setattr(order_stat, "order_statistic_reductions", spy)
    tq.ternary_threshold(torch.from_numpy(_weights((128, 128), seed=1)))
    tq.ternary_threshold(torch.from_numpy(_weights((127, 128), seed=1)))
    assert calls == [16384]  # 16,256 < 16,384 takes the sort


def test_caller_alpha_overrides_optimal():
    w = _weights((32, 32), seed=2)
    _, a = tq.adaptive_ternary_quantization(torch.from_numpy(w),
                                            alpha=torch.tensor([0.7]))
    assert float(a) == pytest.approx(0.7)


@pytest.mark.parametrize("shape", [(50, 40), (128, 200)])
def test_ttq_and_distribution_match_jax(shape):
    w = _weights(shape, seed=11)
    wp, wn = np.float32([0.061]), np.float32([0.043])
    got = tq.ternarize_ttq(torch.from_numpy(w), torch.from_numpy(wp),
                           torch.from_numpy(wn), sparsity_target=0.3)
    want = jq.ternarize_ttq(jnp.asarray(w), jnp.asarray(wp), jnp.asarray(wn),
                            sparsity_target=0.3)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))

    wt_t, _ = tq.ternarize_ste(torch.from_numpy(w))
    wt_j, _ = jq.ternarize_ste(jnp.asarray(w))
    np.testing.assert_array_equal(wt_t.numpy(), np.asarray(wt_j))
    dist_t = tq.ternary_distribution(wt_t)
    dist_j = jq.ternary_distribution(wt_j)
    for key in ("neg", "zero", "pos"):
        assert float(dist_t[key]) == pytest.approx(float(dist_j[key]),
                                                   rel=1e-6)


# --- backward rules (parity, STE, TTQ) against JAX's autodiff -------------

import jax  # noqa: E402


def _g(shape, seed):
    return np.random.RandomState(seed).randn(*shape).astype(np.float32)


@pytest.mark.parametrize("shape", [(40, 25), (128, 160)])
def test_ste_gradients_match_jax(shape):
    w, g = _weights(shape, seed=21), _g(shape, 22)
    alpha = np.float32([0.05])

    def jloss(w, a):
        wt, a = jq.ternarize_ste(w, alpha=a, sparsity_target=0.3)
        return jnp.sum(wt * a * g)

    want = jax.grad(jloss, argnums=(0, 1))(jnp.asarray(w),
                                           jnp.asarray(alpha))
    wt_, at_ = (torch.from_numpy(a).requires_grad_() for a in (w, alpha))
    pat, a = tq.ternarize_ste(wt_, alpha=at_, sparsity_target=0.3)
    (pat * a * torch.from_numpy(g)).sum().backward()
    np.testing.assert_allclose(wt_.grad.numpy(), np.asarray(want[0]),
                               rtol=1e-6, atol=1e-7)
    np.testing.assert_allclose(at_.grad.numpy(), np.asarray(want[1]),
                               rtol=1e-5)


@pytest.mark.parametrize("sparsity", [0.3, 1.0])
@pytest.mark.parametrize("shape", [(50, 40), (128, 200)])
def test_ttq_gradients_match_jax(shape, sparsity):
    """Mean-normalized scale gradients, scale-weighted straight-through
    weight gradients; sparsity 1.0 leaves both sides empty (max(count, 1)
    keeps the scale gradients at 0)."""
    w, g = _weights(shape, seed=31), _g(shape, 32)
    wp, wn = np.float32([0.061]), np.float32([0.043])

    def jloss(w, wp, wn):
        return jnp.sum(jq.ternarize_ttq(w, wp, wn, sparsity_target=sparsity)
                       * g)

    want = jax.grad(jloss, argnums=(0, 1, 2))(
        jnp.asarray(w), jnp.asarray(wp), jnp.asarray(wn))
    leaves = [torch.from_numpy(a).requires_grad_() for a in (w, wp, wn)]
    (tq.ternarize_ttq(*leaves, sparsity_target=sparsity)
     * torch.from_numpy(g)).sum().backward()
    for leaf, ref in zip(leaves, want):
        np.testing.assert_allclose(leaf.grad.numpy(), np.asarray(ref),
                                   rtol=1e-5, atol=1e-7)


def test_parity_gradients_match_jax():
    """Parity: no gradient through the pattern (JAX's exact zeros); with no
    alpha given, the optimal alpha stays differentiable in the weights."""
    w, g = _weights((64, 64), seed=41), _g((64, 64), 42)
    alpha = np.float32([0.05])

    def jloss(w, a):
        wt, a = jq.adaptive_ternary_quantization(w, alpha=a)
        return jnp.sum(wt * a * g)

    def jloss_opt(w):
        wt, a = jq.adaptive_ternary_quantization(w)
        return jnp.sum(wt * a * g)

    jw = jnp.asarray(w)
    want_w, want_a = jax.grad(jloss, argnums=(0, 1))(jw, jnp.asarray(alpha))
    assert not np.asarray(want_w).any()
    wt_, at_ = (torch.from_numpy(a).requires_grad_() for a in (w, alpha))
    pat, a = tq.adaptive_ternary_quantization(wt_, alpha=at_)
    (pat * a * torch.from_numpy(g)).sum().backward()
    assert wt_.grad is None  # torch's "no gradient" for JAX's zeros
    np.testing.assert_allclose(at_.grad.numpy(), np.asarray(want_a),
                               rtol=1e-5)

    wt2 = torch.from_numpy(w).requires_grad_()
    pat, a = tq.adaptive_ternary_quantization(wt2)
    (pat * a * torch.from_numpy(g)).sum().backward()
    np.testing.assert_allclose(wt2.grad.numpy(),
                               np.asarray(jax.grad(jloss_opt)(jw)),
                               rtol=1e-5, atol=1e-8)


def test_threshold_carries_no_gradient():
    w = torch.from_numpy(_weights((128, 128), seed=5)).requires_grad_()
    for s in (0.0, 0.3, 1.0):  # fallback, order statistic, all-zero
        assert not tq.ternary_threshold(w, sparsity_target=s).requires_grad
