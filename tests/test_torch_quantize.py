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
