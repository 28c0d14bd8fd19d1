"""The port's contrastive losses (losses/contrastive.py), the retrieval
loss of the train step (train/retrieval.py ``pool_loss``) and the R@K
metrics (train/retrieval_metrics.py) against atq_tpu's on the CPU.

Embeddings are drawn from numpy seeds. Their similarities are continuous
draws, so no two tie at the k-th place of a row or column: there
``jax.lax.top_k`` and ``torch.topk`` pick the same hard negatives (on a
tie they may not). Losses agree within rtol 1e-5 and gradients within
rtol 1e-4, atol 1e-6 (float32, different summation orders); the
temperature schedule and the metrics are exact.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from atq_tpu.losses import contrastive as jc
from atq_tpu.train import retrieval as jtrain
from atq_tpu.train import retrieval_metrics as jmetrics
from atq_tpu_torch.losses import contrastive as pc
from atq_tpu_torch.train import retrieval as ptrain
from atq_tpu_torch.train import retrieval_metrics as pmetrics

LOSS_RTOL = 1e-5
GRAD_RTOL, GRAD_ATOL = 1e-4, 1e-6


def _embeddings(seed, batch=8, dim=32):
    rng = np.random.RandomState(seed)
    return (rng.randn(batch, dim).astype(np.float32),
            rng.randn(batch, dim).astype(np.float32))


def _both(jax_fn, torch_fn, img, txt):
    """Value and gradients (w.r.t. both embeddings) of each side."""
    want, (gi, gt) = jax.value_and_grad(jax_fn, argnums=(0, 1))(
        jnp.asarray(img), jnp.asarray(txt))
    ti = torch.from_numpy(img).requires_grad_()
    tt = torch.from_numpy(txt).requires_grad_()
    got = torch_fn(ti, tt)
    got.backward()
    np.testing.assert_allclose(got.item(), float(want), rtol=LOSS_RTOL)
    np.testing.assert_allclose(ti.grad.numpy(), np.asarray(gi),
                               rtol=GRAD_RTOL, atol=GRAD_ATOL)
    np.testing.assert_allclose(tt.grad.numpy(), np.asarray(gt),
                               rtol=GRAD_RTOL, atol=GRAD_ATOL)
    return got.item()


@pytest.mark.parametrize("with_weights", [False, True])
@pytest.mark.parametrize("ratio", [0.5, 0.25])
def test_hard_negative_infonce_matches_jax(with_weights, ratio):
    img, txt = _embeddings(0)
    w = np.random.RandomState(1).uniform(0.2, 1.0, 8).astype(np.float32)
    kw = dict(temperature=0.07, lambda_reg=0.05, hard_negative_weight=0.5,
              hardest_mining_ratio=ratio)
    jl, pl = jc.HardNegativeMiningInfoNCE(**kw), pc.HardNegativeMiningInfoNCE(
        **kw)
    jw = jnp.asarray(w) if with_weights else None
    tw = torch.from_numpy(w) if with_weights else None
    _both(lambda a, b: jl(a, b, jw, temperature=0.1),
          lambda a, b: pl(a, b, tw, temperature=torch.tensor(0.1)), img, txt)


def test_hard_negatives_are_the_top_k_of_rows_and_columns():
    """The entropy term off and weight 1 on the hard negatives only: the
    loss moves exactly when the hard-negative weight does, on both
    sides."""
    img, txt = _embeddings(3)
    for hw in (0.0, 0.5, 2.0):
        kw = dict(lambda_reg=0.0, hard_negative_weight=hw)
        _both(lambda a, b: jc.HardNegativeMiningInfoNCE(**kw)(
                  a, b, temperature=0.07),
              lambda a, b: pc.HardNegativeMiningInfoNCE(**kw)(
                  a, b, temperature=torch.tensor(0.07)), img, txt)


def test_temperature_schedule_matches_jax():
    for total in (1, 2, 3, 10, 25):
        j = jc.HardNegativeMiningInfoNCE(temperature=0.07)
        p = pc.HardNegativeMiningInfoNCE(temperature=0.07)
        for epoch in range(total + 2):
            j.set_epoch(epoch, total)
            p.set_epoch(epoch, total)
            assert p.get_current_temperature() == j.get_current_temperature()
    fixed = pc.HardNegativeMiningInfoNCE(temperature=0.05,
                                         temperature_schedule=False)
    fixed.set_epoch(3, 10)
    assert fixed.get_current_temperature() == 0.05


def test_multi_positive_infonce_matches_jax():
    img, txt = _embeddings(5)
    ids = np.asarray([0, 0, 1, 2, 2, 2, 3, 4])
    mask = (ids[:, None] == ids[None, :]).astype(np.float32)
    mask[7] = 0.0  # a row with no positive contributes nothing
    jl = jc.MultiPositiveInfoNCE(temperature=0.07, lambda_reg=0.05)
    pl = pc.MultiPositiveInfoNCE(temperature=0.07, lambda_reg=0.05)
    _both(lambda a, b: jl(a, b, jnp.asarray(mask)),
          lambda a, b: pl(a, b, torch.from_numpy(mask)), img, txt)


def test_curriculum_stages_and_weights_match_jax():
    sim = np.random.RandomState(2).uniform(-1, 1, (6, 6)).astype(np.float32)
    for total in (3, 4, 10):
        jm = jc.ContrastiveLearningManager(criterion=None)
        pm = pc.ContrastiveLearningManager(criterion=None)
        for epoch in range(total):
            jm.set_epoch(epoch, total)
            pm.set_epoch(epoch, total)
            assert pm.curriculum_stage == jm.curriculum_stage
            assert pm.curriculum_kind() == jm.curriculum_kind()
            np.testing.assert_allclose(
                pm.get_curriculum_weight(torch.from_numpy(sim)).numpy(),
                np.asarray(jm.get_curriculum_weight(jnp.asarray(sim))),
                rtol=1e-6)
    for kind in (-1, 0, 1, 2, 5):  # clipped to [0, 2]
        np.testing.assert_allclose(
            pc.curriculum_weights_traced(torch.from_numpy(sim),
                                         torch.tensor(kind)).numpy(),
            np.asarray(jc.curriculum_weights_traced(jnp.asarray(sim),
                                                    jnp.int32(kind))),
            rtol=1e-6)


# (curriculum kind, distillation, multi-positive): both curriculum extremes,
# the uniform stage, the distillation blend and the multi-positive loss.
POOL_CASES = [(0, False, False), (2, False, False), (1, False, False),
              (0, True, False), (2, False, True)]


@pytest.mark.parametrize("kind,distill,multi", POOL_CASES)
def test_pool_loss_matches_jax(kind, distill, multi):
    """The train step's loss of the embeddings, the curriculum weights
    taken from the similarity WITH its gradient."""
    img, txt = _embeddings(7)
    base_img, base_txt = _embeddings(8)
    ids = np.asarray([0, 0, 1, 1, 2, 3, 3, 3])
    kw = dict(contrastive_reg=0.05, distill_weight=0.3,
              use_multi_positive=multi)
    jcfg, pcfg = jtrain.RetrievalConfig(**kw), ptrain.RetrievalConfig(**kw)
    jcrit = jc.HardNegativeMiningInfoNCE(lambda_reg=0.05)
    pcrit = pc.HardNegativeMiningInfoNCE(lambda_reg=0.05)
    jbase = (jnp.asarray(base_img), jnp.asarray(base_txt)) if distill \
        else None
    pbase = (torch.from_numpy(base_img), torch.from_numpy(base_txt)) \
        if distill else None
    _both(lambda a, b: jtrain.pool_loss(
              a, b, jnp.float32(0.0), jnp.float32(0.1), jnp.int32(kind),
              jbase, jnp.asarray(ids), jcfg, jcrit),
          lambda a, b: ptrain.pool_loss(
              a, b, torch.tensor(0.1), torch.tensor(kind), pbase,
              torch.from_numpy(ids), pcfg, pcrit), img, txt)


def test_curriculum_weights_keep_the_gradient():
    """Detaching the weights would change the gradient: the step's
    gradient differs from the one with detached weights."""
    img, txt = _embeddings(9)
    cfg = ptrain.RetrievalConfig()
    crit = pc.HardNegativeMiningInfoNCE()
    ti = torch.from_numpy(img).requires_grad_()
    tt = torch.from_numpy(txt)
    ptrain.pool_loss(ti, tt, torch.tensor(0.1), torch.tensor(0), None, None,
                     cfg, crit).backward()
    ti2 = torch.from_numpy(img).requires_grad_()
    from atq_tpu_torch.models.fusion import l2_normalize
    sim = (l2_normalize(ti2) @ l2_normalize(tt).T).detach()
    crit(ti2, tt, pc.curriculum_weights_traced(sim, 0),
         temperature=torch.tensor(0.1)).backward()
    assert not torch.allclose(ti.grad, ti2.grad, rtol=1e-4, atol=1e-6)


def test_retrieval_metrics_match_jax():
    rng = np.random.RandomState(4)
    img = rng.randn(12, 16).astype(np.float32)
    img = np.repeat(img[:4], 3, axis=0)  # each image 3 times, as pairs do
    txt = (img + 0.3 * rng.randn(12, 16)).astype(np.float32)
    sim = img @ txt.T
    assert pmetrics.compute_retrieval_metrics(sim) == \
        jmetrics.compute_retrieval_metrics(sim)
    assert pmetrics.compute_retrieval_metrics(sim[:, :7], topk=[1, 2]) == \
        jmetrics.compute_retrieval_metrics(sim[:, :7], topk=[1, 2])
    assert pmetrics.compute_retrieval_metrics_dedup(img, txt) == \
        jmetrics.compute_retrieval_metrics_dedup(img, txt)
    # The duplicated gallery: text-to-image R@1 is 0 by construction.
    assert pmetrics.compute_retrieval_metrics(img @ img.T)[
        "text_to_image_R@1"] == 0.0


def test_hard_example_mining_matches_jax():
    batches = [_embeddings(s, batch=6) for s in (10, 11, 12)]
    jm = jc.ContrastiveLearningManager(criterion=None,
                                       similarity_threshold=0.1)
    pm = pc.ContrastiveLearningManager(criterion=None,
                                       similarity_threshold=0.1)
    want = jm.mine_hard_examples(
        lambda b: (jnp.asarray(b[0]), jnp.asarray(b[1])), batches,
        max_examples=10)
    got = pm.mine_hard_examples(
        lambda b: (torch.from_numpy(b[0]), torch.from_numpy(b[1])), batches,
        max_examples=10)
    assert got == want and 0 < len(got) <= 10
