"""The port's GradCache step (``--grad_accum_steps`` N > 1,
train/retrieval.py ``_gradcache_step``) on the CPU, at the JAX package's
small test widths (vocabulary 60, embed 32, FFN 64, images 32x32,
sequence 8; the model's text tower has 4 layers in both packages):

- against JAX's GradCache step from JAX's init (dropout 0, float images:
  no random draw): N = 2 at batch 8, with distillation and multi-positive
  InfoNCE, and N = 4 at batch 16 with both and ``--grad_checkpointing``
  (microbatches of 4: at 2 images a microbatch train-mode BatchNorm turns
  float32 rounding into gradients tens of percent apart in either
  package). The loss within 1e-4 relative, BatchNorm's running statistics
  after the step within 1e-4 in L2, and each gradient leaf within a
  group's tolerance of its own L2 norm, the leaves zero to rounding aside
  (at most 1e-6 of the model's largest). Readings (``python -m
  tests.test_torch_gradcache``, 1 and 8 threads) and limits: ResNet-18's
  leaves 1.95e-2 (limit 5e-2), one-element leaves (alphas, gates: a sum
  over a whole layer) 7.3e-2 (0.15), the other leaves 1.5e-4 (1e-3); the
  loss 1.2e-5, the running statistics 4.6e-6;
- against its own concatenated-pool oracle (the microbatches through the
  model one after another with the same generator, one autograd over the
  full-pool loss), with dropout 0.1, uint8 images (the flips drawn), and
  ``--grad_checkpointing`` or ``--use_amp``: every leaf within 1e-4 x
  (1 + its largest |gradient|) (tests/test_grad_accum.py's rule), the
  loss, the running statistics and the generator's state after the step
  equal;
- a batch that N does not divide raises ``ValueError``.
"""

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from atq_tpu.losses.contrastive import (
    ContrastiveLearningManager as JaxManager,
    HardNegativeMiningInfoNCE as JaxInfoNCE,
)
from atq_tpu.models.retrieval import ATQMultimodalRetrieval as JaxRetrieval
from atq_tpu.train import retrieval as jtrain
from atq_tpu_torch.data.augment import random_hflip
from atq_tpu_torch.losses.contrastive import HardNegativeMiningInfoNCE
from atq_tpu_torch.models.retrieval import ATQMultimodalRetrieval
from atq_tpu_torch.train import retrieval as ptrain
from atq_tpu_torch.utils.jax_interop import to_jax_variables

VOCAB, EMBED, HIDDEN, SIZE, SEQ = 60, 32, 64, 32, 8
LOSS_RTOL, STATS_RTOL, ROUNDING = 1e-4, 1e-4, 1e-6
LEAF_RTOL = {"trunk": 5e-2, "scalar": 0.15, "tensor": 1e-3}
ORACLE_ATOL = 1e-4
# (batch, N, distill, multi-positive, grad checkpointing)
CASES = {"n2": (8, 2, False, False, False),
         "n2_distill_multipositive": (8, 2, True, True, False),
         "n4_distill_multipositive_remat": (16, 4, True, True, True)}


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One torch thread: the suite runs several test processes on the
    machine's cores, and more threads each only contend (the readings
    above were taken at one thread)."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _np(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


def _leaves(tree, path=()):
    if isinstance(tree, dict):
        for k, v in tree.items():
            yield from _leaves(v, path + (k,))
    else:
        yield "/".join(path), np.asarray(tree)


def _jax_init():
    model = JaxRetrieval(vocab_size=VOCAB, embed_dim=EMBED,
                         hidden_dim=HIDDEN, use_residual=True,
                         max_seq_length=SEQ, dropout=0.0)
    sample = (jnp.zeros((2, SIZE, SIZE, 3)), jnp.zeros((2, SEQ), jnp.int32),
              jnp.asarray([4, 4], jnp.int32))
    return model, _np(jax.jit(model.init)(jax.random.PRNGKey(0), *sample))


@pytest.fixture(scope="module")
def jax_init():
    return _jax_init()


def _batch(n, multi_positive, uint8=False, seed=1):
    rng = np.random.RandomState(seed)
    images = (rng.randint(0, 256, (n, SIZE, SIZE, 3)).astype(np.uint8)
              if uint8 else rng.randn(n, SIZE, SIZE, 3).astype(np.float32))
    batch = (images, rng.randint(4, VOCAB, (n, SEQ)).astype(np.int32),
             rng.randint(2, SEQ + 1, n).astype(np.int32))
    if multi_positive:  # pairs of captions of one image
        batch += (np.repeat(np.arange(n // 2), 2).astype(np.int32),)
    return batch


def _baseline_embeds(n, distill):
    if not distill:
        return None
    rng = np.random.RandomState(2)
    return tuple(rng.randn(n, EMBED).astype(np.float32) for _ in range(2))


def _config(module, n_accum, multi_positive, remat):
    return module.RetrievalConfig(
        use_residual=True, embed_dim=EMBED, hidden_dim=HIDDEN,
        contrastive_reg=0.05, grad_accum_steps=n_accum,
        use_multi_positive=multi_positive, grad_checkpointing=remat)


def _capture():
    """An optax transformation that keeps the gradients in its state."""
    def update(u, s, p=None):
        return jax.tree_util.tree_map(jnp.zeros_like, u), {"g": u}

    return optax.GradientTransformation(
        lambda p: {"g": jax.tree_util.tree_map(jnp.zeros_like, p)}, update)


class _NoUpdate:
    def step(self):
        pass


def _jax_step(model, v, case):
    n, n_accum, distill, mp, remat = CASES[case]
    crit = JaxInfoNCE(temperature=0.07, lambda_reg=0.05)
    step = jtrain.build_retrieval_train_step(
        model, _capture(), crit, JaxManager(criterion=crit),
        _config(jtrain, n_accum, mp, remat))
    state = {"params": v["params"], "quant": v["quant"],
             "constants": v["constants"], "batch_stats": v["batch_stats"],
             "opt_state": _capture().init(v["params"]),
             "step": jnp.asarray(0, jnp.int32)}
    base = _baseline_embeds(n, distill)
    new, loss = jax.jit(step)(
        state, tuple(map(jnp.asarray, _batch(n, mp))), jnp.float32(0.07),
        jnp.int32(0), jax.random.PRNGKey(1),
        None if base is None else tuple(map(jnp.asarray, base)))
    return (float(loss), dict(_leaves(_np(new["opt_state"]["g"]))),
            dict(_leaves(_np(new["batch_stats"]))))


def _port_model(v=None, dropout=0.0, amp=False):
    model = ATQMultimodalRetrieval(
        vocab_size=VOCAB, embed_dim=EMBED, hidden_dim=HIDDEN,
        use_residual=True, max_seq_length=SEQ, dropout=dropout,
        compute_dtype=torch.bfloat16 if amp else None, device="cpu",
        generator=torch.Generator().manual_seed(4))
    if v is not None:
        model.load_jax_variables(v)
    return model


def _grads(model):
    sd = {**model.state_dict(),
          **{k: (p.grad if p.grad is not None else torch.zeros_like(p))
             for k, p in model.named_parameters()}}
    return dict(_leaves(to_jax_variables(sd)["params"]))


def _port_step(v, case):
    n, n_accum, distill, mp, remat = CASES[case]
    model = _port_model(v)
    step = ptrain.build_retrieval_train_step(
        model, _NoUpdate(),
        HardNegativeMiningInfoNCE(temperature=0.07, lambda_reg=0.05),
        _config(ptrain, n_accum, mp, remat))
    base = _baseline_embeds(n, distill)
    loss = step(ptrain._batch_to(_batch(n, mp), torch.device("cpu")),
                torch.tensor(0.07), torch.tensor(0),
                None if base is None else tuple(map(torch.from_numpy, base)))
    return (float(loss), _grads(model),
            dict(_leaves(model.jax_variables()["batch_stats"])))


def _group(name, grad):
    if name.startswith("image_encoder/base_model/"):
        return "trunk"
    return "scalar" if grad.size == 1 else "tensor"


def _readings(got, want):
    """The loss's relative difference, the running statistics' worst L2
    difference over their norm, and by leaf group the worst gradient leaf
    (L2 difference over its norm), leaves zero to rounding aside."""
    top = max(np.abs(g).max() for g in want[1].values())
    worst = {}
    for k, w in want[1].items():
        if np.abs(w).max() <= ROUNDING * top:
            continue
        r = float(np.linalg.norm(got[1][k] - w) / np.linalg.norm(w))
        g = _group(k, w)
        if r >= worst.get(g, ("", -1.0))[1]:
            worst[g] = (k, r)
    stats = max(float(np.linalg.norm(got[2][k] - w) / np.linalg.norm(w))
                for k, w in want[2].items())
    return {"loss": abs(got[0] - want[0]) / abs(want[0]),
            "batch_stats": stats, "leaves": worst}


@pytest.mark.parametrize("case", list(CASES))
def test_gradcache_matches_jax(jax_init, case):
    model, v = jax_init
    want = _jax_step(model, v, case)
    got = _port_step(v, case)
    assert sorted(got[1]) == sorted(want[1])
    r = _readings(got, want)
    assert r["loss"] <= LOSS_RTOL, r
    assert r["batch_stats"] <= STATS_RTOL, r
    for g, (k, err) in r["leaves"].items():
        assert err <= LEAF_RTOL[g], (k, r)


def _oracle(model, batch, cfg, generator, criterion, temperature, kind,
            baseline_embeds):
    """The concatenated-pool oracle: each microbatch through the model in
    turn (flips and dropout from ``generator`` as the step draws them), one
    autograd over the full-pool loss."""
    images, captions, lengths = batch[:3]
    micro = images.shape[0] // cfg.grad_accum_steps
    model.zero_grad(set_to_none=True)
    img, txt = [], []
    for i in range(cfg.grad_accum_steps):
        part = slice(i * micro, (i + 1) * micro)
        x = random_hflip(ptrain.normalize_images(images[part]), generator)
        ie, te = model(x, captions[part], lengths[part],
                       return_embeddings=True, train=True,
                       generator=generator)
        img.append(ie.float())
        txt.append(te.float())
    loss = ptrain.pool_loss(torch.cat(img), torch.cat(txt), temperature,
                            kind, baseline_embeds,
                            batch[3] if cfg.use_multi_positive else None,
                            cfg, criterion)
    loss.backward()
    return loss.detach()


@pytest.mark.parametrize("n_accum,remat,amp", [
    (2, False, False), (4, True, False), (2, False, True)],
    ids=["n2", "n4_remat", "n2_amp"])
def test_gradcache_matches_its_oracle(n_accum, remat, amp):
    batch = ptrain._batch_to(_batch(8, True, uint8=True),
                             torch.device("cpu"))
    base = tuple(map(torch.from_numpy, _baseline_embeds(8, True)))
    cfg = _config(ptrain, n_accum, True, remat)
    args = (torch.tensor(0.07), torch.tensor(1), base)
    out = {}
    for which in ("gradcache", "oracle"):
        model = _port_model(dropout=0.1, amp=amp)
        crit = HardNegativeMiningInfoNCE(temperature=0.07, lambda_reg=0.05)
        gen = torch.Generator().manual_seed(9)
        if which == "gradcache":
            loss = ptrain.build_retrieval_train_step(
                model, _NoUpdate(), crit, cfg, gen)(batch, *args)
        else:
            loss = _oracle(model, batch, cfg, gen, crit, *args)
        out[which] = (loss, _grads(model),
                      [b.clone() for b in ptrain._batchnorm_stats(model)],
                      gen.get_state())
    (l0, g0, s0, r0), (l1, g1, s1, r1) = out["gradcache"], out["oracle"]
    assert torch.equal(l0, l1)
    assert sorted(g0) == sorted(g1)
    for k, w in g1.items():
        np.testing.assert_allclose(g0[k], w, rtol=0, err_msg=k,
                                   atol=ORACLE_ATOL * (1 + np.abs(w).max()))
    assert all(torch.equal(a, b) for a, b in zip(s0, s1))
    assert torch.equal(r0, r1)


def test_indivisible_batch_raises():
    model = _port_model()
    step = ptrain.build_retrieval_train_step(
        model, _NoUpdate(), HardNegativeMiningInfoNCE(),
        _config(ptrain, 3, False, False))
    with pytest.raises(ValueError, match="not divisible"):
        step(ptrain._batch_to(_batch(8, False), torch.device("cpu")),
             torch.tensor(0.07), torch.tensor(0))


if __name__ == "__main__":
    # python -m tests.test_torch_gradcache: the readings behind the
    # tolerances, at 1 and 8 torch threads.
    import json

    jax.config.update("jax_platforms", "cpu")
    model, v = _jax_init()
    for case in CASES:
        want = _jax_step(model, v, case)
        for threads in (1, 8):
            torch.set_num_threads(threads)


            print(json.dumps({"case": case, "threads": threads,
                              **_readings(_port_step(v, case), want)}))
