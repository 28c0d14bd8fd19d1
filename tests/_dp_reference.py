"""The JAX side of the retrieval scale-out tests: the JAX package's
retrieval step jitted on a dp=2 mesh of the conftest's virtual CPU devices
(the state replicated, the global batch sharded over 'data', as
atq_tpu/train/retrieval.py places them), its init, and the comparisons.
The port's ranks run in tests/_torch_dist.py.
"""

import jax
import jax.numpy as jnp
import numpy as np

from atq_tpu.losses.contrastive import (
    ContrastiveLearningManager as JaxManager,
    HardNegativeMiningInfoNCE as JaxInfoNCE,
)
from atq_tpu.models.retrieval import ATQMultimodalRetrieval as JaxRetrieval
from atq_tpu.parallel.mesh import make_mesh, replicate, shard_batch
from atq_tpu.train import retrieval as jtrain

VOCAB, EMBED, HIDDEN, SIZE, SEQ, BATCH = 60, 32, 64, 32, 8, 8
# Each leaf's step-0 gradient within GRAD_RTOL of its own L2 norm
# (tests/test_torch_retrieval_train.py's limit against JAX) plus ENVELOPE
# times the leaf's own sensitivity: how far the port's one-process gradient
# moves when the images are scaled by 1 + 1e-6 (tests/test_torch_train.py
# bounds its trajectory by such an envelope). At this init a few ResNet
# leaves move 1.1 % of their norm under that perturbation (layer2_0's bn1
# bias and conv1 kernel, layer1's bn2 biases: leaves whose gradient nearly
# cancels), so float reassociation alone moves them that far; every other
# leaf moves less than 1e-3. The port's dp=2 step reads up to 1.3e-3
# against its dp=1 step on the other leaves (the alphas). A leaf whose
# gradient is zero to rounding (at most ROUNDING of the largest) is not
# held.
GRAD_RTOL, ROUNDING, LOSS_RTOL, ENVELOPE = 5e-3, 1e-6, 1e-5, 10.0
PERTURB = 1e-6
CFG = dict(batch_size=BATCH, image_size=SIZE, embed_dim=EMBED,
           hidden_dim=HIDDEN, use_residual=True, max_seq_length=SEQ,
           epochs=10, learning_rate=5e-5, contrastive_reg=0.05,
           clip_grad=True)
MODEL = dict(vocab_size=VOCAB, embed_dim=EMBED, hidden_dim=HIDDEN,
             use_residual=True, max_seq_length=SEQ)
TEMPERATURE = 0.14


def tree_np(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


def jax_init(dropout=0.0, **kw):
    """The JAX model and one init for both packages: the port's, seeded,
    in the JAX layout (a flax init would take 14 s to compile here)."""
    import torch

    from atq_tpu_torch.models.retrieval import ATQMultimodalRetrieval

    model = JaxRetrieval(**MODEL, dropout=dropout, **kw)
    port_kw = {k: kw[k] for k in ("text_moe_experts", "text_scan_layers")
               if k in kw}
    port = ATQMultimodalRetrieval(
        device="cpu", generator=torch.Generator().manual_seed(0), **MODEL,
        **port_kw)
    return model, port.jax_variables()


def batch(seed=11, full_length=False, uint8=False):
    rng = np.random.RandomState(seed)
    images = (rng.randint(0, 256, (BATCH, SIZE, SIZE, 3)).astype(np.uint8)
              if uint8 else
              rng.randn(BATCH, SIZE, SIZE, 3).astype(np.float32))
    lengths = (np.full(BATCH, SEQ, np.int32) if full_length else
               rng.randint(2, SEQ + 1, BATCH).astype(np.int32))
    return (images, rng.randint(4, VOCAB, (BATCH, SEQ)).astype(np.int32),
            lengths)


def _adam_mu(opt_state):
    if hasattr(opt_state, "mu"):
        return opt_state.mu
    for part in opt_state if isinstance(opt_state, tuple) else ():
        found = _adam_mu(part)
        if found is not None:
            return found
    return None


def jax_mesh_step(model, v, batch_, cfg):
    """JAX's step 0 on a dp=2 mesh: ``(loss, gradient (Adam's first moment
    over 0.1), batch_stats)``."""
    cfg = jtrain.RetrievalConfig(**cfg)
    tx = jtrain.make_retrieval_optimizer(cfg, 6)
    crit = JaxInfoNCE(temperature=0.07, lambda_reg=0.05)
    step = jax.jit(jtrain.build_retrieval_train_step(
        model, tx, crit, JaxManager(criterion=crit), cfg))
    mesh = make_mesh(dp=2, devices=jax.devices()[:2])
    state = replicate({"params": v["params"], "quant": v["quant"],
                       "constants": v["constants"],
                       "batch_stats": v["batch_stats"],
                       "opt_state": tx.init(v["params"]),
                       "step": jnp.asarray(0, jnp.int32)}, mesh)
    jb = shard_batch(tuple(jnp.asarray(a) for a in batch_), mesh)
    state, loss = step(state, jb, jnp.float32(TEMPERATURE), jnp.int32(0),
                       jax.random.PRNGKey(1), None)
    mu = tree_np(_adam_mu(state["opt_state"]))
    return {"loss": float(loss),
            "grads": jax.tree_util.tree_map(lambda m: m / 0.1, mu),
            "batch_stats": tree_np(state["batch_stats"])}


def leaves(tree, path=()):
    if isinstance(tree, dict):
        for k, v in tree.items():
            yield from leaves(v, path + (k,))
    else:
        yield "/".join(path), np.asarray(tree)


def grad_errors(got, want, envelope=None):
    """``{leaf: error / limit}`` over the leaves of ``want`` above rounding:
    the L2 error against ``GRAD_RTOL`` of the leaf's norm plus ``ENVELOPE``
    times its sensitivity (the L2 change between the two gradients of
    ``envelope``, a one-process step and the same on perturbed images)."""
    g, w = dict(leaves(got)), dict(leaves(want))
    assert sorted(g) == sorted(w)
    top = max(np.linalg.norm(a) for a in w.values())
    moved = {}
    if envelope is not None:
        a, b = (dict(leaves(e["grads"])) for e in envelope)
        moved = {k: np.linalg.norm(a[k] - b[k]) for k in a}
    return {k: np.linalg.norm(g[k] - x) / (
        GRAD_RTOL * np.linalg.norm(x) + ENVELOPE * moved.get(k, 0.0))
        for k, x in w.items() if np.linalg.norm(x) > ROUNDING * top}


def assert_step_like(got, want, what, envelope=None):
    """The loss within ``LOSS_RTOL``, every gradient leaf within its limit
    (:func:`grad_errors`) and the BatchNorm statistics within 1e-4."""
    np.testing.assert_allclose(got["loss"], want["loss"], rtol=LOSS_RTOL,
                               err_msg=what)
    worst = max(grad_errors(got["grads"], want["grads"], envelope).items(),
                key=lambda kv: kv[1])
    assert worst[1] <= 1.0, f"{what}: gradient {worst} (error / limit)"
    g, w = dict(leaves(got["batch_stats"])), dict(leaves(want["batch_stats"]))
    assert sorted(g) == sorted(w)
    for k, a in w.items():
        np.testing.assert_allclose(g[k], a, rtol=1e-4, atol=1e-5,
                                   err_msg=f"{what} batch_stats {k}")


def perturbed(batch_):
    """The batch with its float images scaled by 1 + PERTURB."""
    return (batch_[0] * np.float32(1 + PERTURB),) + tuple(batch_[1:])


def spec(variables, batch_, model=None, cfg=None, **kw):
    """A tests/_torch_dist.py ``retrieval_step`` spec."""
    return {"model": {**MODEL, "dropout": 0.0, **(model or {})},
            "variables": variables, "batch": batch_,
            "cfg": {**CFG, **(cfg or {})}, "temperature": TEMPERATURE, **kw}
