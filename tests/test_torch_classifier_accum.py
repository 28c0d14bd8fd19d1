"""Classifier gradient accumulation (``--grad-accum-steps`` N > 1,
train/classifier.py ``accum_train_step``) against the JAX package's
``accum_train_step`` on the CPU: N microbatches, each the teacher's and
then the student's forward and backward from the pre-update parameters
(BatchNorm statistics threaded through them), the mean of their gradients,
one update per model.

Step 0 (KD + L1 + RPB, dropout 0, no augmentation; 16x16 inputs, a
32-unit hidden layer, batch 16), dense and with ``ATQ_FUSED=1`` on both
sides, N = 2 and 4, from one init carried across: the mean losses within
1e-5 relative, the correct counts equal, every gradient of both models
within rtol 1e-4 and an atol of 1e-5 times the model's largest |gradient|
(tests/test_torch_train.py's step-0 rule) and the running statistics after
the step within 1e-5. A batch that N does not divide raises ``ValueError``.
"""

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from atq_tpu.models.image_classifier import (
    ATQImageClassifier as JaxClassifier,
    BaselineCNNClassifier as JaxBaseline,
)
from atq_tpu.train import classifier as jtrain
from atq_tpu_torch.models.image_classifier import (
    ATQImageClassifier,
    BaselineCNNClassifier,
)
from atq_tpu_torch.train import classifier as ptrain
from atq_tpu_torch.utils.jax_interop import (
    from_jax_train_state,
    to_jax_variables,
)

IMAGE, HIDDEN, BATCH, L1 = 16, 32, 16, 2e-5
CFG = dict(use_rpb=True, distill=True, use_l1=True, clip_grad=True,
           epochs=20, device_augment=False)


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One torch thread: the suite runs several test processes on the
    machine's cores, and more threads each only contend."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _tree(t):
    return jax.tree_util.tree_map(np.asarray, t)


@pytest.fixture(scope="module")
def init():
    """JAX variables of both models with BatchNorm statistics and alpha
    off their init values (as tests/test_torch_train.py's)."""
    x = jnp.zeros((2, IMAGE, IMAGE, 1))
    atq = _tree(JaxClassifier(use_rpb=True, hidden_size=HIDDEN).init(
        jax.random.PRNGKey(0), x))
    base = _tree(JaxBaseline(hidden_size=HIDDEN).init(
        jax.random.PRNGKey(1), x))
    rng = np.random.RandomState(1)
    for v in (atq, base):
        for bn in ("bn1", "bn2"):
            s = v["batch_stats"]["features"][bn]
            s["mean"] = (rng.randn(*s["mean"].shape) * 0.1).astype(np.float32)
            s["var"] = rng.uniform(0.5, 1.5, s["var"].shape).astype(
                np.float32)
    for layer in ("classifier_0", "classifier_3"):
        atq["params"][layer]["alpha"] = np.full((1,), 0.05, np.float32)
        atq["quant"][layer]["sparsity_target"] = np.float32(0.05)
    return {"atq_params": atq["params"], "quant": atq["quant"],
            "atq_batch_stats": atq["batch_stats"],
            "base_params": base["params"],
            "base_batch_stats": base["batch_stats"]}


def _batch(seed=0):
    rng = np.random.RandomState(seed)
    return (rng.randn(BATCH, IMAGE, IMAGE, 1).astype(np.float32),
            rng.randint(0, 10, BATCH).astype(np.int32))


def _capture():
    """An optax transformation that keeps the gradients in its state."""
    def update(u, s, p=None):
        return jax.tree_util.tree_map(jnp.zeros_like, u), {"g": u}

    return optax.GradientTransformation(
        lambda p: {"g": jax.tree_util.tree_map(jnp.zeros_like, p)}, update)


class _NoUpdate:
    def step(self):
        pass


def _port_models(state):
    atq_sd, base_sd = from_jax_train_state(state)
    atq = ATQImageClassifier(use_rpb=True, hidden_size=HIDDEN,
                             dropout_rate=0.0, image_size=IMAGE,
                             device="cpu")
    base = BaselineCNNClassifier(hidden_size=HIDDEN, dropout_rate=0.0,
                                 image_size=IMAGE, device="cpu")
    atq.load_state_dict(atq_sd)
    base.load_state_dict(base_sd)
    atq.train()
    base.train()
    return atq, base


def _grads(model):
    sd = {**model.state_dict(),
          **{k: (p.grad if p.grad is not None else torch.zeros_like(p))
             for k, p in model.named_parameters()}}
    return to_jax_variables(sd)


def _assert_close(got, want, rtol, atol_scale, what):
    flat_w = jax.tree_util.tree_leaves_with_path(want)
    flat_g = {str(k): a for k, a in jax.tree_util.tree_leaves_with_path(got)}
    assert len(flat_g) == len(flat_w), what
    scale = max(1.0, max(np.abs(a).max() for _, a in flat_w)) \
        if atol_scale else 1.0
    for k, a in flat_w:
        np.testing.assert_allclose(flat_g[str(k)], a, rtol=rtol,
                                   atol=(atol_scale or 1e-5) * scale,
                                   err_msg=f"{what} {k}")


@pytest.mark.parametrize("n_accum", [2, 4])
@pytest.mark.parametrize("fused", [False, True], ids=["dense", "fused"])
def test_accum_step_matches_jax(init, monkeypatch, fused, n_accum):
    monkeypatch.setenv("ATQ_FUSED", "1" if fused else "0")
    images, labels = _batch()
    step = jax.jit(jtrain.build_train_step(
        JaxClassifier(use_rpb=True, hidden_size=HIDDEN, dropout_rate=0.0),
        JaxBaseline(hidden_size=HIDDEN, dropout_rate=0.0), _capture(),
        _capture(), jtrain.ClassifierConfig(**CFG,
                                            grad_accum_steps=n_accum)))
    state = {**init, "step": jnp.asarray(0, jnp.int32),
             "atq_opt_state": _capture().init(init["atq_params"]),
             "base_opt_state": _capture().init(init["base_params"])}
    new, m = step(state, (jnp.asarray(images), jnp.asarray(labels)),
                  jnp.float32(0.05), jnp.float32(L1), jax.random.PRNGKey(0))

    atq, base = _port_models(init)
    pstep = ptrain.build_train_step(
        atq, base, _NoUpdate(), _NoUpdate(),
        ptrain.ClassifierConfig(**CFG, grad_accum_steps=n_accum))
    pm = pstep(torch.from_numpy(images), torch.from_numpy(labels).long(), L1)
    for key in ("loss", "base_loss"):
        np.testing.assert_allclose(float(pm[key]), float(m[key]), rtol=1e-5,
                                   err_msg=key)
    for key in ("atq_correct", "base_correct"):
        assert int(pm[key]) == int(m[key]), key
    for name, model in (("atq", atq), ("base", base)):
        got = _grads(model)
        _assert_close(got["params"], _tree(new[f"{name}_opt_state"]["g"]),
                      1e-4, 1e-5, f"{name} gradient")
        _assert_close(got["batch_stats"], _tree(new[f"{name}_batch_stats"]),
                      1e-5, None, f"{name} batch_stats")


def test_accum_indivisible_batch_raises(init):
    atq, base = _port_models(init)
    step = ptrain.build_train_step(
        atq, base, _NoUpdate(), _NoUpdate(),
        ptrain.ClassifierConfig(**CFG, grad_accum_steps=3))
    images, labels = _batch()
    with pytest.raises(ValueError, match="not divisible"):
        step(torch.from_numpy(images), torch.from_numpy(labels).long(), L1)
