"""Port classifier (atq_tpu_torch.models.image_classifier) and packed export
(atq_tpu_torch.serve.packed_model) against the JAX package on the CPU.

A JAX ``ATQImageClassifier`` init (with its BatchNorm statistics, scales
and biases moved off their init values) is carried into the port with
``from_jax_variables``, and both run the same seeded numpy images. Small
size: 8x8 inputs give 256 features, and a 64-unit hidden layer gives
64 x 256 = 16,384 head weights, the smallest size that takes the
order-statistic path. Forwards agree to rtol 1e-5 / atol 1e-5; exported
planes are byte-identical and the ELL/COO corrections equal.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from atq_tpu.models.image_classifier import (
    ATQImageClassifier as JaxClassifier,
)
from atq_tpu.serve.packed_model import (
    export_packed_collection as jax_export_packed_collection,
)
from atq_tpu_torch.models.image_classifier import ATQImageClassifier
from atq_tpu_torch.serve.packed_model import (
    attach_packed_collection,
    export_packed_collection,
    packed_collection_bytes,
)
from atq_tpu_torch.utils.jax_interop import (
    from_jax_variables,
    to_jax_variables,
)

IMAGE, HIDDEN = 8, 64
CONFIGS = [(True, "parity"), (False, "parity"), (True, "ttq"),
           (False, "ttq"), (True, "ste")]
_CACHE = {}


def _numpy_tree(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


def _jax_variables(use_rpb, grad_mode):
    """A JAX init with every value the forward reads moved off its init."""
    key = (use_rpb, grad_mode)
    if key in _CACHE:
        return _CACHE[key]
    model = JaxClassifier(use_rpb=use_rpb, hidden_size=HIDDEN,
                          grad_mode=grad_mode)
    v = _numpy_tree(model.init(jax.random.PRNGKey(0),
                               jnp.zeros((2, IMAGE, IMAGE, 1))))
    rng = np.random.RandomState(1)
    v = jax.tree_util.tree_map(lambda a: a.copy(), v)
    for bn in ("bn1", "bn2"):
        stats = v["batch_stats"]["features"][bn]
        stats["mean"] = (rng.randn(*stats["mean"].shape) * 0.1).astype(
            np.float32)
        stats["var"] = rng.uniform(0.5, 1.5, stats["var"].shape).astype(
            np.float32)
        p = v["params"]["features"][bn]
        p["scale"] = rng.uniform(0.8, 1.2, p["scale"].shape).astype(
            np.float32)
        p["bias"] = (rng.randn(*p["bias"].shape) * 0.1).astype(np.float32)
    for layer in ("classifier_0", "classifier_3"):
        p = v["params"][layer]
        p["alpha"] = np.full((1,), 0.05, np.float32)
        if "wp" in p:
            p["wp"] = (p["wp"] * 1.3).astype(np.float32)
            p["wn"] = (p["wn"] * 0.8).astype(np.float32)
        if use_rpb:
            v["quant"][layer]["sparsity_target"] = np.float32(0.4)
    _CACHE[key] = (model, v)
    return model, v


def _images(n=5, seed=2):
    return np.random.RandomState(seed).randn(n, IMAGE, IMAGE, 1).astype(
        np.float32)


def _port_model(use_rpb, grad_mode, v):
    model = ATQImageClassifier(use_rpb=use_rpb, hidden_size=HIDDEN,
                               grad_mode=grad_mode, image_size=IMAGE,
                               device="cpu")
    model.load_state_dict(from_jax_variables(v))
    return model


@pytest.mark.parametrize("use_rpb,grad_mode", CONFIGS)
def test_dense_forward_matches_jax(use_rpb, grad_mode):
    jmodel, v = _jax_variables(use_rpb, grad_mode)
    x = _images()
    want = np.asarray(jmodel.apply(v, jnp.asarray(x), train=False))
    model = _port_model(use_rpb, grad_mode, v)
    with torch.inference_mode():
        got = model(torch.from_numpy(x)).numpy()
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("use_rpb,grad_mode", [(True, "parity"),
                                               (True, "ttq")])
def test_state_dict_round_trips_through_jax_layout(use_rpb, grad_mode):
    _, v = _jax_variables(use_rpb, grad_mode)
    back = to_jax_variables(_port_model(use_rpb, grad_mode, v).state_dict())
    flat_v = dict(jax.tree_util.tree_leaves_with_path(v))
    flat_b = dict(jax.tree_util.tree_leaves_with_path(back))
    assert set(map(str, flat_v)) == set(map(str, flat_b))
    by_name = {str(k): a for k, a in flat_b.items()}
    for k, a in flat_v.items():
        np.testing.assert_array_equal(by_name[str(k)], a)


@pytest.mark.parametrize("use_rpb,grad_mode", [(True, "parity"),
                                               (True, "ttq"),
                                               (False, "parity")])
def test_packed_export_and_forward_match_jax(use_rpb, grad_mode):
    jmodel, v = _jax_variables(use_rpb, grad_mode)
    pk_j = jax_export_packed_collection(v["params"], v.get("quant"))
    pk_t = export_packed_collection(v["params"], v.get("quant"),
                                    device="cpu")
    assert set(pk_t) == set(pk_j) == {"classifier_0", "classifier_3"}
    for layer in pk_t:
        ej, et = pk_j[layer]["entry"], pk_t[layer]["entry"]
        assert set(et) == set(ej)
        assert tuple(et["shape"]) == tuple(ej["shape"])
        np.testing.assert_array_equal(et["packed"].numpy(),
                                      np.asarray(ej["packed"]))
        for name in ("alpha", "alpha_neg", "bias"):
            if name in ej:
                np.testing.assert_array_equal(et[name].numpy(),
                                              np.asarray(ej[name]))
        for name in ("corr_idx", "coo_row", "coo_col"):
            if name in ej:
                np.testing.assert_array_equal(
                    et[name].numpy(), np.asarray(ej[name]).astype(np.int64))
        for name in ("corr_val", "coo_val"):
            if name in ej:
                np.testing.assert_array_equal(
                    et[name].float().numpy(),
                    np.asarray(ej[name].astype(jnp.float32)))
    assert use_rpb == ("corr_idx" in pk_t["classifier_0"]["entry"])
    assert packed_collection_bytes(pk_t) > 0

    x = _images(seed=3)
    want = np.asarray(jmodel.apply({**v, "packed": pk_j}, jnp.asarray(x),
                                   train=False))
    model = _port_model(use_rpb, grad_mode, v)
    attach_packed_collection(model, pk_t)
    with torch.inference_mode():
        got = model(torch.from_numpy(x)).numpy()
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-5)


def test_seeded_init_is_reproducible():
    def build():
        return ATQImageClassifier(hidden_size=HIDDEN, image_size=IMAGE,
                                  device="cpu",
                                  generator=torch.Generator().manual_seed(4))

    a, b = build().state_dict(), build().state_dict()
    for k in a:
        assert torch.equal(a[k], b[k]), k
    mask = a["classifier_0.precision_mask"]
    assert mask.dtype == torch.bool
    assert int(mask.sum()) == int(0.05 * mask.numel())


# --- train mode: batch statistics, dropout, gradients, the teacher --------

from atq_tpu.models.image_classifier import (  # noqa: E402
    BaselineCNNClassifier as JaxBaseline,
)
from atq_tpu.nn.layers import (  # noqa: E402
    selective_gradient_routing as jax_routing,
)
from atq_tpu_torch.models.image_classifier import (  # noqa: E402
    BaselineCNNClassifier,
)
from atq_tpu_torch.nn.layers import selective_gradient_routing  # noqa: E402

GRAD_TOL = dict(rtol=1e-4, atol=1e-5)


def _jax_train_step(model, v, x, g):
    """Logits, new batch stats and d(Σ logits·g)/d(params), train mode."""
    def loss(params):
        logits, mut = model.apply({**v, "params": params}, jnp.asarray(x),
                                  train=True, mutable=["batch_stats"])
        return jnp.sum(logits * g), (logits, mut["batch_stats"])

    (_, (logits, stats)), grads = jax.value_and_grad(loss, has_aux=True)(
        v["params"])
    return np.asarray(logits), _numpy_tree(stats), _numpy_tree(grads)


def _port_train_step(model, x, g):
    model.train()
    logits = model(torch.from_numpy(x))
    (logits * torch.from_numpy(g)).sum().backward()
    grads = {k: (p.grad if p.grad is not None else torch.zeros_like(p))
             for k, p in model.named_parameters()}
    sd = {**{k: v for k, v in model.state_dict().items()}, **grads}
    return logits.detach().numpy(), to_jax_variables(sd)


def _assert_tree_close(got, want, **tol):
    flat_w = dict(jax.tree_util.tree_leaves_with_path(want))
    flat_g = {str(k): a for k, a in jax.tree_util.tree_leaves_with_path(got)}
    assert len(flat_w) == len(flat_g)
    for k, a in flat_w.items():
        np.testing.assert_allclose(flat_g[str(k)], np.asarray(a),
                                   err_msg=str(k), **tol)


@pytest.mark.parametrize("use_rpb,grad_mode", [(True, "parity"),
                                               (False, "parity"),
                                               (True, "ste")])
def test_train_forward_stats_and_grads_match_jax(use_rpb, grad_mode):
    """Dropout 0 on both sides: logits, the BatchNorm running statistics
    after the step (flax: biased batch variance), and every gradient."""
    _, v = _jax_variables(use_rpb, grad_mode)
    jmodel = JaxClassifier(use_rpb=use_rpb, hidden_size=HIDDEN,
                           grad_mode=grad_mode, dropout_rate=0.0)
    x = _images(n=6, seed=4)
    g = np.random.RandomState(5).randn(6, 10).astype(np.float32)
    want_logits, want_stats, want_grads = _jax_train_step(jmodel, v, x, g)

    model = ATQImageClassifier(use_rpb=use_rpb, hidden_size=HIDDEN,
                               grad_mode=grad_mode, dropout_rate=0.0,
                               image_size=IMAGE, device="cpu")
    model.load_state_dict(from_jax_variables(v))
    got_logits, got = _port_train_step(model, x, g)
    np.testing.assert_allclose(got_logits, want_logits, rtol=1e-5, atol=1e-5)
    _assert_tree_close(got["batch_stats"], want_stats, rtol=1e-5, atol=1e-6)
    _assert_tree_close(got["params"], want_grads, **GRAD_TOL)


def test_batchnorm_running_var_is_biased_like_flax():
    """nn.BatchNorm2d would move running_var towards the unbiased batch
    variance: a factor n/(n−1), which a 2-image 8x8 batch (n = 128 per
    channel) shows far past the tolerance."""
    _, v = _jax_variables(True, "parity")
    jmodel = JaxClassifier(use_rpb=True, hidden_size=HIDDEN, dropout_rate=0.0)
    x = _images(n=2, seed=6)
    g = np.ones((2, 10), np.float32)
    _, want_stats, _ = _jax_train_step(jmodel, v, x, g)
    model = _port_model(True, "parity", v)
    model.train()
    with torch.no_grad():
        h = model.features.conv1(torch.from_numpy(x).permute(0, 3, 1, 2))
        model(torch.from_numpy(x))
    got = model.features.bn1.running_var.numpy()
    want = want_stats["features"]["bn1"]["var"]
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-6)
    old = v["batch_stats"]["features"]["bn1"]["var"]
    unbiased = 0.9 * old + 0.1 * h.var(dim=(0, 2, 3), correction=1).numpy()
    assert not np.allclose(unbiased, want, rtol=1e-5, atol=1e-6)


def test_baseline_teacher_matches_jax():
    jmodel = JaxBaseline(hidden_size=HIDDEN, dropout_rate=0.0)
    v = _numpy_tree(jmodel.init(jax.random.PRNGKey(3),
                                jnp.zeros((2, IMAGE, IMAGE, 1))))
    rng = np.random.RandomState(7)
    v = jax.tree_util.tree_map(
        lambda a: (a + rng.randn(*a.shape).astype(np.float32) * 0.01)
        if a.dtype == np.float32 else a, v)
    v["batch_stats"] = jax.tree_util.tree_map(np.abs, v["batch_stats"])
    x = _images(n=5, seed=8)
    g = rng.randn(5, 10).astype(np.float32)
    model = BaselineCNNClassifier(hidden_size=HIDDEN, dropout_rate=0.0,
                                  image_size=IMAGE, device="cpu")
    model.load_state_dict(from_jax_variables(v))
    with torch.inference_mode():
        np.testing.assert_allclose(
            model(torch.from_numpy(x)).numpy(),
            np.asarray(jmodel.apply(v, jnp.asarray(x))), rtol=1e-5,
            atol=1e-5)
    want_logits, want_stats, want_grads = _jax_train_step(jmodel, v, x, g)
    got_logits, got = _port_train_step(model, x, g)
    np.testing.assert_allclose(got_logits, want_logits, rtol=1e-5, atol=1e-5)
    _assert_tree_close(got["batch_stats"], want_stats, rtol=1e-5, atol=1e-6)
    _assert_tree_close(got["params"], want_grads, **GRAD_TOL)


def test_dropout_keeps_and_scales_like_flax():
    model = ATQImageClassifier(use_rpb=True, hidden_size=HIDDEN,
                               image_size=IMAGE, device="cpu",
                               generator=torch.Generator().manual_seed(0))
    assert model.dropout_rate == 0.3
    h = torch.ones(4000, 50)
    from atq_tpu_torch.models.image_classifier import _dropout

    out = _dropout(h, 0.3, True, torch.Generator().manual_seed(1))
    kept = out != 0
    assert abs(kept.float().mean().item() - 0.7) < 0.01
    assert torch.allclose(out[kept], torch.full_like(out[kept], 1 / 0.7))
    again = _dropout(h, 0.3, True, torch.Generator().manual_seed(1))
    assert torch.equal(out, again)
    assert torch.equal(_dropout(h, 0.3, False, None), h)


def test_selective_gradient_routing_matches_jax():
    x = np.random.RandomState(9).randn(4, 30).astype(np.float32)
    g = np.random.RandomState(10).randn(4, 30).astype(np.float32)
    for importance in (0.3, 0.7, 0.0):
        want = np.asarray(jax.grad(lambda a: jnp.sum(
            jax_routing(a, importance_factor=importance) * g))(
                jnp.asarray(x)))
        xt = torch.from_numpy(x).requires_grad_()
        y = selective_gradient_routing(xt, importance_factor=importance)
        assert torch.equal(y.detach(), xt.detach())
        (y * torch.from_numpy(g)).sum().backward()
        np.testing.assert_array_equal(xt.grad.numpy(), want)
