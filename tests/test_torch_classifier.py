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
