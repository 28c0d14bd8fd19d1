"""The port's feature stack and teacher start from flax's default init, as
the JAX models do (atq_tpu/models/image_classifier.py: nn.Conv, nn.Dense):
``lecun_normal`` weights (a normal truncated at ±2 stddev, stddev
``sqrt(1/fan_in)/0.8796…``) and zero biases.

The two frameworks draw different numbers, so the check is on the
distribution: biases exactly 0, no |value| past the truncation bound, and
each kernel's std within 5% of the JAX model's initialized kernel. Stds are
pooled over 8 seeds on each side (conv1 alone has 288 values, whose std a
single draw estimates only to about 4%).
"""

import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from atq_tpu.models.image_classifier import (
    ATQImageClassifier as JaxClassifier,
    BaselineCNNClassifier as JaxBaseline,
)
from atq_tpu_torch.models.image_classifier import (
    ATQImageClassifier,
    BaselineCNNClassifier,
)
from atq_tpu_torch.utils.jax_interop import to_jax_variables

IMAGE, HIDDEN, SEEDS = 8, 32, range(8)
# (collection path, fan_in) of every flax-initialized kernel.
CONV = {("features", "conv1"): 9, ("features", "conv2"): 9 * 32}
DENSE = {("fc1",): 64 * (IMAGE // 4) ** 2, ("fc2",): HIDDEN}


def _get(tree, path):
    for p in path:
        tree = tree[p]
    return tree


def _pooled(models, paths):
    out = {}
    for path in paths:
        out[path] = np.concatenate([
            np.asarray(_get(m["params"], path)["kernel"]).ravel()
            for m in models])
    return out


@pytest.fixture(scope="module")
def draws():
    x = jnp.zeros((2, IMAGE, IMAGE, 1))
    jax_atq = [JaxClassifier(hidden_size=HIDDEN).init(
        jax.random.PRNGKey(s), x) for s in SEEDS]
    jax_base = [JaxBaseline(hidden_size=HIDDEN).init(
        jax.random.PRNGKey(s), x) for s in SEEDS]
    port_atq, port_base = [], []
    for s in SEEDS:
        gen = torch.Generator().manual_seed(s)
        port_atq.append(to_jax_variables(ATQImageClassifier(
            hidden_size=HIDDEN, image_size=IMAGE, device="cpu",
            generator=gen).state_dict()))
        port_base.append(to_jax_variables(BaselineCNNClassifier(
            hidden_size=HIDDEN, image_size=IMAGE, device="cpu",
            generator=gen).state_dict()))
    return {
        "atq": (_pooled(jax_atq, CONV), _pooled(port_atq, CONV),
                port_atq),
        "base": (_pooled(jax_base, {**CONV, **DENSE}),
                 _pooled(port_base, {**CONV, **DENSE}), port_base),
    }


@pytest.mark.parametrize("model", ["atq", "base"])
def test_kernel_std_matches_jax_and_stays_truncated(draws, model):
    want, got, _ = draws[model]
    for path, values in got.items():
        fan_in = {**CONV, **DENSE}[path]
        ref = want[path]
        assert values.shape == ref.shape, path
        np.testing.assert_allclose(values.std(), ref.std(), rtol=0.05,
                                   err_msg=str(path))
        np.testing.assert_allclose(values.std(), math.sqrt(1.0 / fan_in),
                                   rtol=0.05, err_msg=str(path))
        bound = 2.0 * math.sqrt(1.0 / fan_in) / 0.87962566103423978
        assert np.abs(values).max() <= bound * (1 + 1e-6), path
        assert np.abs(ref).max() <= bound * (1 + 1e-6), path


@pytest.mark.parametrize("model", ["atq", "base"])
def test_conv_and_dense_biases_are_zero(draws, model):
    *_, variables = draws[model]
    paths = CONV if model == "atq" else {**CONV, **DENSE}
    for v in variables:
        for path in paths:
            assert not np.any(_get(v["params"], path)["bias"]), path
