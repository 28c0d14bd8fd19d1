"""The port's ResNet backbone (models/resnet.py) and int8 trunk
(serve/int8_trunk.py) against atq_tpu's on the CPU.

- ResNet-18 (BasicBlock) and a small Bottleneck stack in eval mode, with
  drawn BatchNorm statistics: features within 1e-4 of flax's.
- The int8 trunk: the exported int8 kernels and the folded scales and
  biases are bit-exact; every conv's integer products equal JAX's int32
  convolution exactly (the port multiplies the same integers in float64 on
  the CPU); the features agree within 1e-5 (measured on the CPU:
  bit-identical at both sizes here). ``ATQ_INT8_DEQUANT=1`` stays within
  1e-4 of the int8 path, as in JAX's own test.
- ``ATQ_S2D_STEM=1`` and ``ATQ_FAST_POOL=1``: the features against flax's
  under the same flag (1e-4) and against the default path (1e-5).
"""

import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from atq_tpu.models.resnet import (
    BasicBlock as JaxBasic,
    Bottleneck as JaxBottleneck,
    ResNetFeatures as JaxResNet,
)
from atq_tpu.serve.int8_trunk import (
    _quantize_weight as jax_quantize_weight,
    export_int8_collection as jax_export_int8_collection,
    int8_collection_bytes as jax_int8_collection_bytes,
)
from atq_tpu_torch.models.resnet import (
    BasicBlock,
    Bottleneck,
    ResNetFeatures,
)
from atq_tpu_torch.serve import int8_trunk
from atq_tpu_torch.utils.jax_interop import from_jax_variables

CASES = {"resnet18": ((2, 2, 2, 2), JaxBasic, BasicBlock, 64),
         "bottleneck": ((1, 1), JaxBottleneck, Bottleneck, 8)}


def _draw_stats(tree, rng):
    """BatchNorm statistics and affine parameters away from the init, so
    that the fold and the eval normalisation do real work."""
    def walk(node):
        out = {}
        for k, v in node.items():
            if isinstance(v, dict):
                out[k] = walk(v)
            elif k == "mean":
                out[k] = (rng.randn(*v.shape) * 0.1).astype(np.float32)
            elif k == "var":
                out[k] = rng.uniform(0.5, 1.5, v.shape).astype(np.float32)
            else:
                out[k] = np.asarray(v)
        return out
    return walk(tree)


@pytest.fixture(scope="module", params=sorted(CASES))
def trunk(request):
    stages, jblock, pblock, width = CASES[request.param]
    model = JaxResNet(stage_sizes=stages, block=jblock, width=width)
    rng = np.random.RandomState(0)
    x = rng.randn(3, 32, 32, 3).astype(np.float32)
    v = jax.jit(model.init)(jax.random.PRNGKey(0), jnp.asarray(x))
    v = {"params": jax.tree_util.tree_map(np.asarray, v["params"]),
         "batch_stats": _draw_stats(v["batch_stats"], rng)}
    port = ResNetFeatures(stages, pblock, width=width, device="cpu")
    port.load_state_dict(from_jax_variables(v))
    return model, v, port, x, stages, pblock is Bottleneck


def test_eval_features_match_jax(trunk):
    model, v, port, x, _, _ = trunk
    want = np.asarray(model.apply(v, jnp.asarray(x), train=False))
    with torch.no_grad():
        got = port(torch.from_numpy(x)).numpy()
    assert got.shape == want.shape
    np.testing.assert_allclose(got, want, rtol=1e-4, atol=1e-4)


def test_int8_export_is_bit_exact(trunk):
    _, v, _, _, _, _ = trunk
    got = int8_trunk.export_int8_collection(
        {"t": v["params"]}, {"t": v["batch_stats"]}, device="cpu")["t"]
    want = jax_export_int8_collection({"t": v["params"]},
                                      {"t": v["batch_stats"]})["t"]

    def walk(g, w, path):
        if "kernel" in w:
            kmat = int8_trunk.kernel_matrix(np.asarray(w["kernel"]))
            np.testing.assert_array_equal(g["kernel"].numpy(), kmat, path)
            assert g["kernel"].dtype == torch.int8
            for key in ("scale", "bias"):
                np.testing.assert_array_equal(g[key].numpy(),
                                              np.asarray(w[key]), path)
            return
        assert set(g) == set(w), path
        for k in w:
            walk(g[k], w[k], f"{path}/{k}")

    walk(got["trunk"], want["trunk"], "trunk")
    stem_pad = (-int(np.prod(got["trunk"]["conv1"]["ksize"]))) % 8
    out_ch = got["trunk"]["conv1"]["kernel"].shape[0]
    assert int8_trunk.int8_collection_bytes(got) == \
        jax_int8_collection_bytes(want) + stem_pad * out_ch


def test_int8_integer_products_are_exact(trunk):
    """One conv of each kind (stem 7x7/2, 3x3, 1x1/2): the port's integer
    product over im2col equals JAX's int8 convolution with an int32
    accumulator, value for value."""
    _, v, _, _, _, _ = trunk
    rng = np.random.RandomState(4)
    p = v["params"]
    convs = [(p["conv1"]["kernel"], 2, 3, 3)]
    block = p["layer1_0"]
    convs.append((block["conv2"]["kernel"], 1, 1, block["conv2"]["kernel"]
                  .shape[2]))
    if "downsample_conv" in p["layer2_0"]:
        k = p["layer2_0"]["downsample_conv"]["kernel"]
        convs.append((k, 2, 0, k.shape[2]))
    for kernel, stride, pad, cin in convs:
        q, _ = jax_quantize_weight(kernel)
        xq = rng.randint(-127, 128, (2, 9, 9, cin)).astype(np.int8)
        want = np.asarray(jax.lax.conv_general_dilated(
            jnp.asarray(xq), jnp.asarray(q), (stride, stride),
            ((pad, pad), (pad, pad)),
            dimension_numbers=("NHWC", "HWIO", "NHWC"),
            preferred_element_type=jnp.int32))
        w = torch.from_numpy(np.ascontiguousarray(
            int8_trunk.kernel_matrix(q)))
        a, (b, ho, wo) = int8_trunk._im2col(
            torch.from_numpy(xq), q.shape[0], q.shape[1], stride, pad,
            w.shape[1])
        got = torch.matmul(a.double(), w.double().t()).reshape(b, ho, wo, -1)
        np.testing.assert_array_equal(got.numpy().astype(np.int64),
                                      want.astype(np.int64))


def test_int8_trunk_matches_jax(trunk):
    model, v, port, x, stages, bottleneck = trunk
    col = jax_export_int8_collection({"t": v["params"]},
                                     {"t": v["batch_stats"]})["t"]
    want = np.asarray(model.apply({**v, "int8": col}, jnp.asarray(x),
                                  train=False))
    tree = int8_trunk.export_int8_trunk(v["params"], v["batch_stats"],
                                        device="cpu")
    port.int8_trunk = tree
    try:
        with torch.no_grad():
            got = port(torch.from_numpy(x)).numpy()
            direct = int8_trunk.int8_resnet_apply(
                tree, torch.from_numpy(x), stages, bottleneck).numpy()
            os.environ["ATQ_INT8_DEQUANT"] = "1"
            try:
                dequant = port(torch.from_numpy(x)).numpy()
            finally:
                del os.environ["ATQ_INT8_DEQUANT"]
    finally:
        port.int8_trunk = None
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-5)
    np.testing.assert_array_equal(got, direct)
    np.testing.assert_allclose(dequant, got, rtol=1e-4, atol=1e-4)


@pytest.mark.parametrize("flag", ["ATQ_S2D_STEM", "ATQ_FAST_POOL"])
def test_xla_rewrites_match_jax(trunk, monkeypatch, flag):
    """Each rewrite's flag set on both sides: the port's eval features
    against flax's with the same flag, and against the port's default
    path (ops/s2d_stem.py and ops/fast_pool.py are tested function by
    function in tests/test_torch_s2d_stem.py and test_torch_fast_pool.py)."""
    model, v, port, x, _, _ = trunk
    with torch.no_grad():
        default = port(torch.from_numpy(x)).numpy()
    monkeypatch.setenv(flag, "1")
    want = np.asarray(model.apply(v, jnp.asarray(x), train=False))
    with torch.no_grad():
        got = port(torch.from_numpy(x)).numpy()
    np.testing.assert_allclose(got, want, rtol=1e-4, atol=1e-4)
    np.testing.assert_allclose(got, default, rtol=1e-5, atol=1e-5)
