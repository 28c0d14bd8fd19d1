"""The port's space-to-depth stem (ops/s2d_stem.py) against
atq_tpu/ops/s2d_stem.py on the CPU, case for case with tests/test_s2d_stem.py.

The port works in NCHW activations and OIHW kernels; the JAX functions in
NHWC and HWIO, so inputs are transposed across. The rewrite is the direct
stem conv's sum reassociated: forward and both gradients agree to float
rounding (tests/test_s2d_stem.py's tolerances), with JAX's functions and
with the port's direct conv, at every even size, including one where the
zero-padded kernel column overlaps real padding (14).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from atq_tpu.ops import s2d_stem as js
from atq_tpu_torch.models.resnet import StemConv
from atq_tpu_torch.ops import s2d_stem as ts


def _rand(shape, seed):
    return np.random.RandomState(seed).randn(*shape).astype(np.float32)


def _nchw(x):
    return torch.from_numpy(x).permute(0, 3, 1, 2)


def _oihw(k):
    return torch.from_numpy(k).permute(3, 2, 0, 1)


@pytest.mark.parametrize("hw", [32, 160, 14])
def test_forward_equivalence(hw):
    x, k = _rand((2, hw, hw, 3), 0), _rand((7, 7, 3, 16), 1)
    direct = ts.stem_conv(_nchw(x), _oihw(k), use_s2d=False)
    s2d = ts.stem_conv(_nchw(x), _oihw(k), use_s2d=True)
    assert direct.shape == s2d.shape == (2, 16, hw // 2, hw // 2)
    np.testing.assert_allclose(s2d.numpy(), direct.numpy(), rtol=1e-5,
                               atol=1e-5)
    want = np.asarray(js.stem_conv(jnp.asarray(x), jnp.asarray(k),
                                   use_s2d=True))
    np.testing.assert_allclose(s2d.permute(0, 2, 3, 1).numpy(), want,
                               rtol=1e-5, atol=1e-5)


def test_gradient_equivalence():
    x, k, g = (_rand((2, 32, 32, 3), 2), _rand((7, 7, 3, 8), 3),
               _rand((2, 16, 16, 8), 4))
    _, vjp = jax.vjp(lambda a, w: js.stem_conv(a, w, use_s2d=True),
                     jnp.asarray(x), jnp.asarray(k))
    jgx, jgk = (np.asarray(t) for t in vjp(jnp.asarray(g)))
    grads = {}
    for use_s2d in (False, True):
        xt = _nchw(x).requires_grad_()
        kt = _oihw(k).requires_grad_()
        ts.stem_conv(xt, kt, use_s2d=use_s2d).backward(_nchw(g))
        grads[use_s2d] = (xt.grad.permute(0, 2, 3, 1).numpy(),
                          kt.grad.permute(2, 3, 1, 0).numpy())
    for (gx, gk) in (grads[True], (jgx, jgk)):
        np.testing.assert_allclose(gx, grads[False][0], rtol=1e-4,
                                   atol=1e-5)
        np.testing.assert_allclose(gk, grads[False][1], rtol=1e-4,
                                   atol=1e-4)


def test_odd_size_falls_back():
    x, k = _rand((1, 15, 15, 3), 5), _rand((7, 7, 3, 4), 6)
    np.testing.assert_array_equal(
        ts.stem_conv(_nchw(x), _oihw(k), use_s2d=True).numpy(),
        ts.stem_conv(_nchw(x), _oihw(k), use_s2d=False).numpy())


def test_space_to_depth_roundtrip_order():
    # (dr, dc, c): block offset (1, 0) of channel 2 lands at channel
    # (1*2 + 0)*C + 2, as in JAX's NHWC layout.
    x = np.arange(2 * 4 * 4 * 3, dtype=np.float32).reshape(2, 4, 4, 3)
    y = ts.space_to_depth(_nchw(x))
    assert tuple(y.shape) == (2, 12, 2, 2)
    assert float(y[0, (1 * 2 + 0) * 3 + 2, 1, 0]) == x[0, 3, 0, 2]
    np.testing.assert_array_equal(
        y.permute(0, 2, 3, 1).numpy(),
        np.asarray(js.space_to_depth(jnp.asarray(x))))


def test_pack_kernel_zero_pad_column():
    k4 = ts.pack_stem_kernel(torch.ones(2, 3, 7, 7))
    assert tuple(k4.shape) == (2, 12, 4, 4)
    assert float(k4.sum()) == pytest.approx(2 * 3 * 49)
    k4v = k4.permute(2, 3, 1, 0).numpy().reshape(4, 4, 2, 2, 3, 2)
    assert (k4v[0, :, 0] == 0).all()  # A == 0, dr == 0: the padded row
    assert (k4v[1:, :, :] != 0).any()
    k = _rand((7, 7, 3, 5), 7)
    np.testing.assert_array_equal(
        ts.pack_stem_kernel(_oihw(k)).permute(2, 3, 1, 0).numpy(),
        np.asarray(js.pack_stem_kernel(jnp.asarray(k))))


def test_stem_module_keeps_the_7x7_parameter():
    stem = StemConv(3, 8, generator=torch.Generator().manual_seed(0))
    assert tuple(stem.weight.shape) == (8, 3, 7, 7)
    assert dict(stem.named_parameters()).keys() == {"weight"}


def test_resnet_env_dispatch(monkeypatch):
    from atq_tpu_torch.models.resnet import ResNetFeatures

    model = ResNetFeatures(device="cpu",
                           generator=torch.Generator().manual_seed(0))
    x = torch.from_numpy(_rand((1, 32, 32, 3), 7))
    with torch.no_grad():
        monkeypatch.setenv("ATQ_S2D_STEM", "1")
        on = model(x)
        monkeypatch.setenv("ATQ_S2D_STEM", "0")
        off = model(x)
    np.testing.assert_allclose(on.numpy(), off.numpy(), rtol=1e-4,
                               atol=1e-5)
