"""The port's native binding (atq_tpu_torch/native) against the JAX
package's (atq_tpu/native) and against its own numpy versions.

Both bindings call the same ``csrc/atq_native.cpp``, built twice: the JAX
package's ``make`` into ``atq_tpu/native/``, the port's ``c++`` into
``atq_tpu_torch/_build/``. Packed bytes, ternary values, counts and the
ELL/COO arrays must agree bit for bit; ``ternarize``'s float64 sum is held
to 1e-12 relative against the JAX build (which may use other instructions,
``-march=native``) and bit for bit against the numpy version, which sums in
the C loop's order.
"""

import numpy as np
import pytest
import torch

from atq_tpu import native as jax_native
from atq_tpu.core.packing import pack_planar as jax_pack_planar
from atq_tpu_torch import native
from atq_tpu_torch.serve.packed_model import export_packed_collection


def _ternary(shape, seed):
    return np.random.RandomState(seed).choice(
        [-1.0, 0.0, 1.0], size=shape).astype(np.float32)


# Sizes with n % 4 = 0, 1, 2, 3 and K below, at and above k_align.
SHAPES = [(37, 13), (8, 512), (3, 1), (16, 1030)]


@pytest.mark.parametrize("shape", SHAPES, ids=str)
def test_pack_unpack_bit_for_bit(shape):
    w = _ternary(shape, seed=shape[0] * shape[1])
    flat = native.pack_ternary(w)
    np.testing.assert_array_equal(flat, native.pack_ternary_plain(w))
    if jax_native.available():
        np.testing.assert_array_equal(flat, jax_native.pack_ternary(w))
    back = native.unpack_ternary(flat, w.size, shape=w.shape)
    np.testing.assert_array_equal(back, w)
    np.testing.assert_array_equal(
        back, native.unpack_ternary_plain(flat, w.size, shape=w.shape))
    for k_align in (4, 512):
        planar = native.pack_planar(w, k_align=k_align)
        np.testing.assert_array_equal(
            planar, native.pack_planar_plain(w, k_align=k_align))
        np.testing.assert_array_equal(
            planar, np.asarray(jax_pack_planar(w, k_align)))


@pytest.mark.parametrize("fn", ["pack_ternary", "pack_planar",
                                "pack_ternary_plain", "pack_planar_plain"])
def test_non_ternary_input_raises(fn):
    w = _ternary((4, 8), seed=1)
    w[2, 3] = 0.5
    with pytest.raises(ValueError, match="ternary"):
        getattr(native, fn)(w)


def test_ternarize_matches_jax_and_plain():
    w = np.random.RandomState(4).randn(64, 33).astype(np.float32)
    for thr in (0.0, 0.4, 10.0):
        w_t, nnz, dot = native.ternarize(w, thr)
        p_t, p_nnz, p_dot = native.ternarize_plain(w, thr)
        np.testing.assert_array_equal(w_t, p_t)
        assert (nnz, dot) == (p_nnz, p_dot)
        if jax_native.available():
            j_t, j_nnz, j_dot = jax_native.ternarize(w, thr)
            np.testing.assert_array_equal(w_t, j_t)
            assert nnz == j_nnz
            assert dot == pytest.approx(j_dot, rel=1e-12, abs=0.0)


@pytest.mark.parametrize("c", [1, 30, 400])
def test_sparse_ell_matches_jax_and_plain(c):
    rng = np.random.RandomState(11)
    corr = np.zeros((64, 300), np.float32)
    mask = rng.rand(*corr.shape) < 0.12
    corr[mask] = rng.randn(mask.sum())
    corr[5] = 0.0  # an empty row
    got = native.sparse_ell(corr, c)
    for other in (native.sparse_ell_plain(corr, c),
                  jax_native.sparse_ell(corr, c)):
        for g, o in zip(got, other):
            assert g.dtype == o.dtype
            np.testing.assert_array_equal(g, o)
    idx, val, coo_row, coo_col, coo_val = got
    rebuilt = np.zeros_like(corr)
    rows = np.repeat(np.arange(corr.shape[0]), c)
    np.add.at(rebuilt, (rows, idx.reshape(-1)), val.reshape(-1))
    np.add.at(rebuilt, (coo_row, coo_col), coo_val)
    np.testing.assert_array_equal(rebuilt, corr)


def test_ell_export_unchanged():
    """``export_packed_collection``'s ELL/COO fields, now built by the
    binding, equal the numpy version's on an RPB layer's correction."""
    rng = np.random.RandomState(3)
    params = {"layer": {"weight": rng.randn(24, 200).astype(np.float32),
                        "alpha": np.asarray([0.05], np.float32)}}
    mask = np.zeros((24, 200), bool)
    mask.reshape(-1)[rng.permutation(24 * 200)[:480]] = True
    mask[0, :120] = True  # a dense row spills into the COO part
    quant = {"layer": {"precision_mask": mask,
                       "sparsity_target": np.float32(0.3)}}
    entry = export_packed_collection(params, quant, device="cpu")["layer"][
        "entry"]
    assert "coo_row" in entry
    w = params["layer"]["weight"]
    from atq_tpu_torch.core.quantize import adaptive_ternary_quantization

    w_t, a = adaptive_ternary_quantization(
        torch.from_numpy(w), alpha=torch.tensor([0.05]),
        sparsity_target=torch.tensor(0.3))
    corr = mask * (w - w_t.numpy() * float(a))
    corr = torch.from_numpy(corr.astype(np.float32)).to(
        torch.bfloat16).float().numpy()
    c = max(1, int(round(int((corr != 0).sum()) / corr.shape[0])))
    idx, val, coo_row, coo_col, coo_val = native.sparse_ell_plain(corr, c)
    np.testing.assert_array_equal(entry["corr_idx"].numpy(), idx)
    np.testing.assert_array_equal(entry["corr_val"].float().numpy(), val)
    np.testing.assert_array_equal(entry["coo_row"].numpy(), coo_row)
    np.testing.assert_array_equal(entry["coo_col"].numpy(), coo_col)
    np.testing.assert_array_equal(entry["coo_val"].float().numpy(), coo_val)


def test_library_built_in_the_port():
    lib = native.load_library()
    assert native.BUILD_DIR.name == "_build"
    assert str(native.BUILD_DIR) in lib._name
    assert "atq_tpu/native" not in lib._name
