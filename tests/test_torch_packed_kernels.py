"""The port's planar32 packing, planar32 and RPB matmuls, and the packed
export under ``ATQ_PACK32`` and ``sparse_correction`` against atq_tpu on the
CPU.

- ``pack_planar32`` words are bit-identical to JAX's int32 words, the
  negative ones (a +1 in field 15 sets bit 31) included.
- ``packed_ternary_matmul(layout="planar32")`` (symmetric and TTQ) and
  ``packed_ternary_matmul_rpb`` agree with JAX within rtol/atol 1e-5, at a
  kernel-eligible shape (K >= 128, N >= 8; the wrappers' plain versions
  here) and a smaller one (the unpack path). On the CPU the JAX entry points
  take their XLA fallbacks in-process; one subprocess runs the Pallas
  kernels ``_kernel32`` and ``_kernel_rpb`` themselves through the
  interpreter (``ATQ_PALLAS_INTERPRET=1``, as tests/test_pallas_interpret.py
  does) and holds the port's plain versions to them.
- The numerics the CUDA kernel (csrc/ternary_matmul.cu) rests on, with
  its arithmetic emulated here: ternary weights and bf16 corrections are
  exact bf16 values; x splits into three bf16 terms that add back to x
  within 2^-24·|x|; the three bf16-operand products summed in float32
  (symmetric, TTQ with two accumulators, RPB with two sums) match a float64
  product within (4K)·2^-24·(|x| @ |W|ᵀ), the float32 summation bound; and
  they match the Pallas kernels ``_kernel``, ``_kernel32`` and
  ``_kernel_rpb`` run in interpret mode within rtol/atol 1e-5.
- Export under ATQ_PACK32=0/1 x sparse_correction=True/False: planes
  bit-exact, alpha exact, ELL/COO indices equal, bf16 values exact;
  ``packed_linear_apply`` agrees with JAX on every route within 1e-5, and
  the sparse and dense corrections serve the same numbers within 1e-5.
"""

import os
import subprocess
import sys

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from atq_tpu.core.packing import (
    PLANAR32_ZERO_WORD as JAX_ZERO_WORD,
    pack_planar as jax_pack_planar,
    pack_planar32 as jax_pack_planar32,
)
from atq_tpu.ops.ternary_matmul import (
    packed_ternary_matmul as jax_packed_ternary_matmul,
    packed_ternary_matmul_rpb as jax_packed_ternary_matmul_rpb,
)
from atq_tpu.serve.packed_model import (
    pack_quantized_layer as jax_pack_quantized_layer,
    packed_linear_apply as jax_packed_linear_apply,
)
from atq_tpu_torch.core.packing import (
    PLANAR32_ZERO_WORD,
    pack_planar,
    pack_planar32,
    unpack_planar32,
)
from atq_tpu_torch.ops import ternary_matmul as tm
from atq_tpu_torch.serve.packed_model import (
    pack_quantized_layer,
    packed_linear_apply,
)

RTOL = ATOL = 1e-5
REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _ternary(shape, seed):
    rng = np.random.RandomState(seed)
    return rng.choice([-1.0, 0.0, 1.0], size=shape,
                      p=[0.35, 0.3, 0.35]).astype(np.float32)


@pytest.mark.parametrize("k", [100, 2048, 2049, 3136])
def test_pack_planar32_words_bit_identical_to_jax(k):
    w = _ternary((6, k), seed=k)
    k16 = (k + (-k) % 2048) // 16
    if 15 * k16 < k:  # a +1 in field 15: bit 31 set, a negative word
        w[:3, 15 * k16:] = 1.0
    got = pack_planar32(torch.from_numpy(w))
    want = np.asarray(jax_pack_planar32(jnp.asarray(w)))
    assert got.dtype == torch.int32 and want.dtype == np.int32
    np.testing.assert_array_equal(got.numpy(), want)
    if 15 * k16 < k:
        assert (want[:3] < 0).any()
    np.testing.assert_array_equal(unpack_planar32(got, k).numpy(), w)
    assert PLANAR32_ZERO_WORD == JAX_ZERO_WORD
    zero_row = pack_planar32(torch.zeros(1, k))
    assert (zero_row == PLANAR32_ZERO_WORD).all()


# (M, K, N): eligible for the kernel (K >= 128, N >= 8) and not.
SHAPES = [(5, 192, 24), (3, 100, 24), (4, 3136, 16), (2, 256, 4)]


@pytest.mark.parametrize("mkn", SHAPES)
@pytest.mark.parametrize("ttq", [False, True])
def test_planar32_matmul_matches_jax(mkn, ttq):
    m, k, n = mkn
    rng = np.random.RandomState(m + k + n)
    w = _ternary((n, k), seed=k)
    x = (rng.randn(m, k) * 0.1).astype(np.float32)
    alpha_neg = 0.4 if ttq else None
    got = tm.packed_ternary_matmul(torch.from_numpy(x),
                                   pack_planar32(torch.from_numpy(w)), (n, k),
                                   alpha=0.9, layout="planar32",
                                   alpha_neg=alpha_neg)
    want = jax_packed_ternary_matmul(jnp.asarray(x),
                                     jax_pack_planar32(jnp.asarray(w)),
                                     (n, k), alpha=0.9, layout="planar32",
                                     alpha_neg=alpha_neg)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=RTOL,
                               atol=ATOL)


@pytest.mark.parametrize("mkn", SHAPES)
def test_rpb_matmul_matches_jax(mkn):
    m, k, n = mkn
    rng = np.random.RandomState(m * k + n)
    w = _ternary((n, k), seed=k + 1)
    x = (rng.randn(m, k) * 0.1).astype(np.float32)
    corr = (rng.randn(n, k) * 0.02 * (rng.rand(n, k) < 0.1)).astype(
        np.float32)
    corr_t = torch.from_numpy(corr).to(torch.bfloat16)
    got = tm.packed_ternary_matmul_rpb(torch.from_numpy(x),
                                       pack_planar(torch.from_numpy(w)),
                                       corr_t, (n, k), alpha=0.7)
    want = jax_packed_ternary_matmul_rpb(
        jnp.asarray(x), jax_pack_planar(jnp.asarray(w)),
        jnp.asarray(corr_t.float().numpy(), jnp.bfloat16), (n, k),
        alpha=0.7)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=RTOL,
                               atol=ATOL)


def test_wrappers_reject_bad_inputs():
    w = torch.from_numpy(_ternary((8, 256), seed=2))
    words, planes = pack_planar32(w), pack_planar(w)
    avec = torch.tensor([1.0, 1.0])
    corr = torch.zeros(8, 256, dtype=torch.bfloat16)
    with pytest.raises(ValueError):  # words for another K
        tm.ternary_matmul_planar32(torch.zeros(2, 2100), words, 2100, avec)
    with pytest.raises(ValueError):  # uint8 planes are not planar32 words
        tm.ternary_matmul_planar32(torch.zeros(2, 256), planes, 256, avec)
    with pytest.raises(ValueError):  # a padded correction
        tm.ternary_matmul_rpb(torch.zeros(2, 256), planes,
                              torch.zeros(8, 512, dtype=torch.bfloat16), 256,
                              avec)
    with pytest.raises(ValueError):  # a float32 correction
        tm.ternary_matmul_rpb(torch.zeros(2, 256), planes, corr.float(),
                              256, avec)
    for fn in (tm.ternary_matmul_planar32, tm.ternary_matmul_rpb):
        assert fn.launches == 0  # the CPU path launches nothing


_INTERPRET = r"""
import os, sys
os.environ["JAX_PLATFORMS"] = "cpu"
os.environ["ATQ_PALLAS_INTERPRET"] = "1"
import jax
jax.config.update("jax_platforms", "cpu")
import jax.numpy as jnp
import numpy as np
sys.path.insert(0, os.environ["ATQ_REPO"])
from atq_tpu.core.packing import pack_planar, pack_planar32
from atq_tpu.ops.ternary_matmul import (
    packed_ternary_matmul, packed_ternary_matmul_rpb, pallas_eligible)
d = dict(np.load(sys.argv[1]))
m, k = d["x"].shape
n = d["w"].shape[0]
assert pallas_eligible((m, k), (n, k))
x, w = jnp.asarray(d["x"]), jnp.asarray(d["w"])
out = {
    "sym": packed_ternary_matmul(x, pack_planar32(w), (n, k), alpha=0.9,
                                 layout="planar32"),
    "ttq": packed_ternary_matmul(x, pack_planar32(w), (n, k), alpha=0.9,
                                 layout="planar32", alpha_neg=0.4),
    "rpb": packed_ternary_matmul_rpb(
        x, pack_planar(w), jnp.asarray(d["corr"], jnp.bfloat16), (n, k),
        alpha=0.7),
}
np.savez(sys.argv[2], **{k: np.asarray(v) for k, v in out.items()})
"""


def test_plain_versions_match_the_pallas_kernels_in_interpret_mode(tmp_path):
    """``_kernel32`` (sym and TTQ) and ``_kernel_rpb`` run by the Pallas
    interpreter against the port's plain versions at an eligible shape."""
    m, k, n = 8, 200, 16
    rng = np.random.RandomState(7)
    x = (rng.randn(m, k) * 0.1).astype(np.float32)
    w = _ternary((n, k), seed=9)
    corr = torch.from_numpy((rng.randn(n, k) * 0.02 * (rng.rand(n, k) < 0.1))
                            .astype(np.float32)).to(torch.bfloat16)
    np.savez(tmp_path / "in.npz", x=x, w=w, corr=corr.float().numpy())
    env = {**os.environ, "ATQ_REPO": REPO}
    out = subprocess.run([sys.executable, "-c", _INTERPRET,
                          str(tmp_path / "in.npz"), str(tmp_path / "out.npz")],
                         env=env, capture_output=True, text=True, timeout=240)
    assert out.returncode == 0, out.stdout + out.stderr
    want = np.load(tmp_path / "out.npz")
    xt, wt = torch.from_numpy(x), torch.from_numpy(w)
    words, planes = pack_planar32(wt), pack_planar(wt)
    for name, asym, avec in (("sym", False, (0.9, 0.9)),
                             ("ttq", True, (0.9, 0.4))):
        got = tm.ternary_matmul32_plain(xt, words, k, torch.tensor(avec),
                                        asym)
        np.testing.assert_allclose(got.numpy(), want[name], rtol=RTOL,
                                   atol=ATOL, err_msg=name)
    got = tm.ternary_matmul_rpb_plain(xt, planes, corr, k,
                                      torch.tensor([0.7, 0.7]))
    np.testing.assert_allclose(got.numpy(), want["rpb"], rtol=RTOL,
                               atol=ATOL)


def _bf16_terms(x):
    """x (float32) as the CUDA kernel splits it: three float32 tensors of
    bf16 values, each the bf16 rounding of what the terms before it left."""
    terms, rest = [], x
    for _ in range(3):
        term = rest.to(torch.bfloat16).float()
        terms.append(term)
        rest = rest - term
    return terms


def _bf16x3(x, w, alpha, alpha_neg=None, corr=None):
    """The kernel's arithmetic: the three bf16 terms of x against exact
    bf16 operands, products summed in float32; symmetric (one sum scaled
    by alpha), TTQ (the indicator planes [w = +1] and [w = -1] in two sums,
    alpha·S+ − alpha_neg·S−) or RPB (the ternary sum scaled by alpha, plus
    the correction's sum)."""
    terms = _bf16_terms(x)

    def dot(b):
        return sum(torch.matmul(t, b.T) for t in terms)

    if alpha_neg is not None:
        return (alpha * dot((w == 1).float())
                - alpha_neg * dot((w == -1).float()))
    out = dot(w) * alpha
    return out if corr is None else out + dot(corr.float())


def test_ternary_values_and_corrections_are_exact_in_bf16():
    w = torch.from_numpy(_ternary((16, 200), seed=4))
    assert torch.equal(w.to(torch.bfloat16).float(), w)
    # The kernel's byte tables hold these bits for -1, 0, +1.
    bits = torch.tensor([-1.0, 0.0, 1.0]).to(torch.bfloat16).view(torch.int16)
    assert [b & 0xFFFF for b in bits.tolist()] == [0xBF80, 0x0000, 0x3F80]
    rng = np.random.RandomState(5)
    corr = torch.from_numpy((rng.randn(16, 200) * 0.02).astype(
        np.float32)).to(torch.bfloat16)
    assert torch.equal(corr.float().to(torch.bfloat16).view(torch.int16),
                       corr.view(torch.int16))


def test_three_bf16_terms_reconstruct_x():
    rng = np.random.RandomState(6)
    x = torch.from_numpy((rng.randn(64, 300) * 10.0 ** rng.uniform(
        -20, 20, (64, 300))).astype(np.float32))
    terms = _bf16_terms(x)
    for t in terms:
        assert torch.equal(t.to(torch.bfloat16).float(), t)
    err = (x.double() - sum(t.double() for t in terms)).abs()
    assert (err <= 2.0 ** -24 * x.double().abs()).all()


@pytest.mark.parametrize("form", ["sym", "ttq", "rpb"])
@pytest.mark.parametrize("mkn", [(8, 200, 16), (5, 3136, 24)])
def test_bf16x3_products_match_float64(form, mkn):
    m, k, n = mkn
    rng = np.random.RandomState(k + n)
    x = torch.from_numpy(rng.randn(m, k).astype(np.float32))
    w = torch.from_numpy(_ternary((n, k), seed=k))
    corr = torch.from_numpy((rng.randn(n, k) * 0.02 * (rng.rand(n, k) < 0.1))
                            .astype(np.float32)).to(torch.bfloat16)
    alpha, alpha_neg = 0.9, (0.4 if form == "ttq" else None)
    got = _bf16x3(x, w, alpha, alpha_neg,
                  corr if form == "rpb" else None).double()
    wd = w.double()
    if form == "ttq":
        w_eff = alpha * wd.clamp(min=0) + alpha_neg * wd.clamp(max=0)
    else:
        w_eff = alpha * wd + (corr.double() if form == "rpb" else 0.0)
    want = x.double() @ w_eff.T
    scale = x.double().abs() @ w_eff.abs().T
    assert ((got - want).abs() <= 4 * k * 2.0 ** -24 * scale).all()
    plain = (tm.ternary_matmul_rpb_plain(x, pack_planar(w), corr, k,
                                         torch.tensor([alpha, alpha]))
             if form == "rpb" else
             tm.ternary_matmul_plain(x, pack_planar(w), k, torch.tensor(
                 [alpha, alpha_neg or alpha]), form == "ttq"))
    # against the port's plain float32 version: the kernel's own tolerance
    # on the card (rtol 1e-5 / atol 5e-3, JAX's kernel tolerance)
    torch.testing.assert_close(got.float(), plain, rtol=1e-5, atol=5e-3)


_INTERPRET_ALL = r"""
import os, sys
os.environ["JAX_PLATFORMS"] = "cpu"
os.environ["ATQ_PALLAS_INTERPRET"] = "1"
import jax
jax.config.update("jax_platforms", "cpu")
import jax.numpy as jnp
import numpy as np
sys.path.insert(0, os.environ["ATQ_REPO"])
from atq_tpu.core.packing import pack_planar, pack_planar32
from atq_tpu.ops.ternary_matmul import (
    packed_ternary_matmul, packed_ternary_matmul_rpb, pallas_eligible)
d = dict(np.load(sys.argv[1]))
m, k = d["x"].shape
n = d["w"].shape[0]
assert pallas_eligible((m, k), (n, k))
x, w = jnp.asarray(d["x"]), jnp.asarray(d["w"])
out = {"rpb": packed_ternary_matmul_rpb(
    x, pack_planar(w), jnp.asarray(d["corr"], jnp.bfloat16), (n, k),
    alpha=0.7)}
for layout, packed in (("planar", pack_planar(w)),
                       ("planar32", pack_planar32(w))):
    for name, neg in (("sym", None), ("ttq", 0.4)):
        out[layout + "_" + name] = packed_ternary_matmul(
            x, packed, (n, k), alpha=0.9, layout=layout, alpha_neg=neg)
np.savez(sys.argv[2], **{k: np.asarray(v) for k, v in out.items()})
"""


@pytest.mark.parametrize("mkn", [(8, 200, 16), (5, 136, 12)])
def test_bf16x3_matches_the_pallas_kernels_in_interpret_mode(tmp_path, mkn):
    """``_kernel`` and ``_kernel32`` (symmetric and TTQ) and ``_kernel_rpb``
    run by the Pallas interpreter against the CUDA kernel's arithmetic, at
    an eligible shape and a ragged one (M = 5, K = 136, N = 12)."""
    m, k, n = mkn
    rng = np.random.RandomState(m * n)
    x = (rng.randn(m, k) * 0.1).astype(np.float32)
    w = _ternary((n, k), seed=n)
    corr = torch.from_numpy((rng.randn(n, k) * 0.02 * (rng.rand(n, k) < 0.1))
                            .astype(np.float32)).to(torch.bfloat16)
    np.savez(tmp_path / "in.npz", x=x, w=w, corr=corr.float().numpy())
    env = {**os.environ, "ATQ_REPO": REPO}
    out = subprocess.run([sys.executable, "-c", _INTERPRET_ALL,
                          str(tmp_path / "in.npz"), str(tmp_path / "out.npz")],
                         env=env, capture_output=True, text=True, timeout=240)
    assert out.returncode == 0, out.stdout + out.stderr
    want = np.load(tmp_path / "out.npz")
    xt, wt = torch.from_numpy(x), torch.from_numpy(w)
    for layout in ("planar", "planar32"):
        for name, neg in (("sym", None), ("ttq", 0.4)):
            np.testing.assert_allclose(
                _bf16x3(xt, wt, 0.9, neg).numpy(), want[f"{layout}_{name}"],
                rtol=RTOL, atol=ATOL, err_msg=f"{layout} {name}")
    np.testing.assert_allclose(_bf16x3(xt, wt, 0.7, corr=corr).numpy(),
                               want["rpb"], rtol=RTOL, atol=ATOL)


def _layer(seed, n=24, k=192, ttq=False, with_mask=True, bias=True):
    rng = np.random.RandomState(seed)
    params = {"weight": (rng.randn(n, k) * 0.05).astype(np.float32),
              "alpha": np.full((1,), 0.04, np.float32)}
    if bias:
        params["bias"] = (rng.randn(n) * 0.1).astype(np.float32)
    if ttq:
        params["wp"] = np.full((1,), 0.05, np.float32)
        params["wn"] = np.full((1,), 0.03, np.float32)
    quant = {"sparsity_target": np.float32(0.1)}
    if with_mask:
        quant["precision_mask"] = rng.rand(n, k) < 0.2
    return params, quant


# Every route of packed_linear_apply: (pack32, sparse, ttq).
ROUTES = [(p32, sparse, ttq) for p32 in (False, True)
          for sparse in (True, False) for ttq in (False, True)]


@pytest.mark.parametrize("pack32,sparse,ttq", ROUTES)
def test_export_entries_and_apply_match_jax(monkeypatch, pack32, sparse,
                                            ttq):
    monkeypatch.setenv("ATQ_PACK32", "1" if pack32 else "0")
    params, quant = _layer(seed=3 + 2 * pack32 + ttq, ttq=ttq)
    got = pack_quantized_layer(params, quant, device="cpu",
                               sparse_correction=sparse)
    want = jax_pack_quantized_layer(params, quant, sparse_correction=sparse)
    assert set(got) == set(want)
    assert got["packed"].dtype == (torch.int32 if pack32 else torch.uint8)
    np.testing.assert_array_equal(got["packed"].numpy(),
                                  np.asarray(want["packed"]))
    assert tuple(got["shape"]) == tuple(want["shape"])
    for key in ("alpha", "alpha_neg", "bias"):
        if key in want:
            np.testing.assert_array_equal(got[key].numpy(),
                                          np.asarray(want[key]))
    for key in ("corr_idx", "coo_row", "coo_col"):
        if key in want:
            np.testing.assert_array_equal(got[key].numpy(),
                                          np.asarray(want[key]))
    for key in ("corr_val", "coo_val", "correction"):
        if key in want:
            assert got[key].dtype == torch.bfloat16
            np.testing.assert_array_equal(
                got[key].float().numpy(),
                np.asarray(want[key].astype(jnp.float32)))
    x = (np.random.RandomState(1).randn(6, 192) * 0.5).astype(np.float32)
    np.testing.assert_allclose(
        packed_linear_apply(got, torch.from_numpy(x)).numpy(),
        np.asarray(jax_packed_linear_apply(want, jnp.asarray(x))),
        rtol=RTOL, atol=ATOL)


@pytest.mark.parametrize("pack32", [False, True])
def test_sparse_and_dense_corrections_serve_the_same_numbers(monkeypatch,
                                                             pack32):
    """JAX's own check (tests/test_serve.py): both correction forms of one
    layer serve the same numbers; the dense one through the fused RPB path
    with uint8 planes, through the packed path plus a matmul with
    planar32."""
    monkeypatch.setenv("ATQ_PACK32", "1" if pack32 else "0")
    params, quant = _layer(seed=11, n=40, k=300)
    x = torch.from_numpy((np.random.RandomState(2).randn(9, 300))
                         .astype(np.float32))
    sparse = packed_linear_apply(pack_quantized_layer(
        params, quant, device="cpu"), x)
    dense = packed_linear_apply(pack_quantized_layer(
        params, quant, device="cpu", sparse_correction=False), x)
    torch.testing.assert_close(dense, sparse, rtol=RTOL, atol=ATOL)
