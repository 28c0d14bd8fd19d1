"""The arithmetic of the CUDA forward and dx kernels (``gemm_tc_kernel`` in
atq_tpu_torch/csrc/fused_linear.cu), emulated in torch on the CPU.

Both kernels blend the weight into w_eff (tern(w)·alpha, or w where the
mask is set) before anything else, then form their product on the tensor
cores as 3xTF32: each f32 operand value v is split into hi =
cvt.rna.tf32(v) and lo = cvt.rna.tf32(v − hi), and each MMA step of 8
reduction values sums lo·hi, hi·lo and hi·hi into a fresh f32 partial that
is added to the running sum (step sums; lo·lo dropped). dx = g · w_eff
reduces over all of N in one block. The forward y = x · w_effᵀ splits K
into runs of ``forward_splits``' chunk, one block each, and the last block
of an output tile to finish adds the splits' partials in split order.
Here:

- the emulated kernels match the JAX package's own ``_fwd_kernel`` /
  ``_fwd_kernel_nomask`` and ``_dx_kernel`` / ``_dx_kernel_nomask`` run by
  the Pallas interpreter within rtol 1e-5 / atol 1e-6; ``_pallas_forward``
  and ``_pallas_dx`` pass no ``interpret=`` and cannot run on the CPU, so
  the test wraps each kernel body in its own ``pl.pallas_call``;
- at the card's shapes the emulation meets the card check's tolerance
  (rtol/atol 1e-4) against the port's plain versions and lies more than
  100x closer to a float64 product than one TF32 pass; one TF32 pass
  misses that tolerance on the forward at both head layers (on dx, whose
  values are about 1e-3, it stays inside the atol), and misses the card
  check's bound on the error against float64 over Σ|a|·|b|
  (F64_REL_TOL), which the emulation meets, on both kernels;
- the forward's result does not depend on which split finishes last.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental import pallas as pl

from atq_tpu.ops.fused_linear import (
    _dx_kernel,
    _dx_kernel_nomask,
    _fwd_kernel,
    _fwd_kernel_nomask,
)
from atq_tpu_torch.core.quantize import ternary_threshold
from atq_tpu_torch.ops import fused_linear as fl

MMA_K = 8  # reduction values an MMA step
FUSED_TOL = 1e-4  # the card check's rtol/atol on y and dx
F64_REL_TOL = 1e-5  # the card check's bound on |err| / Σ|a||b| vs float64


def _tf32_rna(v):
    """cvt.rna.tf32.f32 on finite float32 values: 10 mantissa bits kept,
    rounded to nearest with ties away from zero."""
    bits = v.view(torch.int32).to(torch.int64) & 0xFFFFFFFF
    bits = (bits + 0x1000) & 0xFFFFE000
    bits = torch.where(bits >= 2 ** 31, bits - 2 ** 32, bits)
    return bits.to(torch.int32).view(torch.float32)


def _split(v):
    hi = _tf32_rna(v)
    return hi, _tf32_rna(v - hi)


def _w_eff(w, mask, scal):
    """The kernels' blend: w where the mask is set, else tern(w)·alpha."""
    wt = fl._ternarize(w, scal[1]) * scal[0]
    return wt if mask is None else torch.where(mask, w, wt)


def _steps_3xtf32(a, b):
    """a (R, L) · b (L, C) as the kernels sum it: per 8 of the reduction,
    lo·hi, hi·lo and hi·hi into a fresh f32 partial, then added to the
    running sum."""
    ah, al = _split(a)
    bh, bl = _split(b)
    acc = torch.zeros(a.shape[0], b.shape[1], dtype=torch.float32)
    for s0 in range(0, a.shape[1], MMA_K):
        s = slice(s0, s0 + MMA_K)
        part = al[:, s] @ bh[s]
        part = part + ah[:, s] @ bl[s]
        part = part + ah[:, s] @ bh[s]
        acc = acc + part
    return acc


def _forward_partials(x, w, mask, scal):
    """Each split's partial of y, in split order."""
    _, chunk = fl.forward_splits(x.shape[0], w.shape[0], x.shape[1])
    w_eff = _w_eff(w, mask, scal)
    return [_steps_3xtf32(x[:, k0:k0 + chunk], w_eff[:, k0:k0 + chunk].T)
            for k0 in range(0, x.shape[1], chunk)]


def _sum_in_order(parts):
    y = parts[0]
    for p in parts[1:]:
        y = y + p
    return y


def _emulate_forward(x, w, mask, scal):
    return _sum_in_order(_forward_partials(x, w, mask, scal))


def _emulate_dx(g, w, mask, scal):
    return _steps_3xtf32(g, _w_eff(w, mask, scal))


def _inputs(m, n, k, with_mask, seed):
    """Head-layer inputs as the card check draws them: post-ReLU x, a small
    weight, the quantizer's threshold at sparsity 0.3, alpha 0.017."""
    rng = np.random.RandomState(seed)
    x = torch.from_numpy(np.maximum(rng.randn(m, k), 0).astype(np.float32))
    w = torch.from_numpy((rng.randn(n, k) * 0.02).astype(np.float32))
    g = torch.from_numpy((rng.randn(m, n) * 0.01).astype(np.float32))
    mask = torch.from_numpy(rng.rand(n, k) < 0.05) if with_mask else None
    thr = ternary_threshold(w, sparsity_target=0.3)
    return x, w, g, mask, fl.scalars(torch.tensor([0.017]), thr)


def test_blend_matches_the_plain_w_eff():
    x, w, _, mask, scal = _inputs(4, 24, 300, True, seed=0)
    for m in (mask, None):
        want = fl._w_eff(w, m, scal[0], scal[1])[0]
        assert torch.equal(_w_eff(w, m, scal), want)


def _pallas_forward(x, w, mask, scal, tm=8, tn=8, tk=128):
    """``_fwd_kernel`` under the Pallas interpreter: grid (M, N, K tiles),
    the K tiles summed into the output block as the TPU kernel does."""
    m, k = x.shape
    n = w.shape[0]
    w_spec = pl.BlockSpec((tn, tk), lambda i, j, t: (j, t))
    in_specs = [pl.BlockSpec((tm, tk), lambda i, j, t: (i, t)), w_spec]
    args = [x, w]
    if mask is not None:
        in_specs.append(w_spec)
        args.append(mask.astype(np.float32))
    in_specs.append(pl.BlockSpec((2,), lambda i, j, t: (0,)))
    args.append(scal)
    body = _fwd_kernel if mask is not None else _fwd_kernel_nomask
    return np.asarray(pl.pallas_call(
        body, out_shape=jax.ShapeDtypeStruct((m, n), jnp.float32),
        grid=(m // tm, n // tn, k // tk), in_specs=in_specs,
        out_specs=pl.BlockSpec((tm, tn), lambda i, j, t: (i, j)),
        interpret=True)(*map(jnp.asarray, args)))


def _pallas_dx(g, w, mask, scal, tm=8, tn=8, tk=128):
    """``_dx_kernel`` under the Pallas interpreter: grid (M, K, N tiles)."""
    m, n = g.shape
    k = w.shape[1]
    w_spec = pl.BlockSpec((tn, tk), lambda i, j, t: (t, j))
    in_specs = [pl.BlockSpec((tm, tn), lambda i, j, t: (i, t)), w_spec]
    args = [g, w]
    if mask is not None:
        in_specs.append(w_spec)
        args.append(mask.astype(np.float32))
    in_specs.append(pl.BlockSpec((2,), lambda i, j, t: (0,)))
    args.append(scal)
    body = _dx_kernel if mask is not None else _dx_kernel_nomask
    return np.asarray(pl.pallas_call(
        body, out_shape=jax.ShapeDtypeStruct((m, k), jnp.float32),
        grid=(m // tm, k // tk, n // tn), in_specs=in_specs,
        out_specs=pl.BlockSpec((tm, tk), lambda i, j, t: (i, j)),
        interpret=True)(*map(jnp.asarray, args)))


@pytest.mark.parametrize("with_mask", [True, False])
@pytest.mark.parametrize("which", ["forward", "dx"])
def test_emulated_kernel_matches_pallas_kernel(which, with_mask):
    x, w, g, mask, scal = _inputs(16, 24, 256, with_mask, seed=7)
    # Four splits of K at this shape: the forward's in-launch sum is run.
    assert fl.forward_splits(16, 24, 256) == (4, 64)
    np_args = (w.numpy(), None if mask is None else mask.numpy(),
               scal.numpy())
    if which == "forward":
        want = _pallas_forward(x.numpy(), *np_args)
        got = _emulate_forward(x, w, mask, scal)
        plain = fl.fused_linear_forward(x, w, mask, scal)
    else:
        want = _pallas_dx(g.numpy(), *np_args)
        got = _emulate_dx(g, w, mask, scal)
        plain = fl.fused_linear_dx(g, w, mask, scal)
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-5, atol=1e-6)
    # The port's plain version (the CPU path, the card's reference) too.
    np.testing.assert_allclose(plain.numpy(), want, rtol=1e-5, atol=1e-6)


def _one_tf32_pass(a, b):
    return _tf32_rna(a) @ _tf32_rna(b)


def _f64_rel_err(got, a, b):
    """The largest error against the float64 a·b, each element's over its
    Σ|a|·|b|, as the card check measures it."""
    a64, b64 = a.double(), b.double()
    scale = a64.abs() @ b64.abs()
    scale = torch.where(scale > 0, scale, torch.ones_like(scale))
    return ((got.double() - a64 @ b64).abs() / scale).max().item()


def _assert_f64_bound_separates(which, x, w, g, mask, scal):
    """The emulated kernel meets F64_REL_TOL; one TF32 pass does not."""
    w_eff = _w_eff(w, mask, scal)
    if which == "forward":
        got = _emulate_forward(x, w, mask, scal)
        a, b = x, w_eff.T
    else:
        got = _emulate_dx(g, w, mask, scal)
        a, b = g, w_eff
    assert _f64_rel_err(got, a, b) <= F64_REL_TOL
    assert _f64_rel_err(_one_tf32_pass(a, b), a, b) > F64_REL_TOL


# The card check's shapes: the recipe's two head layers (with the mask).
@pytest.mark.parametrize("mnk", [(256, 128, 3136), (256, 10, 128)])
@pytest.mark.parametrize("which", ["forward", "dx"])
def test_emulated_kernel_meets_card_tolerance(which, mnk):
    m, n, k = mnk
    x, w, g, mask, scal = _inputs(m, n, k, True, seed=n + k)
    w_eff = _w_eff(w, mask, scal)
    if which == "forward":
        got = _emulate_forward(x, w, mask, scal)
        plain = fl.forward_plain(x, w, mask, scal)
        exact = x.double() @ w_eff.double().T
        one_pass = _one_tf32_pass(x, w_eff.T)
    else:
        got = _emulate_dx(g, w, mask, scal)
        plain = fl.dx_plain(g, w, mask, scal)
        exact = g.double() @ w_eff.double()
        one_pass = _one_tf32_pass(g, w_eff)
    torch.testing.assert_close(got, plain, rtol=FUSED_TOL, atol=FUSED_TOL)
    err = (got.double() - exact).abs().max()
    assert (one_pass.double() - exact).abs().max() > 100 * err
    if which == "forward":
        with pytest.raises(AssertionError):
            torch.testing.assert_close(one_pass, plain, rtol=FUSED_TOL,
                                       atol=FUSED_TOL)
    _assert_f64_bound_separates(which, x, w, g, mask, scal)


@pytest.mark.parametrize("mnk", [(256, 128, 3136), (256, 10, 128)])
@pytest.mark.parametrize("which", ["forward", "dx"])
def test_f64_bound_separates_one_tf32_pass_without_mask(which, mnk):
    m, n, k = mnk
    _assert_f64_bound_separates(which, *_inputs(m, n, k, False,
                                                seed=n + k + 1))


def test_forward_does_not_depend_on_which_split_finishes_last():
    x, w, _, mask, scal = _inputs(64, 64, 3136, True, seed=3)
    parts = _forward_partials(x, w, mask, scal)
    want = _sum_in_order(parts)
    splits = len(parts)
    assert splits == fl.forward_splits(64, 64, 3136)[0] > 8
    rng = np.random.RandomState(0)
    in_finish_order = set()
    for _ in range(20):
        order = rng.permutation(splits)
        written = [None] * splits
        ticket, total = 0, None
        for z in order:  # each block writes its partial, then its ticket
            written[z] = parts[z]
            if ticket == splits - 1:
                total = _sum_in_order(written)  # the last block's sum
            ticket += 1
        assert torch.equal(total, want)
        # What float atomics would do: add the partials as blocks finish.
        in_finish_order.add(_sum_in_order([parts[z] for z in order])
                            .numpy().tobytes())
    assert len(in_finish_order) > 1  # ... which changes from run to run


@pytest.mark.parametrize("mnk", [(256, 128, 3136), (256, 10, 128),
                                 (2304, 128, 3136), (7, 24, 100),
                                 (1, 10, 0)])
def test_forward_splits_cover_k_in_whole_ring_steps(mnk):
    m, n, k = mnk
    splits, chunk = fl.forward_splits(m, n, k)
    tiles = -(-m // 64) * -(-n // 64)
    assert splits * tiles <= max(tiles, 264)
    if splits > 1:
        assert chunk % 32 == 0 and chunk >= 64
        assert (splits - 1) * chunk < k <= splits * chunk
    else:
        assert chunk == k
