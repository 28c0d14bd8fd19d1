"""The arithmetic of the CUDA dW/dalpha kernel (``dwda_kernel`` in
atq_tpu_torch/csrc/fused_linear.cu), emulated in torch on the CPU.

The kernel forms G = gᵀx on the tensor cores as 3xTF32: each f32 operand
value v is split into hi = cvt.rna.tf32(v) and lo = cvt.rna.tf32(v − hi),
and mma.sync sums lo·hi + hi·lo + hi·hi into a fresh f32 partial (lo·lo
dropped), 8 batch rows an MMA step, which joins the running sum by one
add (step sums); of every 32 batch rows, rows 0-15 go into one warp
group's accumulators and rows 16-31 into another's, added at the end. dalpha is
summed in a fixed order inside each 64 x 32 block, written to the block's
slot, and the last block to finish adds the slots in index order. Here:

- cvt.rna.tf32 is round to nearest, ties away, on the bits (add 0x1000,
  mask 0xFFFFE000), held against a float64 rounding; hi + lo gives v back
  within 2^-21·|v|;
- the three products match a float64 G within the bound of the split and
  of f32 summation, (3·2^-22 + 3M·2^-24)·(|g|ᵀ|x|), where one TF32 pass
  would be far off;
- the emulated kernel (dw and dalpha, every variant) matches the JAX
  package's own ``_dwda_kernel`` / ``_dwda_kernel_nomask`` run by the Pallas
  interpreter within rtol 1e-5 / atol 1e-6 on dw and 1e-5 relative on
  dalpha; ``_pallas_dwda`` passes no ``interpret=`` and cannot run on the
  CPU, so the test wraps the kernel body in its own ``pl.pallas_call``;
- at the card's shapes the emulation meets the card check's tolerance
  against the port's plain version (rtol/atol 1e-4 on dw, 1e-4 relative
  on dalpha), and G meets the card check's bound on the error against
  float64 over Σ|g||x| (1e-5), which one TF32 pass misses;
- the dalpha sum does not depend on the order in which blocks finish.
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental import pallas as pl

from atq_tpu.ops.fused_linear import _dwda_kernel, _dwda_kernel_nomask
from atq_tpu_torch.core.quantize import ternary_threshold
from atq_tpu_torch.ops import fused_linear as fl

TILE_N, TILE_K, MMA_K = 64, 32, 8  # the kernel's block tile; rows an MMA
STEP, GROUPS = 32, 2  # batch rows a ring stage; warp groups splitting it
N_THREADS = 256


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


def _g_3xtf32(g, x):
    """G = gᵀx as the kernel forms it: per 8 batch rows, lo·hi, hi·lo and
    hi·hi summed into a fresh f32 partial that is added to the f32
    accumulators, one set a warp group (rows 0-15 of every 32 in group 0,
    rows 16-31 in group 1), then group 0 + group 1."""
    gh, gl = _split(g)
    xh, xl = _split(x)
    acc = [torch.zeros(g.shape[1], x.shape[1], dtype=torch.float32)
           for _ in range(GROUPS)]
    for m0 in range(0, g.shape[0], MMA_K):
        s, h = slice(m0, m0 + MMA_K), (m0 % STEP) // (STEP // GROUPS)
        part = gl[s].T @ xh[s]
        part = part + gh[s].T @ xl[s]
        part = part + gh[s].T @ xh[s]
        acc[h] = acc[h] + part
    return acc[0] + acc[1]


def _block_partials(c):
    """The slots: each block's dalpha partial in the kernel's order. Lane
    (g, t) of warp (wa, wb) adds its 4 x 4 values (rows 4g + i, cols 4t + j
    of the warp's 32 x 16) in order; a butterfly over the 32 lanes; warp
    group 0's 4 warps in order (group 1 hands its sums over before)."""
    n, k = c.shape
    gy, gx = -(-n // TILE_N), -(-k // TILE_K)
    pad = np.zeros((gy * TILE_N, gx * TILE_K), np.float32)
    pad[:n, :k] = c
    # rows: (by, wa, g, i); cols: (bx, wb, t, j)
    v = pad.reshape(gy, 2, 8, 4, gx, 2, 4, 4).transpose(0, 4, 1, 5, 2, 6, 3, 7)
    part = np.zeros(v.shape[:6], np.float32)  # (by, bx, wa, wb, g, t)
    for i in range(4):
        for j in range(4):
            part = part + v[..., i, j]
    lanes = part.reshape(gy, gx, 4, 32)  # warp = 2·wa + wb, lane = 4g + t
    for o in (16, 8, 4, 2, 1):
        lanes = lanes + lanes[..., np.arange(32) ^ o]
    warps = lanes[..., 0]
    block = warps[..., 0]
    for w in range(1, 4):
        block = block + warps[..., w]
    return block.reshape(-1)  # slot = by·gx + bx


def _sum_slots(slots):
    """The last block's sum: thread tid adds slots tid, tid + 256, ... in
    order, then a tree over the 256 threads."""
    red = np.zeros(N_THREADS, np.float32)
    for i in range(0, len(slots), N_THREADS):
        chunk = slots[i:i + N_THREADS]
        red[:len(chunk)] = red[:len(chunk)] + chunk
    h = N_THREADS // 2
    while h:
        red[:h] = red[:h] + red[h:2 * h]
        h //= 2
    return red[0]


def _emulate(g, x, w, mask, scal, ste):
    """(dw, dalpha, slots) of the kernel, from torch float32 inputs."""
    alpha, thr = scal[0], scal[1]
    G = _g_3xtf32(g, x)
    wt = fl._ternarize(w, thr)
    if mask is None:
        dw = G * alpha if ste else torch.zeros_like(G)
        c = G * wt
    else:
        m = mask.float()
        inv_m = 1.0 - m
        dw = G * (alpha * inv_m + m) if ste else G * m
        c = G * wt * inv_m
    slots = _block_partials(c.numpy())
    return dw, _sum_slots(slots), slots


def _inputs(m, n, k, with_mask, seed):
    """Head-layer inputs as the card check draws them: post-ReLU x, a small
    weight, the quantizer's threshold at sparsity 0.3, alpha 0.017."""
    rng = np.random.RandomState(seed)
    x = torch.from_numpy(np.maximum(rng.randn(m, k), 0).astype(np.float32))
    w = torch.from_numpy((rng.randn(n, k) * 0.02).astype(np.float32))
    g = torch.from_numpy((rng.randn(m, n) * 0.01).astype(np.float32))
    mask = torch.from_numpy(rng.rand(n, k) < 0.05) if with_mask else None
    thr = ternary_threshold(w, sparsity_target=0.3)
    return g, x, w, mask, fl.scalars(torch.tensor([0.017]), thr)


def test_tf32_rounding_is_nearest_ties_away():
    rng = np.random.RandomState(0)
    v = (rng.randn(4096) * 10.0 ** rng.uniform(-30, 30, 4096)).astype(
        np.float32)
    # exact ties: the 13 dropped bits are 1 followed by zeros
    ties = ((v.view(np.int32) & ~0x1FFF) | 0x1000).view(np.float32)
    v = np.concatenate([v, ties])
    got = _tf32_rna(torch.from_numpy(v)).numpy().astype(np.float64)
    a = np.abs(v.astype(np.float64))
    q = 2.0 ** (np.floor(np.log2(a)) - 10)  # the tf32 spacing at |v|
    want = np.sign(v) * np.floor(a / q + 0.5) * q
    np.testing.assert_array_equal(got, want)
    assert (np.abs(got[-4096:]) > np.abs(v[-4096:])).all()  # ties: away


def test_split_reconstructs_within_2_pow_minus_21():
    rng = np.random.RandomState(1)
    v = torch.from_numpy((rng.randn(64, 300) * 10.0 ** rng.uniform(
        -30, 30, (64, 300))).astype(np.float32))
    hi, lo = _split(v)
    for t in (hi, lo):  # tf32 values: the low 13 bits are zero
        assert not (t.view(torch.int32) & 0x1FFF).any()
    err = (hi.double() + lo.double() - v.double()).abs()
    assert (err <= 2.0 ** -21 * v.double().abs()).all()
    assert (lo.abs() <= 2.0 ** -11 * v.abs()).all()


@pytest.mark.parametrize("mnk", [(16, 24, 256), (256, 128, 3136)])
def test_3xtf32_product_matches_float64(mnk):
    m, n, k = mnk
    g, x, _, _, _ = _inputs(m, n, k, False, seed=m + n)
    want = g.double().T @ x.double()
    err = (_g_3xtf32(g, x).double() - want).abs()
    bound = (3 * 2.0 ** -22 + 3 * m * 2.0 ** -24) * (g.double().abs().T
                                                     @ x.double().abs())
    assert (err <= bound).all()
    # One TF32 pass (hi·hi) would be three orders of magnitude off.
    gh, xh = _tf32_rna(g), _tf32_rna(x)
    one_pass = (gh.T @ xh).double()
    assert (one_pass - want).abs().max() > 100 * err.max()


def _pallas_dwda(g, x, w, mask, scal, ste, tn=8, tk=128):
    """The JAX package's kernel body under the Pallas interpreter, with
    plain BlockSpecs: g (m, tn), x (m, tk), w and the mask (tn, tk), the
    scalars a (2,) block, dw (tn, tk) and dalpha (1, 1)."""
    m, n = g.shape
    k = x.shape[1]
    tile = pl.BlockSpec((tn, tk), lambda j, i: (i, j))
    in_specs = [pl.BlockSpec((m, tn), lambda j, i: (0, i)),
                pl.BlockSpec((m, tk), lambda j, i: (0, j)), tile]
    args = [g, x, w]
    if mask is not None:
        in_specs.append(tile)
        args.append(mask.astype(np.float32))
    in_specs.append(pl.BlockSpec((2,), lambda j, i: (0,)))
    args.append(scal)
    body = _dwda_kernel if mask is not None else _dwda_kernel_nomask
    dw, da = pl.pallas_call(
        functools.partial(body, ste=ste),
        out_shape=(jax.ShapeDtypeStruct((n, k), jnp.float32),
                   jax.ShapeDtypeStruct((1, 1), jnp.float32)),
        grid=(k // tk, n // tn), in_specs=in_specs,
        out_specs=(tile, pl.BlockSpec((1, 1), lambda j, i: (0, 0))),
        interpret=True)(*map(jnp.asarray, args))
    return np.asarray(dw), float(np.asarray(da)[0, 0])


@pytest.mark.parametrize("with_mask", [True, False])
@pytest.mark.parametrize("ste", [False, True])
def test_emulated_kernel_matches_pallas_dwda_kernel(with_mask, ste):
    g, x, w, mask, scal = _inputs(16, 24, 256, with_mask, seed=7)
    want_dw, want_da = _pallas_dwda(
        g.numpy(), x.numpy(), w.numpy(),
        None if mask is None else mask.numpy(), scal.numpy(), ste)
    dw, da, _ = _emulate(g, x, w, mask, scal, ste)
    np.testing.assert_allclose(dw.numpy(), want_dw, rtol=1e-5, atol=1e-6)
    assert abs(da - want_da) <= 1e-5 * abs(want_da)
    if mask is None and not ste:
        assert not want_dw.any() and not dw.any()
    # The port's plain version (the CPU path, the card's reference) too.
    dw_p, da_p = fl.fused_linear_dwda(g, x, w, mask, scal, ste)
    np.testing.assert_allclose(dw_p.numpy(), want_dw, rtol=1e-5, atol=1e-6)
    assert abs(da_p.item() - want_da) <= 1e-5 * abs(want_da)


# The card check's shapes: the recipe's two head layers, ragged N, K and M,
# and a batch past the JAX package's resident limit.
@pytest.mark.parametrize("mnk", [(256, 128, 3136), (256, 10, 128),
                                 (7, 24, 100), (1, 10, 200),
                                 (2304, 128, 3136)])
def test_emulated_kernel_meets_card_tolerance(mnk):
    m, n, k = mnk
    g, x, w, mask, scal = _inputs(m, n, k, True, seed=n + k)
    for ste in (False, True):
        dw, da, _ = _emulate(g, x, w, mask, scal, ste)
        dw_p, da_p = fl.dwda_plain(g, x, w, mask, scal, ste)
        torch.testing.assert_close(dw, dw_p, rtol=1e-4, atol=1e-4)
        assert abs(da - da_p.item()) <= 1e-4 * abs(da_p.item())
    # The card check's bound on G's error against float64 over Σ|g||x|
    # (chip_smoke.py's F64_REL_TOL, 1e-5): met here, missed by one TF32
    # pass.
    g64, x64 = g.double(), x.double()
    want, scale = g64.T @ x64, g64.abs().T @ x64.abs()
    scale = torch.where(scale > 0, scale, torch.ones_like(scale))
    one_pass = _tf32_rna(g).T @ _tf32_rna(x)
    assert ((_g_3xtf32(g, x) - want).abs() / scale).max() <= 1e-5
    assert ((one_pass.double() - want).abs() / scale).max() > 1e-5


def test_dalpha_does_not_depend_on_which_block_finishes_last():
    g, x, w, mask, scal = _inputs(256, 128, 3136, True, seed=3)
    _, da, slots = _emulate(g, x, w, mask, scal, False)
    assert len(slots) == 2 * 98  # 196 blocks at the recipe's weight
    rng = np.random.RandomState(0)
    in_finish_order = set()
    for _ in range(20):
        order = rng.permutation(len(slots))
        written = np.full(len(slots), np.nan, np.float32)
        ticket, total = 0, None
        for b in order:  # each block writes its slot, then takes a ticket
            written[b] = slots[b]
            if ticket == len(slots) - 1:
                total = _sum_slots(written)  # the last block's sum
            ticket += 1
        assert total.view(np.int32) == np.float32(da).view(np.int32)
        # What float atomics would do: add the partials as blocks finish.
        acc = np.float32(0)
        for b in order:
            acc = np.float32(acc + slots[b])
        in_finish_order.add(int(acc.view(np.int32)))
    assert len(in_finish_order) > 1  # ... which changes from run to run
    want = float(np.sum(slots.astype(np.float64)))
    assert abs(float(da) - want) <= 1e-6 * abs(want)
