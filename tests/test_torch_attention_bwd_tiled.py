"""The arithmetic of the CUDA attention backward (``attn_bwd_rows_kernel``
and ``attn_bwd_keys_kernel`` in atq_tpu_torch/csrc/fused_attention.cu),
emulated in torch on the CPU.

The kernel runs in two passes. Pass 1 takes 32 query rows against all keys
(64 a chunk): s = q·kᵀ·scale + bias and dP = dO·vᵀ, the softmax over whole
rows, delta = rowsum(dP·p32), dS = p32·(dP − delta) rounded to the input
type and dq = dS·k·scale; it keeps three floats a row, (m, l, delta).
Pass 2 takes 64 keys and walks the query rows 32 at a time: s and dP again
by the same function, p32 = exp(s − m) / l from the stored statistics, p
and dS rounded, then dv += pᵀ·dO and dk += dSᵀ·q. Every product is 3xTF32
on the tensor cores (hi = rna(v), lo = rna(v − hi); lo·hi + hi·lo + hi·hi
into a fresh f32 partial for every 8 reduction elements, added to the
running sum), or one TF32 product for bf16 inputs, whose values are TF32
values already. Here:

- the emulated 3xTF32 product matches a float64 product within the split's
  bound, where one TF32 pass would not;
- the emulated two passes match the port's plain version and the JAX
  package's own ``_bwd_kernel`` (through ``jax.vjp`` of
  ``atq_tpu.ops.fused_attention.fused_attention``, which runs the kernel
  in the Pallas interpreter on the CPU) at the tolerances of
  tests/test_torch_fused_attention.py: float32 gradients within rtol 1e-4 /
  atol 1e-5, bfloat16 within 2e-2;
- pass 2's recomputed p32 has pass 1's bits (one function, one reduction
  order, the stored m and l), so dS and p are the operands pass 1 saw;
- a fully padded query row gives finite, uniform p and finite gradients.

Shapes: (2, 3, 50, 20) (S not a multiple of 32 or 64, D not a multiple of
8) and (1, 2, 64, 16), with no bias, a padding bias, and a bias whose first
batch row is fully padded.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from atq_tpu.ops import fused_attention as jfa
from atq_tpu_torch.ops import fused_attention as tfa

ROWS, KEYS, MMA_K = 32, 64, 8  # pass-1 rows and pass-2 step; keys; MMA depth
GUARD = -1e30
SHAPES = [(2, 3, 50, 20), (1, 2, 64, 16)]
KINDS = [None, "lengths", "empty_row"]
DTYPES = {"float32": (torch.float32, jnp.float32),
          "bfloat16": (torch.bfloat16, jnp.bfloat16)}


def _tf32_rna(v):
    """cvt.rna.tf32.f32 on finite float32 values: 10 mantissa bits kept,
    rounded to nearest with ties away from zero (add 0x1000, mask)."""
    bits = v.contiguous().view(torch.int32).to(torch.int64) & 0xFFFFFFFF
    bits = (bits + 0x1000) & 0xFFFFE000
    bits = torch.where(bits >= 2 ** 31, bits - 2 ** 32, bits)
    return bits.to(torch.int32).view(torch.float32)


def _mma(a, b, split):
    """a (R, K) @ b (K, C) as the kernel forms it: per 8 reduction elements
    a fresh partial of lo·hi, then hi·lo, then hi·hi (split), or hi·hi
    alone with hi = the value (a TF32 value already), added to the f32
    running sum."""
    if split:
        ah, bh = _tf32_rna(a), _tf32_rna(b)
        al, bl = _tf32_rna(a - ah), _tf32_rna(b - bh)
    else:
        ah, bh = a, b
    acc = torch.zeros(a.shape[0], b.shape[1], dtype=torch.float32)
    for k0 in range(0, a.shape[1], MMA_K):
        s = slice(k0, k0 + MMA_K)
        if split:
            part = al[:, s] @ bh[s]
            part = part + ah[:, s] @ bl[s]
            part = part + ah[:, s] @ bh[s]
        else:
            part = ah[:, s] @ bh[s]
        acc = acc + part
    return acc


def _softmax_p(s, m, l):
    """p32 = exp(s − m) / l on one 32 x 64 tile: both passes call it on
    tiles of the same shape, so torch takes the same path for each."""
    return torch.exp(s - m) / l


def _rows(x, r0, n):
    """n rows of x from r0, zeros past its end (the kernels' zero fill)."""
    out = torch.zeros(n, x.shape[1], dtype=torch.float32)
    part = x[r0:r0 + n]
    out[:part.shape[0]] = part
    return out


def _emulate(q, k, v, do, scale, bias, dtype):
    """(dq, dk, dv) of the two kernels for one head: q, k, v, do float32
    (S, D) holding values of ``dtype``; bias: float32 (S,) or None. Also
    each pass's p32, (S, S), to compare their bits."""
    split = dtype == torch.float32
    S, D = q.shape
    dc = 64 if D <= 64 else 128  # the kernels pad D with zeros to DC
    sp = -(-S // KEYS) * KEYS
    pad = [torch.nn.functional.pad(x, (0, dc - D)) for x in (q, k, v, do)]
    q, k, v, do = pad
    b = torch.zeros(sp) if bias is None else torch.cat(
        [bias, torch.zeros(sp - S)])
    key_ok = torch.arange(sp) < S

    def rnd(x):
        return x.to(dtype).float()

    def scores(r0, c0, x, y, with_score):
        """The 32 x 64 tile of x·yᵀ (rows r0.., keys c0..), the same
        function in both passes; scaled and biased for s."""
        acc = _mma(_rows(x, r0, ROWS), _rows(y, c0, KEYS).T, split)
        if not with_score:
            return acc
        return acc * scale + b[c0:c0 + KEYS]

    dq = torch.zeros(S, dc)
    stats = torch.zeros(S, 3)
    p1 = torch.zeros(S, S)
    for r0 in range(0, S, ROWS):  # pass 1
        tiles = [scores(r0, c0, q, k, True) for c0 in range(0, sp, KEYS)]
        s = torch.cat(tiles, dim=1)
        dp = torch.cat([scores(r0, c0, do, v, False)
                        for c0 in range(0, sp, KEYS)], dim=1)
        m = torch.clamp(s[:, :S].amax(dim=1, keepdim=True), min=GUARD)
        l = torch.exp(s - m)[:, :S].sum(dim=1, keepdim=True)
        p32 = torch.cat([_softmax_p(t, m, l) for t in tiles], dim=1)
        delta = (dp[:, :S] * p32[:, :S]).sum(dim=1, keepdim=True)
        ds = torch.where(key_ok, rnd(p32 * (dp - delta)), torch.zeros(()))
        acc = _mma(ds, _rows(k, 0, sp), split)
        n = min(ROWS, S - r0)
        dq[r0:r0 + n] = (acc * scale)[:n]
        stats[r0:r0 + n] = torch.cat([m, l, delta], dim=1)[:n]
        p1[r0:r0 + n] = p32[:n, :S]

    dk = torch.zeros(sp, dc)
    dv = torch.zeros(sp, dc)
    p2 = torch.zeros(S, S)
    for k0 in range(0, sp, KEYS):  # pass 2, 64 keys a block
        ps, dss, qs, dos = [], [], [], []
        for r0 in range(0, S, ROWS):  # the query rows in order
            s = scores(r0, k0, q, k, True)
            dp = scores(r0, k0, do, v, False)
            st = _rows(stats, r0, ROWS)
            ok = ((torch.arange(ROWS) + r0 < S)[:, None]
                  & key_ok[k0:k0 + KEYS][None, :])
            m, l, delta = st[:, :1], st[:, 1:2], st[:, 2:]
            p32 = torch.where(ok, _softmax_p(s, m, l), torch.zeros(()))
            ps.append(rnd(p32))
            dss.append(torch.where(ok, rnd(p32 * (dp - delta)),
                                   torch.zeros(())))
            qs.append(_rows(q, r0, ROWS))
            dos.append(_rows(do, r0, ROWS))
            n, kn = min(ROWS, S - r0), min(KEYS, S - k0)
            p2[r0:r0 + n, k0:k0 + kn] = p32[:n, :kn]
        # The kernel's accumulators run over the steps' rows in order.
        dv[k0:k0 + KEYS] = _mma(torch.cat(ps).T, torch.cat(dos), split)
        dk[k0:k0 + KEYS] = _mma(torch.cat(dss).T, torch.cat(qs),
                                split) * scale
    grads = [x[:S, :D].to(dtype) for x in (dq, dk, dv)]
    return grads, p1, p2


def _inputs(shape, kind, dtype, seed=0):
    """numpy-seeded q, k, v, do (rounded to dtype) and the (B, 1, 1, S)
    bias, as torch float32 tensors holding dtype's values."""
    b, _, s, _ = shape
    rng = np.random.RandomState(seed)
    q, k, v, do = (torch.from_numpy(rng.randn(*shape).astype(np.float32))
                   .to(dtype).float() for _ in range(4))
    bias = None
    if kind is not None:
        lengths = rng.randint(1, s + 1, b)
        if kind == "empty_row":
            lengths[0] = 0  # the first batch row: every key padded
        bias = tfa.padding_bias(torch.from_numpy(lengths), s)
    return q, k, v, do, bias


def _emulate_all(shape, kind, dtype):
    q, k, v, do, bias = _inputs(shape, kind, dtype)
    scale = 1.0 / np.sqrt(shape[3])
    out = [[], [], []]
    p_pairs = []
    for bi in range(shape[0]):
        for hi in range(shape[1]):
            brow = None if bias is None else bias[bi, 0, 0]
            grads, p1, p2 = _emulate(q[bi, hi], k[bi, hi], v[bi, hi],
                                     do[bi, hi], scale, brow, dtype)
            for acc, g in zip(out, grads):
                acc.append(g)
            p_pairs.append((p1, p2))
    grads = [torch.stack(x).view(*shape) for x in out]
    return (q, k, v, do, bias, scale), grads, p_pairs


def _tol(dtype):
    return (dict(rtol=1e-4, atol=1e-5) if dtype == torch.float32
            else dict(rtol=2e-2, atol=2e-2))


def test_split_product_has_f32_accuracy():
    rng = np.random.RandomState(3)
    a = torch.from_numpy(rng.randn(32, 64).astype(np.float32))
    b = torch.from_numpy(rng.randn(64, 64).astype(np.float32))
    exact = a.double() @ b.double()
    # 3·2^-22 for the dropped lo·lo and the split, f32 sums over 64 terms.
    bound = (3 * 2.0 ** -22 + 64 * 2.0 ** -24) * (a.double().abs()
                                                  @ b.double().abs())
    assert ((_mma(a, b, True).double() - exact).abs() <= bound).all()
    one_pass = _mma(_tf32_rna(a), _tf32_rna(b), False).double()
    assert ((one_pass - exact).abs() > bound).any()


@pytest.mark.parametrize("dtype", list(DTYPES))
@pytest.mark.parametrize("kind", KINDS)
@pytest.mark.parametrize("shape", SHAPES)
def test_two_passes_match_the_plain_version(shape, kind, dtype):
    tdt = DTYPES[dtype][0]
    (q, k, v, do, bias, scale), grads, _ = _emulate_all(shape, kind, tdt)
    want = tfa.backward_plain(q.to(tdt), k.to(tdt), v.to(tdt), scale, bias,
                              do.to(tdt))
    for name, got, ref in zip("qkv", grads, want):
        assert torch.isfinite(got.float()).all()
        torch.testing.assert_close(got.float(), ref.float(), **_tol(tdt),
                                   msg=lambda m: f"d{name}: {m}")


@pytest.mark.parametrize("dtype", list(DTYPES))
@pytest.mark.parametrize("kind", KINDS)
@pytest.mark.parametrize("shape", SHAPES)
def test_two_passes_match_the_jax_kernel(shape, kind, dtype):
    tdt, jdt = DTYPES[dtype]
    (q, k, v, do, bias, scale), grads, _ = _emulate_all(shape, kind, tdt)
    jbias = None if bias is None else jnp.asarray(bias.numpy())

    def attention(q, k, v):
        return jfa.fused_attention(q, k, v, scale, jbias)

    _, vjp = jax.vjp(attention, *(jnp.asarray(x.numpy(), jdt)
                                  for x in (q, k, v)))
    want = vjp(jnp.asarray(do.numpy(), jdt))
    for name, got, ref in zip("qkv", grads, want):
        np.testing.assert_allclose(got.float().numpy(),
                                   np.asarray(ref, np.float32),
                                   err_msg=f"d{name}", **_tol(tdt))


@pytest.mark.parametrize("kind", KINDS)
@pytest.mark.parametrize("shape", SHAPES)
def test_pass_two_recomputes_pass_one_p32_bit_for_bit(shape, kind):
    _, _, p_pairs = _emulate_all(shape, kind, torch.float32)
    for p1, p2 in p_pairs:
        assert torch.equal(p1.view(torch.int32), p2.view(torch.int32))


@pytest.mark.parametrize("shape", SHAPES)
def test_fully_padded_row_gives_uniform_finite_p(shape):
    (_, _, _, _, bias, _), grads, p_pairs = _emulate_all(
        shape, "empty_row", torch.float32)
    assert bias[0].eq(GUARD).all()  # batch row 0: every key padded
    s = shape[2]
    for p1, p2 in p_pairs[:shape[1]]:  # batch row 0's heads
        for p in (p1, p2):
            assert torch.isfinite(p).all()
            torch.testing.assert_close(p, torch.full_like(p, 1.0 / s))
    for g in grads:
        assert torch.isfinite(g).all()
