"""The arithmetic of the CUDA attention forward (``attn_fwd_kernel`` in
atq_tpu_torch/csrc/fused_attention.cu), emulated in torch on the CPU.

A block takes 64 query rows of one head against all S keys, in three
phases: s = q·kᵀ·scale + bias for the whole rows (K in chunks of 64 keys),
the softmax over whole rows (m = max(rowmax(s), -1e30), e = exp(s − m),
l = Σ e, p = e / l rounded to the input type, 0 past S), and o = p·v (V in
chunks of 64 keys, each chunk's two halves of 32 keys summed apart and
the two sums added at the end) rounded to the input type. Both products are 3xTF32 on
the tensor cores (hi = rna(x), lo = rna(x − hi); lo·hi + hi·lo + hi·hi into
a fresh f32 partial for every 8 reduction elements, added to the running
sum), or one TF32 product for bf16 inputs, whose values are TF32 values
already. Only the steps that D reaches run in the first product, and only
those that a short last chunk's keys reach in the second. Here:

- the emulated forward is within F64_REL_TOL (1e-5, chip_smoke.py's) of a
  float64 forward, each element's error over Σ_j p_j·|v_j|, and the same
  forward with one TF32 pass a product (operands rounded to TF32, one
  product) misses that bound on the same inputs;
- the emulated forward matches the port's plain version and the JAX
  package's own ``_fwd_kernel`` (through
  ``atq_tpu.ops.fused_attention.fused_attention``, which runs it in the
  Pallas interpreter on the CPU) at the tolerances of
  tests/test_torch_fused_attention.py and the card's ATTN_TOL: float32
  within rtol 1e-4 / atol 1e-5, bfloat16 within 2e-2;
- a fully padded batch row gives a uniform, finite p and a finite o;
- the tile constants are the CUDA source's.

Shapes: (2, 3, 50, 20) (S not a multiple of 64 or 8, D not a multiple of
8) and (1, 2, 64, 16), with no bias, a padding bias, and a bias whose first
batch row is fully padded.
"""

import pathlib
import re

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from atq_tpu.ops import fused_attention as jfa
from atq_tpu_torch.ops import fused_attention as tfa

ROWS, KEYS, MMA_K = 64, 64, 8  # query rows a block; keys a chunk; MMA depth
HALF = KEYS // 2  # keys of a chunk in each of o's two sums
GUARD = -1e30
F64_REL_TOL = 1e-5  # chip_smoke.py's bound for the 3xTF32 products
SHAPES = [(2, 3, 50, 20), (1, 2, 64, 16)]
KINDS = [None, "lengths", "empty_row"]
DTYPES = {"float32": (torch.float32, jnp.float32),
          "bfloat16": (torch.bfloat16, jnp.bfloat16)}
SOURCE = (pathlib.Path(__file__).resolve().parent.parent / "atq_tpu_torch"
          / "csrc" / "fused_attention.cu")


def _tf32_rna(v):
    """cvt.rna.tf32.f32 on finite float32 values: 10 mantissa bits kept,
    rounded to nearest with ties away from zero (add 0x1000, mask)."""
    bits = v.contiguous().view(torch.int32).to(torch.int64) & 0xFFFFFFFF
    bits = (bits + 0x1000) & 0xFFFFE000
    bits = torch.where(bits >= 2 ** 31, bits - 2 ** 32, bits)
    return bits.to(torch.int32).view(torch.float32)


def _mma(a, b, passes):
    """a (R, K) @ b (K, C) as the kernel forms it, K a multiple of 8: per 8
    reduction elements a fresh partial, added to the f32 running sum in
    order. passes 3: lo·hi, then hi·lo, then hi·hi (3xTF32); 1: hi·hi alone
    with hi = the value (a TF32 value: bf16 inputs, or the one-pass
    control's rounded operands)."""
    if passes == 3:
        ah, bh = _tf32_rna(a), _tf32_rna(b)
        al, bl = _tf32_rna(a - ah), _tf32_rna(b - bh)
    else:
        ah, bh = a, b
    acc = torch.zeros(a.shape[0], b.shape[1], dtype=torch.float32)
    for k0 in range(0, a.shape[1], MMA_K):
        s = slice(k0, k0 + MMA_K)
        if passes == 3:
            part = al[:, s] @ bh[s]
            part = part + ah[:, s] @ bl[s]
            part = part + ah[:, s] @ bh[s]
        else:
            part = ah[:, s] @ bh[s]
        acc = acc + part
    return acc


def _rows(x, r0, n, cols):
    """n rows of x from r0 and its first ``cols`` columns, zeros past its
    end (the ring's zero fill)."""
    out = torch.zeros(n, cols, dtype=torch.float32)
    part = x[r0:r0 + n, :cols]
    out[:part.shape[0], :part.shape[1]] = part
    return out


def _emulate(q, k, v, scale, bias, dtype, passes=None):
    """o of the kernel for one head, and its p: q, k, v float32 (S, D)
    holding values of ``dtype``; bias float32 (S,) or None. ``passes``
    (default: 3 for float32, 1 for bf16) sets the products; with 1 on
    float32 inputs, every operand is rounded to TF32 first (the one-pass
    control)."""
    if passes is None:
        passes = 3 if dtype == torch.float32 else 1
    one_pass_f32 = passes == 1 and dtype == torch.float32

    def operand(x):
        return _tf32_rna(x) if one_pass_f32 else x

    S, D = q.shape
    dr = -(-D // MMA_K) * MMA_K  # the steps over d that D reaches
    sp = -(-S // KEYS) * KEYS
    b = torch.zeros(sp) if bias is None else torch.cat(
        [bias, torch.zeros(sp - S)])
    o = torch.zeros(S, D)
    p_all = torch.zeros(S, S)
    for r0 in range(0, S, ROWS):
        qr = operand(_rows(q, r0, ROWS, dr))
        # 1. the scores, chunk by chunk (a tile wholly past S is skipped;
        # its columns are overwritten by the softmax's zeros).
        s = torch.zeros(ROWS, sp)
        for c0 in range(0, sp, KEYS):
            kc = operand(_rows(k, c0, KEYS, dr))
            s[:, c0:c0 + KEYS] = _mma(qr, kc.T, passes) * scale \
                + b[c0:c0 + KEYS]
        # 2. the softmax over whole rows.
        m = torch.clamp(s[:, :S].amax(dim=1, keepdim=True), min=GUARD)
        e = torch.exp(s[:, :S] - m)
        p = torch.zeros(ROWS, sp)
        p[:, :S] = (e / e.sum(dim=1, keepdim=True)).to(dtype).float()
        # 3. o = p·v, 8 keys a step, as two sums over the two halves of
        # every chunk's keys (those that S reaches), added at the end.
        kr = -(-S // MMA_K) * MMA_K
        vr = operand(_rows(v, 0, kr, D))
        pr = operand(p[:, :kr])
        halves = []
        for h in (0, 1):
            keys = [i for c0 in range(0, sp, KEYS)
                    for i in range(c0 + h * HALF, c0 + (h + 1) * HALF)
                    if i < kr]
            halves.append(_mma(pr[:, keys], vr[keys], passes) if keys
                          else torch.zeros(ROWS, D))
        n = min(ROWS, S - r0)
        o[r0:r0 + n] = (halves[0] + halves[1])[:n].to(dtype).float()
        p_all[r0:r0 + n] = p[:n, :S]
    return o, p_all


def _inputs(shape, kind, dtype, seed=0):
    """numpy-seeded q, k, v (rounded to dtype) and the (B, 1, 1, S) bias, as
    torch float32 tensors holding dtype's values."""
    b, _, s, _ = shape
    rng = np.random.RandomState(seed)
    q, k, v = (torch.from_numpy(rng.randn(*shape).astype(np.float32))
               .to(dtype).float() for _ in range(3))
    bias = None
    if kind is not None:
        lengths = rng.randint(1, s + 1, b)
        if kind == "empty_row":
            lengths[0] = 0  # the first batch row: every key padded
        bias = tfa.padding_bias(torch.from_numpy(lengths), s)
    return q, k, v, bias


def _emulate_all(shape, kind, dtype, passes=None):
    q, k, v, bias = _inputs(shape, kind, dtype)
    scale = 1.0 / np.sqrt(shape[3])
    outs, ps = [], []
    for bi in range(shape[0]):
        for hi in range(shape[1]):
            brow = None if bias is None else bias[bi, 0, 0]
            o, p = _emulate(q[bi, hi], k[bi, hi], v[bi, hi], scale, brow,
                            dtype, passes)
            outs.append(o)
            ps.append(p)
    return (q, k, v, bias, scale), torch.stack(outs).view(*shape), ps


def _assert_f64_bound(got, q, k, v, scale, bias):
    """got's largest error against a float64 forward on the same float32
    inputs, each element's over its Σ_j p_j·|v_j| (p in float64), must be
    within F64_REL_TOL. Returns it."""
    s = torch.matmul(q.double(), k.double().transpose(-1, -2)) * scale
    if bias is not None:
        s = s + bias.double()
    # The guard as the kernel holds it, in float32 (below -1e30 in float64,
    # and equal to the padding bias, so a fully padded row stays uniform).
    m = torch.clamp(s.amax(dim=-1, keepdim=True), min=float(np.float32(GUARD)))
    e = torch.exp(s - m)
    p = e / e.sum(dim=-1, keepdim=True)
    o = torch.matmul(p, v.double())
    err = ((got.double() - o).abs()
           / torch.matmul(p, v.double().abs())).max().item()
    assert err <= F64_REL_TOL, f"{err} of Σ p|v| from float64"
    return err


def _tol(dtype):
    return (dict(rtol=1e-4, atol=1e-5) if dtype == torch.float32
            else dict(rtol=2e-2, atol=2e-2))


def test_constants_are_the_kernels():
    text = SOURCE.read_text()
    fwd = text[text.index("namespace fwd {"):]
    fwd = fwd[:fwd.index("}  // namespace fwd")]
    consts = dict(re.findall(r"constexpr int (k\w+) = (\d+);", fwd))
    assert (int(consts["kRows"]), int(consts["kKeys"])) == (ROWS, KEYS)
    assert "constexpr int kHalf = kKeys / 2;" in fwd


@pytest.mark.parametrize("kind", KINDS)
@pytest.mark.parametrize("shape", SHAPES)
def test_forward_meets_the_float64_bound(shape, kind):
    (q, k, v, bias, scale), o, _ = _emulate_all(shape, kind, torch.float32)
    _assert_f64_bound(o, q, k, v, scale, bias)


@pytest.mark.parametrize("kind", KINDS)
@pytest.mark.parametrize("shape", SHAPES)
def test_one_tf32_pass_misses_the_float64_bound(shape, kind):
    # The planted fault: each product as one TF32 pass. The bound must
    # tell it from 3xTF32 on the same inputs.
    (q, k, v, bias, scale), o, _ = _emulate_all(shape, kind, torch.float32,
                                                passes=1)
    with pytest.raises(AssertionError):
        _assert_f64_bound(o, q, k, v, scale, bias)


@pytest.mark.parametrize("dtype", list(DTYPES))
@pytest.mark.parametrize("kind", KINDS)
@pytest.mark.parametrize("shape", SHAPES)
def test_forward_matches_the_plain_version(shape, kind, dtype):
    tdt = DTYPES[dtype][0]
    (q, k, v, bias, scale), o, _ = _emulate_all(shape, kind, tdt)
    want = tfa.forward_plain(q.to(tdt), k.to(tdt), v.to(tdt), scale, bias)
    assert torch.isfinite(o).all()
    torch.testing.assert_close(o, want.float(), **_tol(tdt))


@pytest.mark.parametrize("dtype", list(DTYPES))
@pytest.mark.parametrize("kind", KINDS)
@pytest.mark.parametrize("shape", SHAPES)
def test_forward_matches_the_jax_kernel(shape, kind, dtype):
    tdt, jdt = DTYPES[dtype]
    (q, k, v, bias, scale), o, _ = _emulate_all(shape, kind, tdt)
    jbias = None if bias is None else jnp.asarray(bias.numpy())
    want = jfa.fused_attention(*(jnp.asarray(x.numpy(), jdt)
                                 for x in (q, k, v)), scale, jbias)
    np.testing.assert_allclose(o.numpy(), np.asarray(want, np.float32),
                               **_tol(tdt))


@pytest.mark.parametrize("dtype", list(DTYPES))
@pytest.mark.parametrize("shape", SHAPES)
def test_fully_padded_row_gives_uniform_finite_p(shape, dtype):
    tdt = DTYPES[dtype][0]
    (_, _, _, bias, _), o, ps = _emulate_all(shape, "empty_row", tdt)
    assert bias[0].eq(GUARD).all()  # batch row 0: every key padded
    s = shape[2]
    for p in ps[:shape[1]]:  # batch row 0's heads
        assert torch.isfinite(p).all()
        want = torch.full_like(p, 1.0 / s).to(tdt).float()
        torch.testing.assert_close(p, want, rtol=0, atol=0)
    assert torch.isfinite(o).all()
