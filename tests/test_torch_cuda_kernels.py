"""The port's CUDA kernels against their plain PyTorch versions, on the card.

Every test here needs an NVIDIA GPU (the kernels have no CPU mode) and
skips without one. The file imports neither JAX nor the JAX package, so it
also runs on a machine without them; there, skip the JAX-importing
conftest:

    python -m pytest --noconftest -q -m cuda tests/test_torch_cuda_kernels.py

Tolerances: the order statistic is bit-exact (max equal, sum within
rtol 1e-6); the packed matmuls (uint8 planes, planar32 words, and the fused
RPB correction) are held to rtol 1e-5 / atol 5e-3, the JAX package's own
kernel tolerance (tests/test_pallas_interpret.py), and repeat bit for bit.
"""

import numpy as np
import pytest
import torch

from atq_tpu_torch.core.packing import pack_planar
from atq_tpu_torch.core.quantize import ternary_threshold
from atq_tpu_torch.ops.order_stat import (
    order_statistic_plain,
    order_statistic_reductions,
)
from atq_tpu_torch.ops.ternary_matmul import (
    ternary_matmul_plain,
    ternary_matmul_planar,
)

pytestmark = pytest.mark.cuda

MM_RTOL, MM_ATOL = 1e-5, 5e-3


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the CUDA kernels have no CPU mode")
    from atq_tpu_torch.utils.platform import resolve_device

    return resolve_device("cuda")  # also turns TF32 off


def _abs_input(kind, n, seed=0):
    rng = np.random.RandomState(seed)
    if kind == "zeros":
        return torch.zeros(n)
    if kind == "dups":
        return torch.from_numpy((rng.randint(0, 6, n) / 4.0).astype(
            np.float32))
    return torch.from_numpy(np.abs(rng.randn(n)).astype(np.float32))


@pytest.mark.parametrize("kind,n", [("randn", 401408), ("randn", 16385),
                                    ("dups", 100000), ("zeros", 20000)])
def test_order_stat_bit_exact_vs_plain(cuda, kind, n):
    x = _abs_input(kind, n).to(cuda)
    for r in sorted({0, 1, int(np.floor(np.float32(0.3) * np.float32(n))),
                     n - 1}):
        rank = torch.tensor([r], dtype=torch.int32, device=cuda)
        got = torch.stack(order_statistic_reductions(x, rank)).cpu()
        want = torch.stack(order_statistic_plain(x, rank)).cpu()
        assert got[0].view(torch.int32) == want[0].view(torch.int32), r
        assert got[1] == want[1]
        assert abs(got[2] - want[2]) <= 1e-6 * abs(want[2])


def test_order_stat_counts_launches_and_rejects_bad_cuda_input(cuda):
    x = _abs_input("randn", 20000).to(cuda)
    rank = torch.tensor([5], dtype=torch.int32, device=cuda)
    before = order_statistic_reductions.launches
    order_statistic_reductions(x, rank)
    assert order_statistic_reductions.launches == before + 1
    with pytest.raises(ValueError):  # no silent fallback for CUDA tensors
        order_statistic_reductions(x.double(), rank)
    with pytest.raises(ValueError):
        order_statistic_reductions(x[::2], rank)


def test_threshold_on_cuda_equals_cpu(cuda):
    w = torch.from_numpy((np.random.RandomState(1).randn(128, 3136) * 0.02)
                         .astype(np.float32))
    for s in (0.0, 0.3, 1.0):
        got = ternary_threshold(w.to(cuda), sparsity_target=s).cpu()
        want = ternary_threshold(w, sparsity_target=s)
        if s == 0.0:  # idx == 0: a mean, summed in another order
            torch.testing.assert_close(got, want, rtol=1e-6, atol=0)
        else:
            assert got.view(torch.int32) == want.view(torch.int32)


@pytest.mark.parametrize("mnk", [(1, 128, 3136), (32, 128, 3136),
                                 (32, 10, 128), (7, 256, 3136),
                                 (128, 128, 8704)])
def test_matmul_matches_plain(cuda, mnk):
    m, n, k = mnk
    g = torch.Generator().manual_seed(k)
    w = torch.randint(-1, 2, (n, k), generator=g).float().to(cuda)
    planes = pack_planar(w)
    x = (torch.randn(m, k, generator=g) * 0.1).to(cuda)
    for avec, asym in (((0.9, 0.9), False), ((0.9, 0.4), True)):
        avec = torch.tensor(avec, device=cuda)
        got = ternary_matmul_planar(x, planes, k, avec, asym)
        want = ternary_matmul_plain(x, planes, k, avec, asym)
        torch.testing.assert_close(got, want, rtol=MM_RTOL, atol=MM_ATOL)


def test_matmul_counts_launches_and_rejects_bad_cuda_input(cuda):
    w = torch.randint(-1, 2, (16, 512)).float().to(cuda)
    planes = pack_planar(w)
    x = torch.randn(4, 512, device=cuda)
    avec = torch.tensor([1.0, 1.0], device=cuda)
    before = ternary_matmul_planar.launches
    ternary_matmul_planar(x, planes, 512, avec)
    assert ternary_matmul_planar.launches == before + 1
    with pytest.raises(ValueError):
        ternary_matmul_planar(x.double(), planes, 512, avec)
    with pytest.raises(ValueError):  # planes on the CPU, x on the card
        ternary_matmul_planar(x, planes.cpu(), 512, avec)


# Fused ternarize+blend matmul (csrc/fused_linear.cu): y, dx, dw within
# rtol/atol 1e-4 of the plain versions (f32 sums in another order than
# cuBLAS over K = 3136), dalpha within 1e-4 relative (summed over N·K in
# another order); the pattern itself is bit-exact by construction.
FUSED_SHAPES = [(256, 128, 3136), (256, 10, 128), (7, 24, 100),
                (2304, 128, 3136)]


def _fused_inputs(cuda, m, n, k, with_mask, seed=0):
    from atq_tpu_torch.core.quantize import ternary_threshold
    from atq_tpu_torch.ops.fused_linear import scalars

    rng = np.random.RandomState(seed)
    x = torch.from_numpy(np.maximum(rng.randn(m, k), 0).astype(np.float32))
    w = torch.from_numpy((rng.randn(n, k) * 0.02).astype(np.float32))
    g = torch.from_numpy((rng.randn(m, n) * 0.01).astype(np.float32))
    mask = torch.from_numpy(rng.rand(n, k) < 0.05) if with_mask else None
    thr = ternary_threshold(w, sparsity_target=0.3)
    scal = scalars(torch.tensor([0.017]), thr)
    to = (lambda t: None if t is None else t.to(cuda))
    return to(x), to(w), to(g), to(mask), to(scal)


@pytest.mark.parametrize("mnk", FUSED_SHAPES)
@pytest.mark.parametrize("with_mask", [True, False])
def test_fused_linear_kernels_match_plain(cuda, mnk, with_mask):
    from atq_tpu_torch.ops import fused_linear as fl

    m, n, k = mnk
    x, w, g, mask, scal = _fused_inputs(cuda, m, n, k, with_mask)
    torch.testing.assert_close(fl.fused_linear_forward(x, w, mask, scal),
                               fl.forward_plain(x, w, mask, scal),
                               rtol=1e-4, atol=1e-4)
    torch.testing.assert_close(fl.fused_linear_dx(g, w, mask, scal),
                               fl.dx_plain(g, w, mask, scal),
                               rtol=1e-4, atol=1e-4)
    for ste in (False, True):
        dw, da = fl.fused_linear_dwda(g, x, w, mask, scal, ste)
        dw_p, da_p = fl.dwda_plain(g, x, w, mask, scal, ste)
        torch.testing.assert_close(dw, dw_p, rtol=1e-4, atol=1e-4)
        assert abs(da.item() - da_p.item()) <= 1e-4 * abs(da_p.item())
        if mask is None and not ste:
            assert not dw.any()  # parity, no mask: exact zeros


def test_fused_linear_counts_launches_and_rejects_bad_cuda_input(cuda):
    from atq_tpu_torch.ops import fused_linear as fl

    x, w, g, mask, scal = _fused_inputs(cuda, 8, 16, 64, True)
    before = (fl.fused_linear_forward.launches, fl.fused_linear_dx.launches,
              fl.fused_linear_dwda.launches)
    fl.fused_linear_forward(x, w, mask, scal)
    fl.fused_linear_dx(g, w, mask, scal)
    fl.fused_linear_dwda(g, x, w, mask, scal, True)
    after = (fl.fused_linear_forward.launches, fl.fused_linear_dx.launches,
             fl.fused_linear_dwda.launches)
    assert after == tuple(b + 1 for b in before)
    with pytest.raises(ValueError):  # no silent fallback for CUDA tensors
        fl.fused_linear_forward(x.double(), w, mask, scal)
    with pytest.raises(ValueError):  # weight on the CPU, input on the card
        fl.fused_linear_dx(g, w.cpu(), mask, scal)


def test_fused_autograd_op_on_cuda_equals_cpu(cuda):
    from atq_tpu_torch.ops.fused_linear import fused_quantized_linear

    x, w, g, mask, scal = _fused_inputs(cuda, 32, 24, 300, True, seed=3)
    thr, alpha = scal[1].cpu(), torch.tensor([0.017])
    out = {}
    for dev in ("cpu", cuda):
        xs, ws, a = (t.detach().to(dev).clone().requires_grad_()
                     for t in (x, w, alpha))
        y = fused_quantized_linear(xs, ws, a, thr.to(dev), mask.to(dev),
                                   grad_mode="ste")
        (y * g.to(dev)).sum().backward()
        out[str(dev)] = [t.detach().cpu() for t in (y, xs.grad, ws.grad,
                                                    a.grad)]
    for got, want in zip(out[str(cuda)], out["cpu"]):
        torch.testing.assert_close(got, want, rtol=1e-4, atol=1e-5)


# Batched order statistic (csrc/order_stat.cu with a row index): every row's
# statistic and max bit-exact against the per-row sort, each row's sum within
# rtol 1e-6.
@pytest.mark.parametrize("lead,n", [(3, 16385), (12, 589824), (2, 2359296)])
def test_batched_order_stat_bit_exact_vs_plain(cuda, lead, n):
    from atq_tpu_torch.ops.order_stat import (
        order_statistic_batched_plain,
        order_statistic_reductions_batched,
    )

    rng = np.random.RandomState(lead)
    x = torch.from_numpy(np.abs(rng.randn(lead, n)).astype(np.float32))
    x[0] = torch.from_numpy((rng.randint(0, 6, n) / 4.0).astype(np.float32))
    x = x.to(cuda)
    picks = [0, n - 1, int(np.floor(np.float32(0.3) * np.float32(n))), 1]
    ranks = torch.tensor([picks[i % 4] for i in range(lead)],
                         dtype=torch.int32, device=cuda)
    before = order_statistic_reductions_batched.launches
    got = torch.stack(order_statistic_reductions_batched(x, ranks)).cpu()
    assert order_statistic_reductions_batched.launches == before + 1
    want = torch.stack(order_statistic_batched_plain(x, ranks)).cpu()
    assert torch.equal(got[0].view(torch.int32), want[0].view(torch.int32))
    assert torch.equal(got[1], want[1])
    torch.testing.assert_close(got[2], want[2], rtol=1e-6, atol=0)


def test_batched_order_stat_rejects_bad_cuda_input(cuda):
    from atq_tpu_torch.ops.order_stat import (
        order_statistic_reductions_batched,
    )

    x = torch.rand(4, 20000, device=cuda)
    ranks = torch.zeros(4, dtype=torch.int32, device=cuda)
    with pytest.raises(ValueError):
        order_statistic_reductions_batched(x.double(), ranks)
    with pytest.raises(ValueError):
        order_statistic_reductions_batched(x[:, ::2], ranks)
    with pytest.raises(ValueError):
        order_statistic_reductions_batched(x, ranks[:3])


# Fused attention (csrc/fused_attention.cu) against its plain versions: o,
# dq, dk, dv within rtol/atol 1e-4 in float32 (f32 sums in another order than
# cuBLAS over D and S), 2e-2 in bfloat16 (one bf16 rounding of p or dS may
# land on the other side), as tests/test_fused_attention.py holds the JAX
# kernel to the einsum path.
ATTN_CASES = [((8, 8, 50, 16), torch.float32, True),
              ((4, 4, 256, 64), torch.float32, False),
              ((2, 2, 512, 128), torch.float32, True),
              ((4, 4, 256, 64), torch.bfloat16, False)]


def _attn_inputs(cuda, shape, dtype, with_bias, seed=0):
    from atq_tpu_torch.ops.fused_attention import padding_bias

    rng = np.random.RandomState(seed)
    q, k, v, do = (torch.from_numpy(rng.randn(*shape).astype(np.float32))
                   .to(cuda, dtype) for _ in range(4))
    bias = None
    if with_bias:
        lengths = rng.randint(1, shape[2] + 1, shape[0])
        lengths[0] = 0  # one fully padded batch row
        bias = padding_bias(torch.from_numpy(lengths).to(cuda), shape[2])
    return q, k, v, do, bias


@pytest.mark.parametrize("shape,dtype,with_bias", ATTN_CASES)
def test_fused_attention_kernels_match_plain(cuda, shape, dtype, with_bias):
    from atq_tpu_torch.ops import fused_attention as fa

    q, k, v, do, bias = _attn_inputs(cuda, shape, dtype, with_bias)
    scale = 1.0 / np.sqrt(shape[3])
    tol = 1e-4 if dtype == torch.float32 else 2e-2
    before = (fa.fused_attention_forward.launches,
              fa.fused_attention_backward.launches)
    o = fa.fused_attention_forward(q, k, v, scale, bias)
    grads = fa.fused_attention_backward(q, k, v, scale, bias, do)
    assert (fa.fused_attention_forward.launches,
            fa.fused_attention_backward.launches) == (before[0] + 1,
                                                      before[1] + 1)
    assert torch.isfinite(o).all()
    torch.testing.assert_close(o.float(), fa.forward_plain(
        q, k, v, scale, bias).float(), rtol=tol, atol=tol)
    for name, got, want in zip("qkv", grads, fa.backward_plain(
            q, k, v, scale, bias, do)):
        torch.testing.assert_close(got.float(), want.float(), rtol=tol,
                                   atol=tol, msg=lambda m: f"d{name}: {m}")


def test_fused_attention_rejects_bad_cuda_input(cuda):
    from atq_tpu_torch.ops import fused_attention as fa

    q = torch.randn(2, 2, 16, 8, device=cuda)
    with pytest.raises(ValueError):  # no silent fallback for CUDA tensors
        fa.fused_attention_forward(q.double(), q.double(), q.double(), 1.0)
    with pytest.raises(ValueError):  # past the kernel's sequence limit
        big = torch.randn(1, 1, 513, 8, device=cuda)
        fa.fused_attention_forward(big, big, big, 1.0)
    with pytest.raises(ValueError):
        fa.fused_attention_forward(q, q.cpu(), q, 1.0)


def test_fused_attention_op_on_cuda_equals_cpu(cuda):
    from atq_tpu_torch.ops.fused_attention import fused_attention

    q, k, v, do, bias = _attn_inputs(cuda, (2, 3, 40, 16), torch.float32,
                                     True, seed=3)
    out = {}
    for dev in ("cpu", cuda):
        leaves = [t.detach().to(dev).clone().requires_grad_()
                  for t in (q, k, v)]
        y = fused_attention(*leaves, 0.25, bias.to(dev))
        (y * do.to(dev)).sum().backward()
        out[str(dev)] = [y.detach().cpu()] + [t.grad.cpu() for t in leaves]
    for got, want in zip(out[str(cuda)], out["cpu"]):
        torch.testing.assert_close(got, want, rtol=1e-4, atol=1e-5)


# Planar32 (kernel 5) and RPB (kernel 4) matmuls (csrc/ternary_matmul.cu
# tiled_packed_kernel) against their plain versions, (M, K, N): the
# retrieval text tower at 32 x 50 tokens, the image projector, the
# classifier head, ragged shapes, and K past one 2048-column planar32 block.
PACKED_CASES = [(1600, 192, 192), (1600, 384, 192), (32, 512, 192),
                (32, 3136, 128), (7, 100, 24), (65, 2049, 70), (1, 128, 8)]


def _packed_case(cuda, m, k, n, seed=0):
    from atq_tpu_torch.core.packing import pack_planar32

    rng = np.random.RandomState(seed)
    w = torch.from_numpy(rng.randint(-1, 2, (n, k)).astype(np.float32))
    x = torch.from_numpy(rng.randn(m, k).astype(np.float32))
    corr = torch.from_numpy((rng.randn(n, k) * 0.02 * (rng.rand(n, k) < 0.05))
                            .astype(np.float32)).to(torch.bfloat16)
    return (x.to(cuda), pack_planar(w).to(cuda), pack_planar32(w).to(cuda),
            corr.to(cuda))


@pytest.mark.parametrize("mkn", PACKED_CASES)
def test_matmul32_and_rpb_match_plain(cuda, mkn):
    from atq_tpu_torch.ops import ternary_matmul as tm

    m, k, n = mkn
    x, planes, words, corr = _packed_case(cuda, m, k, n)
    for avec, asym in (((0.9, 0.9), False), ((0.9, 0.4), True)):
        avec = torch.tensor(avec, device=cuda)
        before = tm.ternary_matmul_planar32.launches
        got = tm.ternary_matmul_planar32(x, words, k, avec, asym)
        assert tm.ternary_matmul_planar32.launches == before + 1
        torch.testing.assert_close(
            got, tm.ternary_matmul32_plain(x, words, k, avec, asym),
            rtol=MM_RTOL, atol=MM_ATOL)
    avec = torch.tensor((0.9, 0.9), device=cuda)
    before = tm.ternary_matmul_rpb.launches
    got = tm.ternary_matmul_rpb(x, planes, corr, k, avec)
    assert tm.ternary_matmul_rpb.launches == before + 1
    torch.testing.assert_close(
        got, tm.ternary_matmul_rpb_plain(x, planes, corr, k, avec),
        rtol=MM_RTOL, atol=MM_ATOL)


# The tensor-core kernel's edges, (M, K, N): the eligibility minima (N = 8,
# K = 128), K = 200 (not a multiple of 16 or 32), M = 1 and 17, and K long
# enough to be split across blocks (3136, 8704). All three entry points,
# symmetric and TTQ through uint8 planes and planar32 words, each launched
# twice: the second result must equal the first bit for bit (no atomics).
EDGE_CASES = [(1, 128, 8), (17, 128, 8), (17, 200, 8), (1, 200, 24),
              (17, 200, 40), (1, 3136, 128), (128, 8704, 128)]


def _planar_and_plain(tm):
    return ((tm.ternary_matmul_planar, tm.ternary_matmul_plain, 1),
            (tm.ternary_matmul_planar32, tm.ternary_matmul32_plain, 2))


@pytest.mark.parametrize("mkn", EDGE_CASES)
def test_packed_kernels_edges_ttq_and_repeat(cuda, mkn):
    from atq_tpu_torch.ops import ternary_matmul as tm

    m, k, n = mkn
    x, planes, words, corr = _packed_case(cuda, m, k, n, seed=m + k + n)
    packed = {1: planes, 2: words}
    for avec, asym in (((0.9, 0.9), False), ((0.9, 0.4), True)):
        avec = torch.tensor(avec, device=cuda)
        for fn, plain, which in _planar_and_plain(tm):
            got = fn(x, packed[which], k, avec, asym)
            torch.testing.assert_close(
                got, plain(x, packed[which], k, avec, asym), rtol=MM_RTOL,
                atol=MM_ATOL, msg=lambda msg: f"{fn.__name__} {asym}: {msg}")
            assert torch.equal(got, fn(x, packed[which], k, avec, asym))
    avec = torch.tensor((0.9, 0.9), device=cuda)
    got = tm.ternary_matmul_rpb(x, planes, corr, k, avec)
    torch.testing.assert_close(
        got, tm.ternary_matmul_rpb_plain(x, planes, corr, k, avec),
        rtol=MM_RTOL, atol=MM_ATOL)
    assert torch.equal(got, tm.ternary_matmul_rpb(x, planes, corr, k, avec))


def test_packed_kernels_take_unaligned_x(cuda):
    """x at a 4-byte offset (no 16-byte copies of its rows) and a
    correction whose rows are not 16-byte aligned (K = 100)."""
    from atq_tpu_torch.ops import ternary_matmul as tm

    for m, k, n in ((33, 256, 40), (7, 100, 24)):
        x, planes, words, corr = _packed_case(cuda, m, k, n, seed=k)
        flat = torch.empty(m * k + 1, device=cuda)
        xu = flat[1:].view(m, k)
        xu.copy_(x)
        assert xu.is_contiguous() and xu.data_ptr() % 16 != 0
        avec = torch.tensor((0.9, 0.4), device=cuda)
        for fn, plain, which in _planar_and_plain(tm):
            p = planes if which == 1 else words
            torch.testing.assert_close(fn(xu, p, k, avec, True),
                                       plain(x, p, k, avec, True),
                                       rtol=MM_RTOL, atol=MM_ATOL)
        avec = torch.tensor((0.9, 0.9), device=cuda)
        torch.testing.assert_close(
            tm.ternary_matmul_rpb(xu, planes, corr, k, avec),
            tm.ternary_matmul_rpb_plain(x, planes, corr, k, avec),
            rtol=MM_RTOL, atol=MM_ATOL)


def test_matmul32_and_rpb_reject_bad_cuda_input(cuda):
    from atq_tpu_torch.ops import ternary_matmul as tm

    x, planes, words, corr = _packed_case(cuda, 4, 256, 16)
    avec = torch.tensor([1.0, 1.0], device=cuda)
    with pytest.raises(ValueError):  # no silent fallback for CUDA tensors
        tm.ternary_matmul_planar32(x.double(), words, 256, avec)
    with pytest.raises(ValueError):  # uint8 planes are not planar32 words
        tm.ternary_matmul_planar32(x, planes, 256, avec)
    with pytest.raises(ValueError):  # correction on the CPU
        tm.ternary_matmul_rpb(x, planes, corr.cpu(), 256, avec)
    with pytest.raises(ValueError):  # correction in float32
        tm.ternary_matmul_rpb(x, planes, corr.float(), 256, avec)


def test_packed_layers_on_cuda_equal_cpu(cuda, monkeypatch):
    """packed_linear_apply on the card (planar32 and dense-correction
    entries) against the same entries on the CPU."""
    from atq_tpu_torch.serve.packed_model import (
        pack_quantized_layer,
        packed_linear_apply,
    )

    rng = np.random.RandomState(5)
    params = {"weight": (rng.randn(96, 384) * 0.05).astype(np.float32),
              "alpha": np.full((1,), 0.04, np.float32),
              "bias": (rng.randn(96) * 0.1).astype(np.float32)}
    quant = {"precision_mask": rng.rand(96, 384) < 0.2,
             "sparsity_target": np.float32(0.1)}
    x = torch.from_numpy(rng.randn(50, 384).astype(np.float32))
    for pack32, sparse in ((True, True), (False, False), (True, False)):
        monkeypatch.setenv("ATQ_PACK32", "1" if pack32 else "0")
        want = packed_linear_apply(pack_quantized_layer(
            params, quant, device="cpu", sparse_correction=sparse), x)
        got = packed_linear_apply(pack_quantized_layer(
            params, quant, device=cuda, sparse_correction=sparse),
            x.to(cuda)).cpu()
        torch.testing.assert_close(got, want, rtol=1e-5, atol=1e-5)
