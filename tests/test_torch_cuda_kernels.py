"""The port's CUDA kernels against their plain PyTorch versions, on the card.

Every test here needs an NVIDIA GPU (the kernels have no CPU mode) and
skips without one. The file imports neither JAX nor the JAX package, so it
also runs on a machine without them; there, skip the JAX-importing
conftest:

    python -m pytest --noconftest -q -m cuda tests/test_torch_cuda_kernels.py

Tolerances: the order statistic is bit-exact (max equal, sum within
rtol 1e-6), repeats bit for bit and is one stream operation a call; the
packed matmuls (uint8 planes, planar32 words, and the fused
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
    if kind == "equal":
        return torch.full((n,), 0.37)
    x = np.abs(rng.randn(n)).astype(np.float32)
    u = rng.rand(n)
    if kind == "bin90":  # > 90 % of the row in one digit-0 bin
        x = np.where(u < 0.05, x * 40, np.float32(1.5)).astype(np.float32)
    elif kind == "subnormal":  # exact zeros and subnormals among normals
        x = np.where(u < 0.3, 0.0,
                     np.where(u < 0.6, x * 1e-40, x)).astype(np.float32)
    elif kind == "sorted":  # a longer row's held sample is not the row
        x = np.sort(x)
    return torch.from_numpy(x)


# Sizes: serve_dense's 401,408; the retrieval layers' 18,432-98,304; one
# CTA's edge (16,384 and 16,385); rows longer than a cluster holds
# (2,359,296: the window, its overflow and its miss).
@pytest.mark.parametrize("kind,n", [
    ("randn", 401408), ("randn", 16385), ("dups", 100000), ("zeros", 20000),
    ("randn", 16384), ("randn", 18432), ("randn", 36864), ("randn", 73728),
    ("randn", 98304), ("equal", 401408), ("bin90", 401408),
    ("subnormal", 401408), ("randn", 2359296), ("equal", 2359296),
    ("bin90", 2359296), ("subnormal", 2359296), ("sorted", 2359296)])
def test_order_stat_bit_exact_vs_plain(cuda, kind, n):
    x = _abs_input(kind, n).to(cuda)
    for r in sorted({0, 1, int(np.floor(np.float32(0.3) * np.float32(n))),
                     n - 1}):
        rank = torch.tensor([r], dtype=torch.int32, device=cuda)
        got = torch.stack(order_statistic_reductions(x, rank)).cpu()
        again = torch.stack(order_statistic_reductions(x, rank)).cpu()
        want = torch.stack(order_statistic_plain(x, rank)).cpu()
        assert got[0].view(torch.int32) == want[0].view(torch.int32), r
        assert got[1] == want[1]
        assert abs(got[2] - want[2]) <= 1e-6 * abs(want[2])
        assert torch.equal(got.view(torch.int32), again.view(torch.int32))


def _stream_ops(fn, iters=10):
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(iters):
            fn()
        torch.cuda.synchronize()
    return sum(e.count for e in prof.key_averages()
               if e.device_type == DeviceType.CUDA) / iters


@pytest.mark.parametrize("lead,n", [(1, 401408), (1, 18432), (1, 98304),
                                    (12, 589824), (12, 2359296)])
def test_order_stat_is_one_stream_operation_a_call(cuda, lead, n):
    from atq_tpu_torch.ops.order_stat import (
        order_statistic_reductions_batched,
    )

    x = _abs_input("randn", lead * n).to(cuda).reshape(lead, n)
    ranks = torch.full((lead,), n // 10, dtype=torch.int32, device=cuda)
    if lead == 1:
        assert _stream_ops(
            lambda: order_statistic_reductions(x[0], ranks)) == 1
    assert _stream_ops(
        lambda: order_statistic_reductions_batched(x, ranks)) == 1


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
                (2304, 128, 3136),
                # The retrieval text tower at batch 16 x sequence 50: the
                # FFN's 800 x 192 -> 384 and 800 x 384 -> 192.
                (800, 384, 192), (800, 192, 384)]


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


# The dW/dalpha kernel's edges (3xTF32 tensor cores, 64 x 32 tiles, a ring
# of 32 batch rows): N = 10 and 24 (not a multiple of 4: 4-byte copies of
# g), K = 100 and 200 (ragged tiles, rows of the mask not 16-byte aligned),
# M = 1, 7 and 17 (a partial ring step), and M = 2304, past the JAX
# package's resident limit (_MAX_RESIDENT_M = 2048).
DWDA_EDGE_SHAPES = [(1, 10, 100), (7, 24, 200), (17, 24, 100),
                    (17, 10, 200), (1, 24, 200), (2304, 128, 3136)]


@pytest.mark.parametrize("mnk", DWDA_EDGE_SHAPES)
@pytest.mark.parametrize("with_mask", [True, False])
def test_fused_dwda_edges_match_plain_and_repeat(cuda, mnk, with_mask):
    from atq_tpu_torch.ops import fused_linear as fl

    m, n, k = mnk
    x, w, g, mask, scal = _fused_inputs(cuda, m, n, k, with_mask, seed=m + k)
    for ste in (False, True):
        before = fl.fused_linear_dwda.launches
        dw, da = fl.fused_linear_dwda(g, x, w, mask, scal, ste)
        assert fl.fused_linear_dwda.launches == before + 1
        dw_p, da_p = fl.dwda_plain(g, x, w, mask, scal, ste)
        torch.testing.assert_close(dw, dw_p, rtol=1e-4, atol=1e-4)
        assert abs(da.item() - da_p.item()) <= 1e-4 * abs(da_p.item())
        if mask is None and not ste:
            assert not dw.any()
        dw2, da2 = fl.fused_linear_dwda(g, x, w, mask, scal, ste)
        assert torch.equal(dw, dw2)  # one launch, the same bits every run
        assert da.view(torch.int32) == da2.view(torch.int32)


# The forward's and dx's edges (3xTF32 tensor cores, 64 x 64 tiles, a ring
# of 32 reduction values): M = 1, 5, 7 and 17 (partial tiles), N = 10 and
# 24 (dx's reduction shorter than one ring step or one MMA step; g's rows
# not 16-byte aligned at N = 10), K = 99 and 37 (weight rows not aligned:
# the plain-load blend), K = 100 and 200, M = 2304 (one split of K), and
# 256 x 128 x 3136 (the recipe's 33 splits, summed in the launch). Besides
# the plain version, each is held against a float64 product: its error
# over Σ|a|·|b| within 1e-5, which one TF32 pass misses (dx's values are
# about 1e-3, inside the 1e-4 atol even for one pass).
GEMM_EDGE_SHAPES = [(1, 10, 100), (7, 24, 200), (17, 24, 100), (17, 10, 200),
                    (1, 24, 200), (17, 24, 99), (5, 10, 37),
                    (2304, 128, 3136), (256, 128, 3136)]


@pytest.mark.parametrize("mnk", GEMM_EDGE_SHAPES)
@pytest.mark.parametrize("with_mask", [True, False])
def test_fused_forward_dx_edges_match_plain_and_repeat(cuda, mnk, with_mask):
    from atq_tpu_torch.ops import fused_linear as fl

    m, n, k = mnk
    x, w, g, mask, scal = _fused_inputs(cuda, m, n, k, with_mask, seed=m + k)
    w_eff = fl._w_eff(w, mask, scal[0], scal[1])[0].double()
    for fn, plain, args, a, b in (
            (fl.fused_linear_forward, fl.forward_plain, (x, w, mask, scal),
             x.double(), w_eff.T),
            (fl.fused_linear_dx, fl.dx_plain, (g, w, mask, scal),
             g.double(), w_eff)):
        before = fn.launches
        got = fn(*args)
        assert fn.launches == before + 1  # one launch a call
        torch.testing.assert_close(got, plain(*args), rtol=1e-4, atol=1e-4)
        assert torch.equal(got, fn(*args))  # the same bits every run
        scale = a.abs() @ b.abs()
        err = (got.double() - a @ b).abs() / torch.where(
            scale > 0, scale, torch.ones_like(scale))
        assert err.max().item() <= 1e-5


def _misaligned(t):
    """A contiguous copy of t that starts 4 bytes past a 16-byte boundary."""
    flat = torch.empty(t.numel() + 1, dtype=t.dtype, device=t.device)
    out = flat[1:].view(t.shape)
    out.copy_(t)
    return out


def test_fused_forward_dx_take_misaligned_rows(cuda):
    from atq_tpu_torch.ops import fused_linear as fl

    x, w, g, mask, scal = _fused_inputs(cuda, 33, 24, 200, True, seed=5)
    xm, wm, gm, mm = map(_misaligned, (x, w, g, mask))
    torch.testing.assert_close(fl.fused_linear_forward(xm, wm, mm, scal),
                               fl.forward_plain(x, w, mask, scal),
                               rtol=1e-4, atol=1e-4)
    torch.testing.assert_close(fl.fused_linear_dx(gm, wm, mm, scal),
                               fl.dx_plain(g, w, mask, scal),
                               rtol=1e-4, atol=1e-4)


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


@pytest.mark.parametrize("grad_mode", ["parity", "ste"])
def test_fused_autograd_op_takes_text_tower_activations(cuda, grad_mode):
    """The retrieval text tower's FFN on (batch 16, sequence 50, 192)
    activations with an RPB mask: the op flattens them to 800 rows. Output
    and gradients on the card against the CPU's plain versions."""
    from atq_tpu_torch.ops.fused_linear import fused_quantized_linear

    x, w, _, mask, scal = _fused_inputs(cuda, 800, 384, 192, True, seed=7)
    g = torch.randn(16, 50, 384, generator=torch.Generator().manual_seed(8))
    thr, alpha = scal[1].cpu(), torch.tensor([0.017])
    out = {}
    for dev in ("cpu", cuda):
        xs = x.detach().to(dev).reshape(16, 50, 192).clone().requires_grad_()
        ws, a = (t.detach().to(dev).clone().requires_grad_()
                 for t in (w, alpha))
        y = fused_quantized_linear(xs, ws, a, thr.to(dev), mask.to(dev),
                                   grad_mode=grad_mode)
        assert y.shape == (16, 50, 384)
        (y * g.to(dev)).sum().backward()
        out[str(dev)] = [t.detach().cpu() for t in (y, xs.grad, ws.grad,
                                                    a.grad)]
    for got, want in zip(out[str(cuda)], out["cpu"]):
        torch.testing.assert_close(got, want, rtol=1e-4, atol=1e-4)


# Batched order statistic (csrc/order_stat.cu with a row index): every row's
# statistic and max bit-exact against the per-row sort, each row's sum within
# rtol 1e-6.
# Rows past the first: all equal, > 90 % in one bin, sorted, subnormals.
@pytest.mark.parametrize("lead,n", [(3, 16385), (12, 589824), (2, 2359296),
                                    (1, 98304), (13, 20000), (5, 2359296)])
def test_batched_order_stat_bit_exact_vs_plain(cuda, lead, n):
    from atq_tpu_torch.ops.order_stat import (
        order_statistic_batched_plain,
        order_statistic_reductions_batched,
    )

    rng = np.random.RandomState(lead)
    x = torch.from_numpy(np.abs(rng.randn(lead, n)).astype(np.float32))
    x[0] = torch.from_numpy((rng.randint(0, 6, n) / 4.0).astype(np.float32))
    for i, kind in enumerate(("equal", "bin90", "sorted", "subnormal"), 1):
        if i < lead:
            x[i] = _abs_input(kind, n, seed=i)
    x = x.to(cuda)
    picks = [0, n - 1, int(np.floor(np.float32(0.3) * np.float32(n))), 1]
    ranks = torch.tensor([picks[i % 4] for i in range(lead)],
                         dtype=torch.int32, device=cuda)
    before = order_statistic_reductions_batched.launches
    got = torch.stack(order_statistic_reductions_batched(x, ranks)).cpu()
    assert order_statistic_reductions_batched.launches == before + 1
    again = torch.stack(order_statistic_reductions_batched(x, ranks)).cpu()
    want = torch.stack(order_statistic_batched_plain(x, ranks)).cpu()
    assert torch.equal(got[0].view(torch.int32), want[0].view(torch.int32))
    assert torch.equal(got[1], want[1])
    torch.testing.assert_close(got[2], want[2], rtol=1e-6, atol=0)
    assert torch.equal(got.view(torch.int32), again.view(torch.int32))


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
# The edge cases: S = 1, 50, 64, 257 (a partial 32-row step and 64-key
# block) and 512; D = 16, 20 (not a multiple of 8), 64 and 128; both dtypes;
# with a padding bias, the first batch row fully padded.
ATTN_CASES = [((8, 8, 50, 16), torch.float32, True),
              ((4, 4, 256, 64), torch.float32, False),
              ((2, 2, 512, 128), torch.float32, True),
              ((4, 4, 256, 64), torch.bfloat16, False),
              ((2, 3, 1, 16), torch.float32, False),
              ((2, 3, 1, 64), torch.bfloat16, True),
              ((3, 2, 50, 20), torch.float32, True),
              ((3, 2, 50, 20), torch.bfloat16, True),
              ((2, 2, 64, 128), torch.bfloat16, True),
              ((2, 3, 257, 64), torch.float32, True),
              ((1, 2, 257, 128), torch.bfloat16, False),
              ((2, 2, 512, 16), torch.bfloat16, True)]


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


# The float32 forward's o against a float64 forward on the same inputs:
# each element's error over its Σ_j p_j·|v_j| within 1e-5 (chip_smoke.py's
# F64_REL_TOL), which one TF32 pass a product does not meet
# (tests/test_torch_attention_fwd_tiled.py).
ATTN_F64_REL_TOL = 1e-5


def _attn_f64_rel_err(o, q, k, v, scale, bias):
    s = q.double() @ k.double().transpose(-1, -2) * scale
    if bias is not None:
        s = s + bias.double()
    # The kernel's guard, -1e30 in float32 (the padding bias's value).
    m = torch.clamp(s.amax(dim=-1, keepdim=True),
                    min=float(np.float32(-1e30)))
    e = torch.exp(s - m)
    p = e / e.sum(dim=-1, keepdim=True)
    want = p @ v.double()
    return ((o.double() - want).abs() / (p @ v.double().abs())).max().item()


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
    if dtype == torch.float32:
        err = _attn_f64_rel_err(o, q, k, v, scale, bias)
        assert err <= ATTN_F64_REL_TOL, f"o: {err} of Σ p|v| from float64"
    for name, got, want in zip("qkv", grads, fa.backward_plain(
            q, k, v, scale, bias, do)):
        torch.testing.assert_close(got.float(), want.float(), rtol=tol,
                                   atol=tol, msg=lambda m: f"d{name}: {m}")


@pytest.mark.parametrize("shape,dtype,with_bias",
                         [((2, 3, 257, 64), torch.float32, True),
                          ((2, 2, 50, 20), torch.bfloat16, True),
                          ((1, 2, 512, 128), torch.float32, False)])
def test_fused_attention_backward_repeats_bit_for_bit(cuda, shape, dtype,
                                                      with_bias):
    from atq_tpu_torch.ops import fused_attention as fa

    q, k, v, do, bias = _attn_inputs(cuda, shape, dtype, with_bias, seed=1)
    scale = 1.0 / np.sqrt(shape[3])
    first = fa.fused_attention_backward(q, k, v, scale, bias, do)
    again = fa.fused_attention_backward(q, k, v, scale, bias, do)
    for name, a, b in zip("qkv", first, again):
        assert torch.equal(a, b), f"d{name} differs between two launches"


@pytest.mark.parametrize("shape,dtype,with_bias",
                         [((2, 3, 257, 64), torch.float32, True),
                          ((2, 2, 50, 20), torch.bfloat16, True),
                          ((1, 2, 512, 128), torch.float32, False)])
def test_fused_attention_forward_repeats_bit_for_bit(cuda, shape, dtype,
                                                     with_bias):
    from atq_tpu_torch.ops import fused_attention as fa

    q, k, v, _, bias = _attn_inputs(cuda, shape, dtype, with_bias, seed=1)
    scale = 1.0 / np.sqrt(shape[3])
    first = fa.fused_attention_forward(q, k, v, scale, bias)
    again = fa.fused_attention_forward(q, k, v, scale, bias)
    assert torch.equal(first, again), "o differs between two launches"


def test_fused_attention_backward_allocates_no_score_tensor(cuda):
    # With q, k, v and dO live (4·B·H·S·D·4 bytes), one backward call may
    # add dq, dk, dv and the (B, H, S, 4) row statistics: under
    # 8·B·H·S·D·4 bytes plus the statistics in all, where a (B, H, S, S) P
    # and dS would add another 2·B·H·S²·4.
    from atq_tpu_torch.ops import fused_attention as fa

    b, h, s, d = shape = (4, 4, 256, 64)
    q, k, v, do, _ = _attn_inputs(cuda, shape, torch.float32, False)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    base = torch.cuda.memory_allocated()  # the inputs, and anything else
    fa.fused_attention_backward(q, k, v, 0.125, None, do)
    torch.cuda.synchronize()
    added = torch.cuda.max_memory_allocated() - base
    assert added < 4 * b * h * s * d * 4 + b * h * s * 4 * 4, added


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


# The registered ops (ops/__init__.py) inside a saved and loaded
# torch.export program (serve/aot.py), at the full-width classifier: route
# -> (environment, sparse correction, packed, the wrapper's kernel name).
AOT_ROUTES = {
    "order_stat": ({}, True, False, "order_stat"),
    "planar": ({}, True, True, "ternary_matmul"),
    "planar32": ({"ATQ_PACK32": "1"}, True, True, "ternary_matmul32"),
    "rpb": ({}, False, True, "ternary_matmul_rpb"),
    "fused_forward": ({"ATQ_FUSED": "1"}, True, False, "fused_forward"),
}


@pytest.mark.parametrize("route", list(AOT_ROUTES))
def test_registered_op_from_a_loaded_artifact(cuda, route, tmp_path,
                                              monkeypatch):
    """A loaded program launches the route's kernel (its wrapper's count
    grows) and equals the live model on the card bit for bit, at batch 1
    and at a batch never seen at export time."""
    from atq_tpu_torch.models.image_classifier import ATQImageClassifier
    from atq_tpu_torch.ops import kernel_launches
    from atq_tpu_torch.serve.aot import export_serving, load_serving
    from atq_tpu_torch.serve.packed_model import (
        attach_packed_collection,
        export_packed_collection,
    )
    from atq_tpu_torch.utils.jax_interop import to_jax_variables

    env, sparse, packed, kernel = AOT_ROUTES[route]
    for k, v in env.items():
        monkeypatch.setenv(k, v)
    model = ATQImageClassifier(use_rpb=True, hidden_size=128, device="cpu",
                               generator=torch.Generator().manual_seed(0))
    variables = to_jax_variables(model.state_dict())
    model = model.to(cuda)
    if packed:
        attach_packed_collection(model, export_packed_collection(
            variables["params"], variables["quant"], device=cuda,
            sparse_correction=sparse))
    rng = np.random.RandomState(1)
    x2 = torch.from_numpy(rng.randn(2, 28, 28, 1).astype(np.float32))
    path = export_serving(model, (x2.to(cuda),)).save(str(tmp_path / "p"))
    loaded = load_serving(path)
    assert loaded.batch_polymorphic
    for n in (1, 5):
        x = torch.from_numpy(rng.randn(n, 28, 28, 1).astype(
            np.float32)).to(cuda)
        with torch.inference_mode():
            want = model(x)
        before = kernel_launches()[kernel]
        got = loaded(x)
        torch.cuda.synchronize()
        assert kernel_launches()[kernel] - before == (
            2 if kernel.startswith(("ternary", "fused")) else 1)
        assert torch.equal(got, want)


@pytest.mark.parametrize("layout,k", [("rows", 3136), ("flat", 3136),
                                      ("flat", 130)])
def test_rows_and_flat_layouts_on_cuda(cuda, layout, k):
    """``rows`` (and ``flat`` with K % 4 = 0) convert to planes on the
    card and launch the planar kernel; ``flat`` with K % 4 != 0 decodes;
    each within the kernels' tolerance of the plain version on the CPU."""
    from atq_tpu_torch.core.packing import TernaryBitPacking, pack_rows
    from atq_tpu_torch.ops.ternary_matmul import packed_ternary_matmul

    rng = np.random.RandomState(k)
    w = torch.from_numpy(rng.choice([-1.0, 0.0, 1.0], (64, k)).astype(
        np.float32))
    x = torch.from_numpy((rng.randn(32, k) * 0.1).astype(np.float32))
    packed = (pack_rows(w) if layout == "rows" else
              TernaryBitPacking.pack_ternary_weights(w)["packed_weights"])
    for alpha_neg in (None, 0.4):
        want = packed_ternary_matmul(x, packed, (64, k), alpha=0.9,
                                     layout=layout, alpha_neg=alpha_neg)
        before = ternary_matmul_planar.launches
        got = packed_ternary_matmul(x.to(cuda), packed.to(cuda), (64, k),
                                    alpha=0.9, layout=layout,
                                    alpha_neg=alpha_neg)
        torch.cuda.synchronize()
        assert ternary_matmul_planar.launches - before == int(k % 4 == 0)
        torch.testing.assert_close(got.cpu(), want, rtol=MM_RTOL,
                                   atol=MM_ATOL)
