"""The counted FLOP figure (utils/flops.py ``counted_flops``, the scale
row's ``flops_per_step_counted``) on the CPU.

The hand-written kernels run through ``ctypes``, out of
``FlopCounterMode``'s sight. A kernel behind a registered op (the order
statistic, the packed matmuls, the fused forward) has a FLOP formula that
the counter applies to the op on either device; every other wrapper adds
its launch's work to its ``flops`` count from its shapes. Both must equal
what ``FlopCounterMode`` counts for the kernel's plain version at the same
shapes, which is what these tests hold, wrapper by wrapper, at ragged and
main-path shapes (exactly: integers). On the CPU the other wrappers run
their plain versions, so a counted step sees every product itself and no
wrapper adds anything; ``chip_smoke.py``'s encoder_step0 holds the card's
count of the same step (the kernels' own adds) to the CPU's.
"""

import numpy as np
import pytest
import torch
from torch.utils.flop_counter import FlopCounterMode

from atq_tpu_torch.core.packing import pack_planar, pack_planar32
from atq_tpu_torch.models.image_classifier import ATQImageClassifier
from atq_tpu_torch.nn.layers import apply_selective_routing
from atq_tpu_torch.ops import fused_attention as fa
from atq_tpu_torch.ops import fused_linear as fl
from atq_tpu_torch.ops import kernel_flops, kernel_wrappers, matmul_flops
from atq_tpu_torch.ops import order_stat as osx
from atq_tpu_torch.ops import ternary_matmul as tm
from atq_tpu_torch.serve.packed_model import (
    attach_packed_collection,
    export_packed_collection,
)
from atq_tpu_torch.train import scale
from atq_tpu_torch.utils.jax_interop import to_jax_variables
from atq_tpu_torch.utils.flops import counted_flops


@pytest.fixture(autouse=True)
def _one_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _count(fn, *args):
    with FlopCounterMode(display=False) as counter:
        fn(*args)
    return counter.get_total_flops()


def _randn(*shape, seed=0):
    return torch.from_numpy(np.random.RandomState(seed).randn(*shape)
                            .astype(np.float32))


def test_every_wrapper_has_a_count():
    assert sorted(kernel_flops()) == sorted(kernel_wrappers())
    assert all(isinstance(v, int) for v in kernel_flops().values())


@pytest.mark.parametrize("n", [7, 16385])
def test_order_statistics_add_what_their_plain_versions_count(n):
    """Sort, max and sum: no product, 0 FLOPs on both sides."""
    x = _randn(n).abs()
    rank = torch.tensor([n // 3], dtype=torch.int32)
    assert _count(osx.order_statistic_plain, x, rank) == 0
    rows = _randn(3, n).abs()
    ranks = torch.tensor([0, n // 2, n - 1], dtype=torch.int32)
    assert _count(osx.order_statistic_batched_plain, rows, ranks) == 0
    assert osx.order_statistic_reductions.flops == 0
    assert osx.order_statistic_reductions_batched.flops == 0


FUSED_SHAPES = [(7, 24, 100), (256, 10, 128), (800, 1, 96),
                (256, 128, 3136)]


@pytest.mark.parametrize("mask", [False, True], ids=["nomask", "mask"])
@pytest.mark.parametrize("mnk", FUSED_SHAPES)
def test_fused_linear_adds_what_its_plain_version_counts(mnk, mask):
    m, n, k = mnk
    x, g, w = _randn(m, k, seed=1), _randn(m, n, seed=2), _randn(n, k,
                                                               seed=3)
    m_ = (_randn(n, k, seed=4) > 1.0) if mask else None
    scal = torch.tensor([0.7, 0.4])
    want = matmul_flops(m, n, k)
    assert _count(fl.forward_plain, x, w, m_, scal) == want
    assert _count(fl.dx_plain, g, w, m_, scal) == want
    for ste in (False, True):
        assert _count(fl.dwda_plain, g, x, w, m_, scal, ste) == want


@pytest.mark.parametrize("bias", [False, True], ids=["nobias", "bias"])
@pytest.mark.parametrize("bhsd", [(2, 3, 50, 16), (1, 2, 257, 64),
                                  (2, 12, 256, 64)])
def test_fused_attention_adds_what_its_plain_version_counts(bhsd, bias):
    b, h, s, d = bhsd
    q, k, v, do = (_randn(*bhsd, seed=i) for i in range(4))
    pad = fa.padding_bias(torch.tensor([s, s // 2][:b]), s) if bias \
        else None
    assert _count(fa.forward_plain, q, k, v, 0.125, pad) == \
        fa.forward_flops(b, h, s, d)
    assert _count(fa.backward_plain, q, k, v, 0.125, pad, do) == \
        fa.backward_flops(b, h, s, d)


@pytest.mark.parametrize("mkn", [(7, 100, 24), (32, 3136, 128),
                                 (1600, 192, 384)])
def test_packed_matmuls_add_what_their_plain_versions_count(mkn):
    m, k, n = mkn
    w = torch.from_numpy(np.random.RandomState(5).randint(-1, 2, (n, k))
                         .astype(np.float32))
    x = _randn(m, k, seed=6)
    alpha = torch.tensor([0.7, 0.7])
    corr = (_randn(n, k, seed=7) * 0.01).to(torch.bfloat16)
    assert _count(tm.ternary_matmul_plain, x, pack_planar(w), k, alpha,
                  False) == matmul_flops(m, n, k)
    assert _count(tm.ternary_matmul32_plain, x, pack_planar32(w), k,
                  torch.tensor([0.7, 0.5]), True) == matmul_flops(m, n, k)
    assert _count(tm.ternary_matmul_rpb_plain, x, pack_planar(w), corr, k,
                  alpha) == matmul_flops(m, n, k, products=2)


@pytest.mark.parametrize("grad", [False, True], ids=["eval", "train"])
def test_the_fused_op_counts_on_the_cpu(grad):
    """The fused forward runs as the registered op on the CPU too, out of
    the counter's sight: its formula counts it, and the backward's plain
    products are seen as before."""
    m, n, k = 7, 24, 200
    x = _randn(m, k, seed=1).requires_grad_(grad)
    w = _randn(n, k, seed=2).requires_grad_(grad)
    alpha = torch.tensor(0.7, requires_grad=grad)
    thr = torch.tensor(0.4)
    mask = _randn(n, k, seed=3) > 1.0

    def run():
        y = fl.fused_quantized_linear(x, w, alpha, thr, mask)
        if grad:
            y.sum().backward()
        return y

    before = kernel_flops()
    flops, _ = counted_flops(run)
    assert kernel_flops() == before
    assert flops["total"] == flops["traced"] == matmul_flops(
        m, n, k, products=3 if grad else 1)


# route -> (environment, RPB head, products a packed layer's kernel does)
PACKED_ROUTES = {"planar": ({}, False, 1),
                 "planar32": ({"ATQ_PACK32": "1"}, False, 1),
                 "rpb": ({}, True, 2)}


@pytest.mark.parametrize("route", list(PACKED_ROUTES))
def test_a_packed_forward_counts_its_kernel_ops(route, monkeypatch):
    """The packed classifier head (3136 -> 128 -> 10, both layers on a
    kernel op; the RPB correction dense) counts the convolutions and
    routing as the dense forward does, plus each op's products."""
    env, rpb, products = PACKED_ROUTES[route]
    for key, value in env.items():
        monkeypatch.setenv(key, value)
    model = ATQImageClassifier(use_rpb=rpb, device="cpu",
                               generator=torch.Generator().manual_seed(0))
    x = torch.from_numpy(np.random.RandomState(0).rand(3, 28, 28, 1)
                         .astype(np.float32))
    with torch.no_grad():
        features, _ = counted_flops(lambda: apply_selective_routing(
            model.features(x), threshold=0.05, importance_factor=0.7))
        v = to_jax_variables(model.state_dict())
        attach_packed_collection(model, export_packed_collection(
            v["params"], v.get("quant"), device="cpu",
            sparse_correction=False))
        before = kernel_flops()
        flops, _ = counted_flops(lambda: model(x))
    assert kernel_flops() == before
    assert flops["total"] == features["total"] + matmul_flops(
        3, 128, 3136, products) + matmul_flops(3, 10, 128, products)


TINY = (64, 128, 4, 2, 32, 4, True, True)  # scanned, remat


def test_a_counted_cpu_step_sees_every_product_itself():
    step, _, state, _ = scale.build_step(*TINY, use_amp=False,
                                         attn_impl="fused", hoist_quant=True,
                                         device="cpu")
    before = kernel_flops()
    flops, (state, loss) = counted_flops(lambda: step(state))
    assert kernel_flops() == before
    assert flops["kernels"] == {k: 0 for k in before}
    assert flops["total"] == flops["traced"] > 0
    assert np.isfinite(float(loss))
    # Forward, backward and remat's recompute: more than the analytic
    # 3 x forward, which leaves the recompute out.
    assert flops["total"] > scale.analytic_step_flops(*TINY[:6])


def test_the_scale_row_reports_the_counted_figure():
    row = scale.measure("tiny", TINY, use_amp=False, iters=1,
                        attn_impl="fused", hoist_quant=True, device="cpu")
    step, _, state, _ = scale.build_step(*TINY, use_amp=False,
                                         attn_impl="fused", hoist_quant=True,
                                         device="cpu")
    flops, _ = counted_flops(lambda: step(state))
    assert row["flops_per_step_counted"] == flops["total"]
    assert row["flops_per_step_counted_kernels"] == flops["kernels"]
    assert row["flops_per_step"] == scale.analytic_step_flops(*TINY[:6])
    assert "flops_per_step_xla" not in row
    assert len(row["losses"]) == 3  # the counted warm-up step among them
