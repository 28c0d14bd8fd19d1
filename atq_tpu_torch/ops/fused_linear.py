"""Fused ternarize + blend + matmul for the training path.

PyTorch counterpart of atq_tpu/ops/fused_linear.py. The quantizer's
data-dependent half, the threshold (core/quantize.py:ternary_threshold, the
order statistic), stays outside; the elementwise half moves into the
matmul: each kernel ternarizes and blends its weight tile as it loads it,
so ``w_t`` and ``w_mixed`` are never written to device memory.

Three kernels in ``csrc/fused_linear.cu``, each with a wrapper here that
launches it on a CUDA tensor (or raises) and takes its plain PyTorch version
on a CPU tensor, and counts its launches and their FLOPs (2·M·N·K each, its
plain version's product):

- :func:`fused_linear_forward`  ``y = x · w_effᵀ``     (``_fwd_kernel``)
- :func:`fused_linear_dx`       ``dx = g · w_eff``     (``_dx_kernel``)
- :func:`fused_linear_dwda`     ``G = gᵀ · x`` -> dw, dalpha (``_dwda_kernel``)

with ``w_eff = tern(w, thr)·alpha·(1 − m) + w·m`` (``m`` the bool precision
mask; without one ``w_eff = tern(w, thr)·alpha``). The JAX package's
``_MAX_RESIDENT_M`` gate (its dW kernel keeps the whole batch in VMEM) has
no counterpart: the CUDA dW/dalpha kernel loops over the batch and takes
any M.

All three run on the tensor cores as 3xTF32 (each f32 operand split into
two TF32 terms, three ``mma.sync`` products summed a step at a time, so f32
accuracy) over a ``cp.async`` ring. The forward and dx share one template
(``gemm_tc_kernel``, 64 x 64 output tiles), which blends each weight tile
in shared memory before its products. The forward splits a long K over
blocks (:func:`forward_splits`) and the last block of each output tile adds
the splits' partials in split order, in the same launch. The dW/dalpha
kernel (``dwda_kernel``) forms G = gᵀx in 64 x 32 tiles and sums dalpha in
the same launch in a fixed order (the last block adds the blocks' partials
in index order). Both cross-block sums find their last block by an integer
ticket, so the same inputs give the same bits. Bytes bound all three at the
recipe (5.3 to 7 MB, 1.6 to 2.1 us at 3.35 TB/s); see the note in
``csrc/fused_linear.cu``.

:func:`fused_quantized_linear` is the op the layers call: one
``torch.autograd.Function`` with the JAX ``custom_vjp``'s gradients
(parity or STE, see :func:`_dispatch_backward`).
"""

from __future__ import annotations

import torch

from atq_tpu_torch.ops import matmul_flops
from atq_tpu_torch.ops._build import check, load_library

GRAD_MODES = ("parity", "ste")
_TILE = 64            # the forward's and dx's output tile, rows and columns
_STEP = 32            # the reduction a ring stage of theirs covers
_SPLIT_MIN_K = 64     # least reduction length a forward split covers
_TARGET_BLOCKS = 264  # the forward's blocks: two for each of the H100's SMs


def _ternarize(w, thr):
    one = torch.ones((), dtype=w.dtype, device=w.device)
    zero = torch.zeros((), dtype=w.dtype, device=w.device)
    return torch.where(w > thr, one, torch.where(w < -thr, -one, zero))


def _w_eff(w, mask, alpha, thr):
    """``(w_eff, w_t)`` as the JAX package's XLA path forms them."""
    wt = _ternarize(w, thr)
    if mask is None:
        return wt * alpha, wt
    m = mask.to(w.dtype)
    return wt * alpha * (1.0 - m) + w * m, wt


def scalars(alpha, threshold) -> torch.Tensor:
    """The kernels' device vector ``[alpha, threshold]`` (float32)."""
    return torch.stack([alpha.reshape(()).float(),
                        threshold.reshape(()).float()])


# ---------------------------------------------------------------------------
# Plain PyTorch versions (the CPU path, and the kernels' yardstick on the
# card).
# ---------------------------------------------------------------------------

def forward_plain(x, w, mask, scal):
    w_eff, _ = _w_eff(w, mask, scal[0], scal[1])
    return torch.matmul(x, w_eff.T)


def dx_plain(g, w, mask, scal):
    w_eff, _ = _w_eff(w, mask, scal[0], scal[1])
    return torch.matmul(g, w_eff)


def dwda_plain(g, x, w, mask, scal, ste: bool):
    """``(dw, dalpha)`` by the JAX package's XLA formulas
    (fused_linear.py:382-390); dalpha is a 0-d tensor."""
    alpha, thr = scal[0], scal[1]
    wt = _ternarize(w, thr)
    G = torch.matmul(g.T, x)
    if mask is None:
        dw = G * alpha if ste else torch.zeros_like(G)
        da = torch.sum(G * wt)
    else:
        m = mask.to(w.dtype)
        inv_m = 1.0 - m
        dw = G * (alpha * inv_m + m) if ste else G * m
        da = torch.sum(G * wt * inv_m)
    return dw, da


# ---------------------------------------------------------------------------
# Kernel wrappers.
# ---------------------------------------------------------------------------

def _check(name, t, shape, dtype=torch.float32):
    if t.dtype != dtype or tuple(t.shape) != tuple(shape):
        raise ValueError(f"{name} must be {dtype} {tuple(shape)}, got "
                         f"{t.dtype} {tuple(t.shape)}")
    if not t.is_contiguous():
        raise ValueError(f"{name} must be contiguous")


def _check_common(ref, w, mask, scal):
    n, k = w.shape
    _check("w", w, (n, k))
    _check("scal", scal, (2,))
    if mask is not None:
        if mask.dtype not in (torch.bool, torch.uint8):
            raise ValueError(f"mask must be bool or uint8, got {mask.dtype}")
        _check("mask", mask, (n, k), mask.dtype)
    for name, t in (("w", w), ("mask", mask), ("scal", scal)):
        if t is not None and t.device != ref.device:
            raise ValueError(f"{name} on {t.device}, input on {ref.device}")
    if ref.device.type not in ("cpu", "cuda"):
        raise ValueError(f"unsupported device {ref.device}")
    if max(ref.numel(), w.numel()) >= 2 ** 31:
        raise ValueError("tensors of 2^31 or more elements are not supported")


def _launch_args(t):
    dev = t.device
    return (dev.index if dev.index is not None else 0,
            torch.cuda.current_stream(dev).cuda_stream)


def _mask_ptr(mask):
    return None if mask is None else mask.data_ptr()


_tickets: dict = {}


def _ticket(dev, stream, n=1):
    """``n`` int32 tickets for this device and stream, zeroed once here:
    the dW/dalpha kernel takes the first, the split forward one an output
    tile. Each launch leaves its tickets at 0 again, and launches on one
    stream run in order, so they share one buffer."""
    key = (dev.index, stream)
    if key not in _tickets or _tickets[key].numel() < n:
        _tickets[key] = torch.zeros(n, dtype=torch.int32, device=dev)
    return _tickets[key]


def forward_splits(m: int, n: int, k: int):
    """``(splits, chunk)``: how the forward kernel divides K over grid.z
    so that a short output still fills the card, two blocks an SM; chunk
    is a multiple of the ring's step and each split covers at least 64 of
    K (``chunk`` is K when there is one split). At the recipe's first head
    layer, 33 splits of 96 (264 blocks)."""
    tiles = -(-m // _TILE) * -(-n // _TILE)
    splits = max(1, min(_TARGET_BLOCKS // tiles, k // _SPLIT_MIN_K))
    if splits == 1:
        return 1, k
    chunk = -(-k // splits)
    chunk += (-chunk) % _STEP
    return -(-k // chunk), chunk


def fused_linear_forward(x, w, mask, scal):
    """``x (M, K) · w_eff (N, K)ᵀ`` -> (M, N) float32, in one launch."""
    m, k = x.shape
    n = w.shape[0]
    _check("x", x, (m, w.shape[1]))
    _check_common(x, w, mask, scal)
    if m * n >= 2 ** 31:
        raise ValueError(f"output of {m} x {n} elements is too large")
    if x.device.type == "cpu":
        return forward_plain(x, w, mask, scal)
    lib = load_library()
    y = torch.empty((m, n), dtype=torch.float32, device=x.device)
    if y.numel() == 0:
        return y
    splits, chunk = forward_splits(m, n, k)
    parts = tickets = None
    device, stream = _launch_args(x)
    if splits > 1:  # one 64 x 64 partial a block, one ticket a tile
        tiles = -(-m // _TILE) * -(-n // _TILE)
        parts = torch.empty(tiles * splits * _TILE * _TILE,
                            dtype=torch.float32, device=x.device)
        tickets = _ticket(x.device, stream, tiles)
    check(lib.atq_fused_forward(
        device, x.data_ptr(), w.data_ptr(), _mask_ptr(mask), scal.data_ptr(),
        y.data_ptr(), None if parts is None else parts.data_ptr(),
        None if tickets is None else tickets.data_ptr(), m, n, k, splits,
        chunk, stream), "fused_linear forward kernel")
    fused_linear_forward.launches += 1
    fused_linear_forward.flops += matmul_flops(m, n, k)
    return y


def fused_linear_dx(g, w, mask, scal):
    """``g (M, N) · w_eff (N, K)`` -> (M, K) float32."""
    m, n = g.shape
    k = w.shape[1]
    _check("g", g, (m, w.shape[0]))
    _check_common(g, w, mask, scal)
    if g.device.type == "cpu":
        return dx_plain(g, w, mask, scal)
    lib = load_library()
    dx = torch.empty((m, k), dtype=torch.float32, device=g.device)
    if dx.numel() == 0:
        return dx
    device, stream = _launch_args(g)
    check(lib.atq_fused_dx(
        device, g.data_ptr(), w.data_ptr(), _mask_ptr(mask), scal.data_ptr(),
        dx.data_ptr(), m, n, k, stream), "fused_linear dx kernel")
    fused_linear_dx.launches += 1
    fused_linear_dx.flops += matmul_flops(m, n, k)
    return dx


def fused_linear_dwda(g, x, w, mask, scal, ste: bool):
    """``(dw (N, K), dalpha ())`` from ``G = gᵀ · x``: dw is G·alpha or
    G·(alpha·(1−m) + m) under STE, G·m or exact zeros under parity, and
    dalpha = Σ G·tern(w)·(1−m)."""
    m, n = g.shape
    k = w.shape[1]
    _check("g", g, (m, w.shape[0]))
    _check("x", x, (m, k))
    _check_common(g, w, mask, scal)
    if g.device.type == "cpu":
        return dwda_plain(g, x, w, mask, scal, ste)
    lib = load_library()
    dev = g.device
    dw = torch.empty((n, k), dtype=torch.float32, device=dev)
    if dw.numel() == 0:
        return dw, torch.zeros((), dtype=torch.float32, device=dev)
    # dalpha, then one slot a block for the blocks' partials.
    out = torch.empty(1 + lib.atq_fused_dwda_partials(n, k),
                      dtype=torch.float32, device=dev)
    device, stream = _launch_args(g)
    check(lib.atq_fused_dwda(
        device, g.data_ptr(), x.data_ptr(), w.data_ptr(), _mask_ptr(mask),
        scal.data_ptr(), dw.data_ptr(), out.data_ptr(), out[1:].data_ptr(),
        _ticket(dev, stream).data_ptr(), m, n, k, int(ste), stream),
        "fused_linear dW/dalpha kernel")
    fused_linear_dwda.launches += 1
    fused_linear_dwda.flops += matmul_flops(m, n, k)
    return dw, out[0]


fused_linear_forward.launches = 0
fused_linear_dx.launches = 0
fused_linear_dwda.launches = 0
fused_linear_forward.flops = 0
fused_linear_dx.flops = 0
fused_linear_dwda.flops = 0


# ---------------------------------------------------------------------------
# The autograd op.
# ---------------------------------------------------------------------------

def _dispatch_backward(grad_mode, x, w, mask, scal, alpha, threshold, g,
                       needs):
    """The JAX ``custom_vjp`` backward (fused_linear.py:371-397): dx,
    dw by grad mode, dalpha broadcast to alpha's shape, zeros for the
    threshold; the mask is not differentiable."""
    dx = fused_linear_dx(g, w, mask, scal) if needs[0] else None
    dw = dalpha = None
    if needs[1] or needs[2]:
        dw, da = fused_linear_dwda(g, x, w, mask, scal,
                                   ste=grad_mode == "ste")
        dalpha = da.to(alpha.dtype).expand(alpha.shape).clone()
    dthr = torch.zeros_like(threshold) if needs[3] else None
    return dx, dw if needs[1] else None, dalpha if needs[2] else None, dthr


class _FusedQuantizedLinear(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, weight, alpha, threshold, mask, grad_mode):
        scal = scalars(alpha, threshold)
        ctx.save_for_backward(x, weight, mask, scal, alpha, threshold)
        ctx.grad_mode = grad_mode
        return fused_linear_forward(x, weight, mask, scal)

    @staticmethod
    def backward(ctx, g):
        x, weight, mask, scal, alpha, threshold = ctx.saved_tensors
        grads = _dispatch_backward(
            ctx.grad_mode, x, weight, mask, scal, alpha, threshold,
            g.contiguous(), ctx.needs_input_grad[:4])
        return (*grads, None, None)


def fused_quantized_linear(x, weight, alpha, threshold, mask=None,
                           grad_mode: str = "parity"):
    """``x @ (w_t·alpha·(1−mask) + w·mask)ᵀ`` as one fused op.

    ``threshold`` is the quantizer threshold (a 0-d tensor from
    ``ternary_threshold``, computed on the detached weight); ``mask=None``
    is the TernaryLinear form ``x @ (w_t·alpha)ᵀ``. Gradients: parity
    gives the latent weight exact zeros without a mask and ``G·m`` with
    one; STE gives ``G·alpha`` / ``G·(alpha·(1−m) + m)``; alpha gets
    ``Σ G·w_t·(1−m)``; the threshold gets zeros. Inputs may have any
    number of leading batch dims. float32 only.
    """
    if grad_mode not in GRAD_MODES:
        raise ValueError(f"unknown grad_mode: {grad_mode!r}")
    lead = x.shape[:-1]
    x2 = x.reshape(-1, x.shape[-1]).contiguous()
    if mask is not None and mask.dtype not in (torch.bool, torch.uint8):
        mask = mask != 0
    y = _FusedQuantizedLinear.apply(x2, weight.contiguous(), alpha,
                                    threshold, mask, grad_mode)
    return y.reshape(*lead, weight.shape[0]).to(x.dtype)
