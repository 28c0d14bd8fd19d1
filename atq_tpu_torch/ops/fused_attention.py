"""Fused short-sequence multi-head attention, forward and backward.

PyTorch counterpart of atq_tpu/ops/fused_attention.py: the Pallas kernels
``_fwd_kernel`` (behind ``_fused_fwd``) and ``_bwd_kernel`` (behind
``_fused_bwd``). On a CUDA tensor each wrapper launches its kernel in
``csrc/fused_attention.cu``; on a CPU tensor it takes its plain PyTorch
version, which repeats the JAX kernel op for op: float32 scores scaled after
the first product, the additive bias, the row max guarded at -1e30, p/l cast
to the input dtype before the second product, and in the backward dP kept in
float32 and dS cast to the input dtype before its two products. A CUDA
tensor the kernel cannot take raises; there is no other route. Each wrapper
counts its launches and their FLOPs (:func:`forward_flops`,
:func:`backward_flops`: its plain version's products).

:func:`fused_attention` is the op the attention module calls: one
``torch.autograd.Function`` whose forward and backward are the kernels. The
bias is the constant key-padding mask and gets no gradient. float32 and
bfloat16; S <= 512 and head dim D <= 128.
"""

from __future__ import annotations

from typing import Optional

import torch

from atq_tpu_torch.ops._build import check, load_library

MAX_SEQ, MAX_HEAD_DIM = 512, 128
_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
_GUARD = -1e30


def _scores(q, k, scale, bias):
    s = torch.matmul(q.float(), k.float().transpose(-1, -2)) * scale
    return s if bias is None else s + bias


def _softmax32(s):
    m = torch.clamp(s.amax(dim=-1, keepdim=True), min=_GUARD)
    e = torch.exp(s - m)
    return e / e.sum(dim=-1, keepdim=True)


def forward_plain(q, k, v, scale: float, bias=None):
    """Plain PyTorch version of the forward (``_fwd_kernel``)."""
    p = _softmax32(_scores(q, k, scale, bias)).to(q.dtype)
    return torch.matmul(p.float(), v.float()).to(q.dtype)


def backward_plain(q, k, v, scale: float, bias, do):
    """Plain PyTorch version of the backward (``_bwd_kernel``):
    ``(dq, dk, dv)`` in q's dtype."""
    dtype = q.dtype
    p32 = _softmax32(_scores(q, k, scale, bias))
    p = p32.to(dtype)
    dof = do.float()
    dv = torch.matmul(p.float().transpose(-1, -2), dof)
    dp = torch.matmul(dof, v.float().transpose(-1, -2))
    ds = (p32 * (dp - torch.sum(dp * p32, dim=-1, keepdim=True))).to(dtype)
    dq = torch.matmul(ds.float(), k.float()) * scale
    dk = torch.matmul(ds.float().transpose(-1, -2), q.float()) * scale
    return dq.to(dtype), dk.to(dtype), dv.to(dtype)


def _check(q, k, v, bias, do=None):
    if q.ndim != 4:
        raise ValueError(f"q must be (B, H, S, D), got {tuple(q.shape)}")
    b, h, s, d = q.shape
    for name, t in (("k", k), ("v", v), ("do", do)):
        if t is None:
            continue
        if tuple(t.shape) != tuple(q.shape) or t.dtype != q.dtype:
            raise ValueError(f"{name} must match q ({q.dtype} "
                             f"{tuple(q.shape)}), got {t.dtype} "
                             f"{tuple(t.shape)}")
        if t.device != q.device:
            raise ValueError(f"{name} on {t.device}, q on {q.device}")
    if q.dtype not in _DTYPES:
        raise ValueError(f"fused attention takes float32 or bfloat16, got "
                         f"{q.dtype}")
    if not 0 < s <= MAX_SEQ or not 0 < d <= MAX_HEAD_DIM:
        raise ValueError(f"fused attention takes S <= {MAX_SEQ} and "
                         f"D <= {MAX_HEAD_DIM}, got S={s}, D={d}")
    if b * h == 0 or b >= 2 ** 16 or h >= 2 ** 16:
        raise ValueError(f"batch {b} and heads {h} must be in [1, 2^16)")
    if bias is not None:
        if bias.dtype != torch.float32 or tuple(bias.shape) != (b, 1, 1, s):
            raise ValueError(f"bias must be float32 {(b, 1, 1, s)}, got "
                             f"{bias.dtype} {tuple(bias.shape)}")
        if bias.device != q.device:
            raise ValueError(f"bias on {bias.device}, q on {q.device}")
    for name, t in (("q", q), ("k", k), ("v", v), ("do", do), ("bias", bias)):
        if t is not None and not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
    if q.device.type not in ("cpu", "cuda"):
        raise ValueError(f"unsupported device {q.device}")


def _launch_args(t):
    dev = t.device
    return (dev.index if dev.index is not None else 0,
            torch.cuda.current_stream(dev).cuda_stream)


def _ptr(t):
    return None if t is None else t.data_ptr()


def forward_flops(b: int, h: int, s: int, d: int) -> int:
    """The forward's two products, q·kᵀ and p·v: 4·B·H·S²·D, as
    ``FlopCounterMode`` counts :func:`forward_plain`."""
    return 4 * b * h * s * s * d


def backward_flops(b: int, h: int, s: int, d: int) -> int:
    """The backward's five products (the scores again, dv, dP, dq, dk):
    10·B·H·S²·D, as ``FlopCounterMode`` counts :func:`backward_plain`."""
    return 10 * b * h * s * s * d


def fused_attention_forward(q, k, v, scale: float, bias=None):
    """``softmax(q·kᵀ·scale + bias)·v`` -> (B, H, S, D) in q's dtype."""
    _check(q, k, v, bias)
    if q.device.type == "cpu":
        return forward_plain(q, k, v, scale, bias)
    lib = load_library()
    b, h, s, d = q.shape
    o = torch.empty_like(q)
    device, stream = _launch_args(q)
    check(lib.atq_attention_forward(
        device, _DTYPES[q.dtype], q.data_ptr(), k.data_ptr(), v.data_ptr(),
        _ptr(bias), o.data_ptr(), b, h, s, d, float(scale), stream),
        "fused attention forward kernel")
    fused_attention_forward.launches += 1
    fused_attention_forward.flops += forward_flops(b, h, s, d)
    return o


def fused_attention_backward(q, k, v, scale: float, bias, do):
    """``(dq, dk, dv)`` of :func:`fused_attention_forward` for the output
    gradient ``do``."""
    _check(q, k, v, bias, do)
    if q.device.type == "cpu":
        return backward_plain(q, k, v, scale, bias, do)
    lib = load_library()
    b, h, s, d = q.shape
    dq, dk, dv = (torch.empty_like(q) for _ in range(3))
    # Each query row's softmax max m, sum l and delta = rowsum(dP·p32),
    # from the first launch to the second (the fourth float pads a row to
    # 16 bytes). P and dS stay in the kernels' shared memory.
    stats = torch.empty((b, h, s, 4), dtype=torch.float32, device=q.device)
    device, stream = _launch_args(q)
    check(lib.atq_attention_backward(
        device, _DTYPES[q.dtype], q.data_ptr(), k.data_ptr(), v.data_ptr(),
        _ptr(bias), do.data_ptr(), dq.data_ptr(), dk.data_ptr(),
        dv.data_ptr(), stats.data_ptr(), b, h, s, d, float(scale), stream),
        "fused attention backward kernels")
    fused_attention_backward.launches += 1
    fused_attention_backward.flops += backward_flops(b, h, s, d)
    return dq, dk, dv


fused_attention_forward.launches = 0
fused_attention_backward.launches = 0
fused_attention_forward.flops = 0
fused_attention_backward.flops = 0


class _FusedAttention(torch.autograd.Function):
    @staticmethod
    def forward(ctx, q, k, v, bias, scale):
        ctx.save_for_backward(q, k, v, bias)
        ctx.scale = scale
        return fused_attention_forward(q, k, v, scale, bias)

    @staticmethod
    def backward(ctx, do):
        q, k, v, bias = ctx.saved_tensors
        dq, dk, dv = fused_attention_backward(q, k, v, ctx.scale, bias,
                                              do.contiguous())
        return dq, dk, dv, None, None


def fused_attention(q, k, v, scale: float, bias=None):
    """Softmax(q @ kᵀ · scale + bias) @ v, the forward and the backward
    each one kernel on the card. q, k, v: (B, H, S, D); bias: optional
    additive float32 (B, 1, 1, S) (the key-padding form, no gradient).
    Returns (B, H, S, D) in q's dtype."""
    if bias is not None:
        bias = bias.contiguous()
    return _FusedAttention.apply(q.contiguous(), k.contiguous(),
                                 v.contiguous(), bias, float(scale))


def padding_bias(key_padding_mask, seq_length: int) -> Optional[torch.Tensor]:
    """Boolean (B, S) pad mask (True = pad) or 1-D lengths -> additive
    float32 (B, 1, 1, S) bias for :func:`fused_attention`: -1e30 at the
    padded keys, so a fully padded row becomes uniform rather than NaN."""
    if key_padding_mask is None:
        return None
    mask = torch.as_tensor(key_padding_mask)
    if mask.ndim == 1:
        positions = torch.arange(seq_length, device=mask.device)[None, :]
        mask = positions >= mask[:, None]
    zero = torch.zeros((), dtype=torch.float32, device=mask.device)
    neg = torch.full((), _GUARD, dtype=torch.float32, device=mask.device)
    return torch.where(mask.bool(), neg, zero)[:, None, None, :]
