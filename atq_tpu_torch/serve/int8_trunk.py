"""Int8 post-training quantization of the float ResNet trunk (serving path).

Port of atq_tpu/serve/int8_trunk.py, with the same rules:

- **Weights**: symmetric per-output-channel int8, ``scale = max|W| / 127``
  (an all-zero channel gets scale 1), ``round`` then ``clip(-127, 127)``.
- **BatchNorm**: eval-mode BatchNorm folds exactly into each conv's
  per-channel rescale and bias.
- **Activations**: dynamic symmetric per-tensor int8,
  ``a_scale = max(max|x|, 1e-8) / 127`` computed on the device per call.
- **Compute**: the JAX package convolves the int8 operands with an int32
  accumulator. PyTorch has no int8 convolution on CUDA, so the port runs
  every conv as im2col (``Tensor.unfold`` on the int8 NHWC activations)
  and one integer matrix product: ``torch._int_mm`` (int8 x int8 -> int32,
  cuBLASLt) on the card, a float64 matmul over the same integers on the CPU
  (exact: every |sum| <= 127^2 * 4608 < 2^53). Both equal the JAX int32
  result bit for bit before the float32 rescale
  ``y * (a_scale * scale) + bias``. ``ATQ_INT8_DEQUANT=1`` keeps its
  meaning: a float32 product over the same integers.

Each entry holds its int8 weights as an (O, K_pad) matrix whose transpose
im2col's patches multiply: K = C·kh·kw in (C, kh, kw) order, zero-padded to
a multiple of 8 as ``_int_mm`` needs (the stem's 147 -> 152; zero columns
add nothing). cuBLASLt's int8 product wants this operand column-major (with
both operands row-major it refuses some shapes), hence (O, K_pad) and a
transposed view. ``int8_collection_bytes`` counts the stem's padding, which
the JAX count does not.

``export_int8_collection`` walks a JAX-layout param tree for ResNet trunks
and returns the 'int8' collection (same paths, each trunk under
``'trunk'``); ``attach_int8_collection`` hands each trunk to its
``ResNetFeatures``.
"""

from __future__ import annotations

import os
from typing import Dict, Sequence

import numpy as np
import torch
import torch.nn.functional as F

from atq_tpu_torch.utils.platform import resolve_device

_BN_EPS = 1e-5  # models/resnet.py BatchNorm


def _quantize_weight(kernel: np.ndarray):
    """(kh, kw, I, O) f32 -> (int8 kernel, per-O scale)."""
    kernel = np.asarray(kernel, np.float32)
    absmax = np.abs(kernel).reshape(-1, kernel.shape[-1]).max(axis=0)
    scale = np.where(absmax > 0, absmax / 127.0, 1.0).astype(np.float32)
    q = np.clip(np.round(kernel / scale), -127, 127).astype(np.int8)
    return q, scale


def _fold_bn(bn_params: Dict, bn_stats: Dict):
    """Eval-mode BatchNorm as an exact per-channel affine (s, b)."""
    gamma = np.asarray(bn_params["scale"], np.float32)
    beta = np.asarray(bn_params["bias"], np.float32)
    mean = np.asarray(bn_stats["mean"], np.float32)
    var = np.asarray(bn_stats["var"], np.float32)
    s = gamma / np.sqrt(var + _BN_EPS)
    return s, beta - mean * s


def kernel_matrix(q_hwio: np.ndarray) -> np.ndarray:
    """An int8 (kh, kw, I, O) kernel as the (O, K_pad) matrix whose
    transpose multiplies im2col's patches."""
    kh, kw, cin, cout = q_hwio.shape
    mat = q_hwio.transpose(3, 2, 0, 1).reshape(cout, cin * kh * kw)
    return np.pad(mat, ((0, 0), (0, (-mat.shape[1]) % 8)))


def _export_conv_bn(conv_params: Dict, bn_params: Dict, bn_stats: Dict,
                    device) -> Dict:
    q, w_scale = _quantize_weight(conv_params["kernel"])
    bn_s, bn_b = _fold_bn(bn_params, bn_stats)
    return {
        "kernel": torch.from_numpy(np.ascontiguousarray(
            kernel_matrix(q))).to(device),
        "ksize": tuple(int(d) for d in q.shape[:3]),  # (kh, kw, I)
        "scale": torch.from_numpy(w_scale * bn_s).to(device),
        "bias": torch.from_numpy(bn_b).to(device),
    }


def export_int8_trunk(params: Dict, stats: Dict, device=None) -> Dict:
    """A ResNetFeatures' JAX-layout (params, batch_stats) pair -> the int8
    serving tree on ``device``. Stage structure comes from the param keys,
    so resnet18 (BasicBlock) and resnet50 (Bottleneck) both work."""
    dev = resolve_device(device)
    tree = {"conv1": _export_conv_bn(params["conv1"], params["bn1"],
                                     stats["bn1"], dev)}
    for name in sorted(k for k in params if k.startswith("layer")):
        block_p, block_s = params[name], stats[name]
        entry = {}
        for c in ("conv1", "conv2", "conv3"):
            if c in block_p:
                bn = "bn" + c[-1]
                entry[c] = _export_conv_bn(block_p[c], block_p[bn],
                                           block_s[bn], dev)
        if "downsample_conv" in block_p:
            entry["downsample"] = _export_conv_bn(
                block_p["downsample_conv"], block_p["downsample_bn"],
                block_s["downsample_bn"], dev)
        tree[name] = entry
    return tree


def _dequant_mode() -> bool:
    return os.environ.get("ATQ_INT8_DEQUANT", "0") == "1"


def _im2col(xq: torch.Tensor, kh: int, kw: int, stride: int, pad: int,
            k_pad: int):
    """(B, H, W, C) -> ((B·Ho·Wo, K_pad) patches, (B, Ho, Wo)); K in
    (C, kh, kw) order, zero columns up to ``k_pad``."""
    if pad:
        xq = F.pad(xq, (0, 0, pad, pad, pad, pad))
    patches = xq.unfold(1, kh, stride).unfold(2, kw, stride)
    b, ho, wo = patches.shape[:3]
    a = patches.reshape(b * ho * wo, -1)
    if k_pad != a.shape[1]:
        a = F.pad(a, (0, k_pad - a.shape[1]))
    return a.contiguous(), (b, ho, wo)


def _int_matmul(a: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """Exact int8 product ``a @ wᵀ`` as float32: ``torch._int_mm`` (int32)
    on the card, float64 over the integers on the CPU."""
    if a.device.type == "cuda":
        m = a.shape[0]
        if m <= 16:  # _int_mm wants more than 16 rows; zero rows add nothing
            a = F.pad(a, (0, 0, 0, 17 - m))
        return torch._int_mm(a, w.t())[:m].float()
    return torch.matmul(a.double(), w.double().t()).float()


def int8_conv(entry: Dict, x: torch.Tensor, stride: int = 1,
              padding: int = 1) -> torch.Tensor:
    """Quantize ``x`` (NHWC) per tensor, convolve in integers, rescale:
    ``conv(x_q, W_q) * (a_scale * entry.scale) + entry.bias`` (NHWC)."""
    x = x.float()
    # A tensor divisor: PyTorch divides a CUDA tensor by a Python scalar as
    # a product with its reciprocal, which can miss the quotient by an ulp
    # and move the quantization grid off the CPU's (and JAX's).
    a_scale = torch.clamp(x.abs().max(), min=1e-8) / torch.full(
        (), 127.0, device=x.device)
    xq = torch.clamp(torch.round(x / a_scale), -127, 127)
    kh, kw, _ = entry["ksize"]
    w = entry["kernel"]
    if _dequant_mode():
        a, (b, ho, wo) = _im2col(xq, kh, kw, stride, padding, w.shape[1])
        y = torch.matmul(a, w.float().t())
    else:
        a, (b, ho, wo) = _im2col(xq.to(torch.int8), kh, kw, stride, padding,
                                 w.shape[1])
        y = _int_matmul(a, w)
    y = y.reshape(b, ho, wo, -1)
    return y * (a_scale * entry["scale"]) + entry["bias"]


def int8_resnet_apply(tree: Dict, x: torch.Tensor,
                      stage_sizes: Sequence[int],
                      bottleneck: bool = False) -> torch.Tensor:
    """Trunk forward from the int8 tree (NHWC in, pooled features out):
    stem 7x7/2 pad 3, 3x3/2 max pool, the stages, global average pool."""
    x = F.relu(int8_conv(tree["conv1"], x, stride=2, padding=3))
    x = F.max_pool2d(x.permute(0, 3, 1, 2), 3, stride=2,
                     padding=1).permute(0, 2, 3, 1)
    for stage, num_blocks in enumerate(stage_sizes):
        for block_idx in range(num_blocks):
            entry = tree[f"layer{stage + 1}_{block_idx}"]
            stride = 2 if stage > 0 and block_idx == 0 else 1
            residual = x
            if bottleneck:
                y = F.relu(int8_conv(entry["conv1"], x, 1, 0))
                y = F.relu(int8_conv(entry["conv2"], y, stride))
                y = int8_conv(entry["conv3"], y, 1, 0)
            else:
                y = F.relu(int8_conv(entry["conv1"], x, stride))
                y = int8_conv(entry["conv2"], y)
            if "downsample" in entry:
                residual = int8_conv(entry["downsample"], x, stride, 0)
            x = F.relu(y + residual)
    return x.mean(dim=(1, 2))


def _looks_like_trunk(node) -> bool:
    return (isinstance(node, dict) and "conv1" in node and "bn1" in node
            and "layer1_0" in node)


def export_int8_collection(params: Dict, batch_stats: Dict,
                           device=None) -> Dict:
    """The 'int8' collection of a JAX-layout param tree: every ResNet trunk,
    at its path, under a ``'trunk'`` key."""
    dev = resolve_device(device)

    def walk(p_node, s_node):
        if not isinstance(p_node, dict):
            return None
        if _looks_like_trunk(p_node):
            return {"trunk": export_int8_trunk(p_node, s_node or {}, dev)}
        out = {}
        for k, v in p_node.items():
            sub = walk(v, s_node.get(k, {}) if isinstance(s_node, dict)
                       else {})
            if sub:
                out[k] = sub
        return out or None

    return walk(params, batch_stats) or {}


def attach_int8_collection(model: torch.nn.Module, col: Dict) -> None:
    """Make every ResNetFeatures named in ``col`` serve from its int8
    trunk."""

    def walk(node, path):
        if "trunk" in node:
            model.get_submodule(".".join(path)).int8_trunk = node["trunk"]
            return
        for key, sub in node.items():
            walk(sub, path + [key])

    walk(col, [])


def int8_collection_bytes(col: Dict) -> int:
    """Serving weight bytes in an exported 'int8' collection."""
    total = 0

    def walk(node):
        nonlocal total
        if isinstance(node, dict):
            if "kernel" in node and "scale" in node:
                total += node["kernel"].numel()  # int8
                total += node["scale"].numel() * 4 + node["bias"].numel() * 4
            else:
                for v in node.values():
                    walk(v)

    walk(col)
    return total
