"""Packed serving path: run trained ATQ layers from 2-bit weights.

Port of atq_tpu/serve/packed_model.py. Each quantized layer is exported
once into 2-bit planes plus a full-precision correction:

    w_mixed = w_t · alpha · (1 − mask) + w · mask
            = w_t · alpha + mask · (w − w_t · alpha)
    y = packed_matmul(x, packed(w_t), alpha) + x @ correctionᵀ + bias

The correction ``mask · (w − w_t · alpha)`` is rounded to bf16. By default
it is stored in ELL form (``corr_idx``/``corr_val``, width = the mean
per-row nonzero count) with a COO spill for the denser rows;
``sparse_correction=False`` stores it dense as a (N, K) bf16
``correction`` instead. ``ATQ_PACK32=1``, read at export time, stores the
planes as int32 ``planar32`` words (16 fields a word) instead of uint8
planes.

``packed_linear_apply`` routes as the JAX package does:
- a dense correction, not TTQ, uint8 planes: the fused RPB kernel
  (ops/ternary_matmul.py ``ternary_matmul_rpb``);
- a dense correction with TTQ or planar32: the packed kernel plus
  ``torch.matmul`` with the correction (an XLA op on the JAX side);
- otherwise the packed kernel (``planar`` or ``planar32``) plus the ELL
  gather + einsum and the COO segment sum (``index_add_``), plain torch ops
  as they are XLA ops on the JAX side.

Export runs on the host CPU, as on the JAX side, and the entries are then
moved to the serving device. Indices are held as int64 (torch indexing
needs them) where the JAX export stores uint16, or int32 under
``ATQ_PACK32``; the values are the same, but ``packed_collection_bytes``
counts the tensors as stored, so it differs from the JAX count.
"""

from __future__ import annotations

import os
from typing import Dict, Optional

import numpy as np
import torch

from atq_tpu_torch.core.packing import pack_planar, pack_planar32
from atq_tpu_torch.core.quantize import adaptive_ternary_quantization
from atq_tpu_torch.ops.ternary_matmul import (
    packed_ternary_matmul,
    packed_ternary_matmul_rpb,
)
from atq_tpu_torch.serve.sparse import sparse_ell
from atq_tpu_torch.utils.platform import resolve_device


def _pack32() -> bool:
    """``ATQ_PACK32=1``: export the planes as int32 ``planar32`` words (same
    2 bits a weight). Read at export time, as in the JAX package."""
    return os.environ.get("ATQ_PACK32", "0") == "1"


def _cpu_f32(a) -> torch.Tensor:
    return torch.as_tensor(np.asarray(a), dtype=torch.float32)


def _bf16(a: np.ndarray) -> torch.Tensor:
    return torch.from_numpy(np.ascontiguousarray(a, np.float32)).to(
        torch.bfloat16)


def _sparse_ell(correction: np.ndarray) -> Optional[Dict]:
    """ELL+COO entry fields for a (bf16-rounded) correction matrix."""
    n, _ = correction.shape
    total_nnz = int((correction != 0).sum())
    if total_nnz == 0:
        return None
    c = max(1, int(round(total_nnz / n)))  # Python's banker's rounding
    idx, val, coo_row, coo_col, coo_val = sparse_ell(correction, c)
    out = {"corr_idx": torch.from_numpy(idx.astype(np.int64)),
           "corr_val": _bf16(val)}
    if coo_row.size:
        out["coo_row"] = torch.from_numpy(coo_row.astype(np.int64))
        out["coo_col"] = torch.from_numpy(coo_col.astype(np.int64))
        out["coo_val"] = _bf16(coo_val)
    return out


def pack_quantized_layer(params: Dict, quant: Optional[Dict] = None,
                         device=None, sparse_correction: bool = True) -> Dict:
    """Export one TernaryLinear/RPB layer (JAX-named ``params``/``quant``
    dicts of arrays or tensors) into a serving entry on ``device``.

    The checkpoint's trained alpha overrides the optimal one; the sparsity
    comes from ``quant["sparsity_target"]`` (default 0.3). TTQ layers
    (``wp``/``wn`` present) keep the same planes and carry both scales.
    ``sparse_correction=False`` stores the RPB correction dense (bf16)."""
    dev = resolve_device(device)
    quant = quant or {}
    weight = _cpu_f32(params["weight"])
    alpha = _cpu_f32(params["alpha"])
    sparsity = _cpu_f32(quant.get("sparsity_target", 0.3))
    is_ttq = "wp" in params and "wn" in params
    w_t, a = adaptive_ternary_quantization(weight, alpha=alpha,
                                           sparsity_target=sparsity)
    entry = {"packed": pack_planar32(w_t) if _pack32() else pack_planar(w_t),
             "alpha": a.reshape(()).clone(),
             "shape": tuple(int(d) for d in weight.shape)}
    if is_ttq:
        entry["alpha"] = _cpu_f32(params["wp"]).reshape(())
        entry["alpha_neg"] = _cpu_f32(params["wn"]).reshape(())
    if "bias" in params:
        entry["bias"] = _cpu_f32(params["bias"])
    mask = quant.get("precision_mask")
    if mask is not None:
        w_t_np = w_t.numpy()
        if is_ttq:
            wp, wn = float(entry["alpha"]), float(entry["alpha_neg"])
            w_q = wp * np.maximum(w_t_np, 0.0) + wn * np.minimum(w_t_np, 0.0)
        else:
            w_q = w_t_np * float(a.reshape(()))
        correction = np.asarray(mask) * (weight.numpy() - w_q)
        # bf16-round the stored values (same rounding as the JAX export).
        correction = _bf16(correction).float().numpy()
        if sparse_correction:
            ell = _sparse_ell(correction)
            if ell is not None:
                entry.update(ell)
        else:
            entry["correction"] = _bf16(correction)
    return {k: (v.to(dev) if isinstance(v, torch.Tensor) else v)
            for k, v in entry.items()}


def packed_linear_apply(entry: Dict, x: torch.Tensor) -> torch.Tensor:
    """Forward through a packed layer (routing in the module docstring),
    then the bias."""
    n, k = entry["shape"]
    alpha_neg = entry.get("alpha_neg")  # TTQ asymmetric scale, else None
    is_p32 = entry["packed"].dtype == torch.int32  # pack_planar32 layout
    if "correction" in entry and alpha_neg is None and not is_p32:
        y = packed_ternary_matmul_rpb(x, entry["packed"], entry["correction"],
                                      (n, k), alpha=entry["alpha"])
    else:
        y = _packed_and_correction(entry, x, n, k, alpha_neg, is_p32)
    if "bias" in entry:
        y = y + entry["bias"]
    return y


def _packed_and_correction(entry, x, n, k, alpha_neg, is_p32):
    y = packed_ternary_matmul(x, entry["packed"], (n, k),
                              alpha=entry["alpha"],
                              layout="planar32" if is_p32 else "planar",
                              alpha_neg=alpha_neg)
    if "correction" in entry:  # dense correction (TTQ or planar32)
        y = y + torch.matmul(x.float(),
                             entry["correction"].float().T).to(y.dtype)
    if "corr_idx" in entry:
        gathered = x[:, entry["corr_idx"]]  # (m, N, C)
        vals = entry["corr_val"].float()
        y = y + torch.einsum("mnc,nc->mn", gathered.float(),
                             vals).to(y.dtype)
    if "coo_row" in entry:
        contrib = x[:, entry["coo_col"]].float() * entry["coo_val"].float()
        spill = torch.zeros((n, x.shape[0]), dtype=torch.float32,
                            device=x.device)
        spill.index_add_(0, entry["coo_row"], contrib.T)
        y = y + spill.T.to(y.dtype)
    return y


def export_packed_collection(params: Dict, quant: Optional[Dict] = None,
                             device=None,
                             sparse_correction: bool = True) -> Dict:
    """Export every quantized layer of a JAX-layout param tree.

    Walks ``params`` for subtrees shaped like TernaryLinear / RPB
    (``{'weight' (2-D), 'alpha', ...}``) and mirrors them as
    ``{..., layer: {'entry': <packed entry>}}``, the JAX package's 'packed'
    collection; :func:`attach_packed_collection` hands it to a model."""
    dev = resolve_device(device)
    quant = quant or {}

    def walk(p_node, q_node):
        if not isinstance(p_node, dict):
            return None
        if ("weight" in p_node and "alpha" in p_node
                and np.ndim(p_node["weight"]) == 2):
            return {"entry": pack_quantized_layer(
                p_node, q_node if isinstance(q_node, dict) else None,
                device=dev, sparse_correction=sparse_correction)}
        out = {}
        for key, v in p_node.items():
            sub = walk(v, q_node.get(key, {}) if isinstance(q_node, dict)
                       else {})
            if sub:
                out[key] = sub
        return out or None

    return walk(params, quant) or {}


def attach_packed_collection(model: torch.nn.Module, packed: Dict) -> None:
    """Make every layer named in ``packed`` serve from its entry (the
    port's counterpart of passing the 'packed' collection to apply)."""

    def walk(node, path):
        if "entry" in node:
            model.get_submodule(".".join(path)).packed_entry = node["entry"]
            return
        for key, sub in node.items():
            walk(sub, path + [key])

    walk(packed, [])


def packed_collection_bytes(packed: Dict) -> int:
    """Serving weight bytes held by an exported collection: the tensors as
    stored, so int64 indices count 8 bytes each where the JAX count has 2
    (uint16) or 4 (int32); the two totals differ by that."""
    total = 0

    def walk(node):
        nonlocal total
        if "packed" in node and "shape" in node:
            for key, v in node.items():
                if isinstance(v, torch.Tensor) and key not in (
                        "alpha", "alpha_neg"):
                    total += v.numel() * v.element_size()
        else:
            for v in node.values():
                walk(v)

    walk(packed)
    return total
