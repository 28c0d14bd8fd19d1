"""Packed serving path: run trained ATQ layers from 2-bit weights.

Port of atq_tpu/serve/packed_model.py. Each quantized layer is exported
once into 2-bit planes plus a full-precision correction:

    w_mixed = w_t · alpha · (1 − mask) + w · mask
            = w_t · alpha + mask · (w − w_t · alpha)
    y = packed_matmul(x, packed(w_t), alpha) + x @ correctionᵀ + bias

The correction ``mask · (w − w_t · alpha)`` is rounded to bf16. By default
it is stored in ELL form (``corr_idx``/``corr_val``, width = the mean
per-row nonzero count) with a COO spill for the denser rows, built by the
native binding (native/__init__.py ``sparse_ell``), as in the JAX package;
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
  gather + einsum and the COO segment sum, plain torch ops as they are XLA
  ops on the JAX side. The segment sum takes the op that adds in a fixed
  order on each device (``index_put_`` with ``accumulate`` on CUDA,
  ``index_add_`` on the CPU), so a packed forward repeats bit for bit.

Export runs on the host CPU, as on the JAX side, and the entries are then
moved to the serving device. Indices are held as int64 (torch indexing
needs them) where the JAX export stores uint16, or int32 under
``ATQ_PACK32``; the values are the same, but ``packed_collection_bytes``
counts the tensors as stored, so it differs from the JAX count.
``PackedClassifier.memory_footprint_bytes`` counts the indices at the
JAX export's widths, so it equals the JAX package's figure.

:class:`PackedClassifier` is the classifier's deployment form: its conv
features dense, its head from :func:`pack_quantized_params`' entries.
"""

from __future__ import annotations

import os
from typing import Dict, Optional

import numpy as np
import torch

from atq_tpu_torch.core.packing import pack_planar, pack_planar32
from atq_tpu_torch.core.quantize import adaptive_ternary_quantization
from atq_tpu_torch.native import sparse_ell
from atq_tpu_torch.ops.ternary_matmul import (
    packed_ternary_matmul,
    packed_ternary_matmul_rpb,
)
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
    """Forward through a packed layer (routing in the module docstring):
    the sum of :func:`_packed_terms` in their order, then the bias."""
    terms = iter(_packed_terms(entry, x).values())
    y = next(terms)
    for t in terms:
        y = y + t.to(y.dtype)
    if "bias" in entry:
        y = y + entry["bias"]
    return y


def _packed_terms(entry: Dict, x: torch.Tensor) -> Dict[str, torch.Tensor]:
    """The terms a packed layer adds, by name, in the order it adds them:
    ``rpb`` (the fused kernel, a dense correction in it), or ``packed``
    (the packed kernel) then ``correction`` (dense), ``ell`` and ``coo``
    where the entry has them."""
    n, k = entry["shape"]
    alpha_neg = entry.get("alpha_neg")  # TTQ asymmetric scale, else None
    is_p32 = entry["packed"].dtype == torch.int32  # pack_planar32 layout
    if "correction" in entry and alpha_neg is None and not is_p32:
        return {"rpb": packed_ternary_matmul_rpb(
            x, entry["packed"], entry["correction"], (n, k),
            alpha=entry["alpha"])}
    terms = {"packed": packed_ternary_matmul(
        x, entry["packed"], (n, k), alpha=entry["alpha"],
        layout="planar32" if is_p32 else "planar", alpha_neg=alpha_neg)}
    if "correction" in entry:  # dense correction (TTQ or planar32)
        terms["correction"] = torch.matmul(x.float(),
                                           entry["correction"].float().T)
    if "corr_idx" in entry:
        gathered = x[:, entry["corr_idx"]]  # (m, N, C)
        terms["ell"] = torch.einsum("mnc,nc->mn", gathered.float(),
                                    entry["corr_val"].float())
    if "coo_row" in entry:
        contrib = x[:, entry["coo_col"]].float() * entry["coo_val"].float()
        spill = torch.zeros((n, x.shape[0]), dtype=torch.float32,
                            device=x.device)
        # The segment sum, in a fixed order on each device: index_add_ adds
        # with atomics on CUDA, index_put_'s accumulate sorts the indices
        # first there (and adds with atomics on the CPU).
        if x.device.type == "cuda":
            spill.index_put_((entry["coo_row"],), contrib.T,
                             accumulate=True)
        else:
            spill.index_add_(0, entry["coo_row"], contrib.T)
        terms["coo"] = spill.T
    return terms


def pack_quantized_params(params: Dict, quant: Dict, layer_names,
                          device=None) -> Dict[str, Dict]:
    """Pack the quantized layers ``layer_names`` of a JAX-layout model
    (``params``/``quant`` trees) by name, each entry on ``device``."""
    dev = resolve_device(device)
    return {name: pack_quantized_layer(params[name], quant.get(name),
                                       device=dev)
            for name in layer_names}


def _jax_itemsize(entry: Dict, field: str) -> int:
    """The width the JAX export stores an entry's field at: the planes and
    values as here, the ELL/COO indices as uint16 where the dimension they
    index fits it (int32 otherwise, and always under ``ATQ_PACK32``),
    where the port holds int64."""
    v = entry[field]
    if field not in ("corr_idx", "coo_row", "coo_col"):
        return v.element_size()
    if entry["packed"].dtype == torch.int32:  # the ATQ_PACK32 export
        return 4
    n, k = entry["shape"]
    extent = n if field == "coo_row" else k
    return 2 if extent <= np.iinfo(np.uint16).max else 4


class PackedClassifier:
    """Serving wrapper of ``ATQImageClassifier``: the model of
    models/image_classifier.py in eval mode, its full-precision conv
    features on their BatchNorm running statistics and its two head layers
    serving from 2-bit planes (:func:`attach_packed_collection`; on the
    card the packed matmul kernel, the port of ``_kernel``, with no dense
    fallback), the deployment target of the JAX package's class of the
    same name.

    ``params``, ``quant`` and ``batch_stats`` are the JAX-layout trees of
    a checkpoint (utils/jax_interop.py ``load_checkpoint``). ``use_rpb``
    and ``hidden_size`` describe the checkpoint, and a head that is not
    ``hidden_size`` wide, or whose precision mask is there without
    ``use_rpb`` or missing with it, raises. Everything is moved to
    ``device`` once, at construction."""

    def __init__(self, params: Dict, quant: Dict, batch_stats: Dict,
                 use_rpb: bool = True, hidden_size: int = 128,
                 device="cuda"):
        from atq_tpu_torch.models.image_classifier import ATQImageClassifier
        from atq_tpu_torch.utils.jax_interop import from_jax_variables

        head = params["classifier_0"]
        width, in_features = np.shape(head["weight"])
        if width != hidden_size:
            raise ValueError(f"the checkpoint's head is {width} wide, not "
                             f"hidden_size={hidden_size}")
        if use_rpb != ("precision_mask" in quant.get("classifier_0", {})):
            raise ValueError(f"use_rpb={use_rpb} does not match the "
                             f"checkpoint's head")
        self.device = resolve_device(device)
        self.model = ATQImageClassifier(
            num_classes=np.shape(params["classifier_3"]["weight"])[0],
            input_channels=np.shape(params["features"]["conv1"]["kernel"])[2],
            use_rpb=use_rpb, hidden_size=hidden_size,
            grad_mode="ttq" if "wp" in head else "parity",
            image_size=4 * int(round(np.sqrt(in_features / 64))),
            device=self.device,
            generator=torch.Generator())  # overwritten by the checkpoint
        self.model.load_state_dict(from_jax_variables(
            {"params": params, "quant": quant, "batch_stats": batch_stats}))
        self.packed = pack_quantized_params(
            params, quant, ["classifier_0", "classifier_3"],
            device=self.device)
        attach_packed_collection(self.model, {
            name: {"entry": e} for name, e in self.packed.items()})

    @torch.inference_mode()
    def __call__(self, x) -> torch.Tensor:
        """Logits for NHWC images (a tensor or an array), on the device."""
        return self.model(torch.as_tensor(x, dtype=torch.float32,
                                          device=self.device))

    def memory_footprint_bytes(self) -> Dict[str, int]:
        """Serving weight bytes, counted field for field as the JAX
        package counts them (the planes, the corrections at 2 bytes a
        value, the indices at the width its export stores them, the bias
        at 4 bytes a value), and the dense float32 weights' bytes."""
        total = 0
        for entry in self.packed.values():
            for field in ("packed", "correction", "corr_idx", "corr_val",
                          "coo_row", "coo_col", "coo_val", "bias"):
                if field in entry:
                    total += entry[field].numel() * _jax_itemsize(entry,
                                                                  field)
        dense = sum(int(np.prod(e["shape"])) * 4
                    for e in self.packed.values())
        return {"packed_bytes": int(total), "dense_fp32_bytes": int(dense)}


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
