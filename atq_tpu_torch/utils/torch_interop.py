"""PyTorch reference-checkpoint interop (port of
atq_tpu/utils/torch_interop.py).

Converts reference-format ``.pth`` state dicts (torch ``nn.Module`` naming,
NCHW conv layout) into the JAX layout's param/quant/batch-stats trees, with
numpy leaves, and back. The trees land in the port's modules through
utils/jax_interop.py: ``from_jax_variables({"params": params, "quant":
quant, "batch_stats": stats})`` is the module's state dict (the retrieval
model's ``load_jax_variables`` takes the variables as they are). Covers:

- the classification model ``ATQImageClassifier`` (the reference's
  ``checkpoints/atq_model_{dataset}.pth``);
- the retrieval model ``ATQMultimodalRetrieval`` (``best_model.pth`` /
  ``final_model.pth``);
- bare torchvision ResNet backbones (models/resnet.py
  ``load_torch_state_dict``).

Layout conversions, as in the JAX module:
- conv weights (O, I, kh, kw) -> (kh, kw, I, O);
- the first linear after the flattened conv stack: torch flattens NCHW as
  (C, H, W), the JAX layout flattens NHWC as (H, W, C), so the weight's
  input columns are permuted;
- linear weights keep the torch (out, in) layout.

Leaves keep the dtype they come with (the JAX module's array conversion
would narrow a float64 or int64 leaf; reference checkpoints hold float32).
"""

from __future__ import annotations

from typing import Dict

import numpy as np

from atq_tpu_torch.models.resnet import load_torch_state_dict
from atq_tpu_torch.nn.transformer import (
    _flatten,
    _unroll,
    is_scanned_text_layout,
)


def _npy(v):
    return v.detach().cpu().numpy() if hasattr(v, "detach") else np.asarray(v)


def load_torch_file(path: str) -> Dict[str, np.ndarray]:
    """A ``.pth`` state dict (or a ``{"model_state_dict": ...}`` bundle)
    as numpy arrays, read with ``weights_only=True``."""
    import torch

    sd = torch.load(path, map_location="cpu", weights_only=True)
    if isinstance(sd, dict) and "model_state_dict" in sd:
        sd = sd["model_state_dict"]
    return {k: _npy(v) for k, v in sd.items()}


def _chw_to_hwc_columns(weight: np.ndarray, c: int, h: int, w: int
                        ) -> np.ndarray:
    """Permute a linear weight's input columns from torch's (C, H, W)
    flatten order to NHWC's (H, W, C)."""
    out_f = weight.shape[0]
    return (weight.reshape(out_f, c, h, w)
            .transpose(0, 2, 3, 1)
            .reshape(out_f, c * h * w))


def _set(tree: dict, path: tuple, value):
    node = tree
    for key in path[:-1]:
        node = node.setdefault(key, {})
    node[path[-1]] = np.asarray(value)


def import_classifier_state_dict(sd: Dict[str, np.ndarray],
                                 use_rpb: bool = True,
                                 hidden_size: int = 128):
    """Reference ATQImageClassifier state_dict -> (params, quant,
    batch_stats) for models.image_classifier.ATQImageClassifier.

    Reference module names: features.{0,1,4,5}.* (convs/bns),
    classifier.{0,3}.{weight,alpha,bias,precision_mask}
    (image_classifier.py:19-48)."""
    params: dict = {}
    quant: dict = {}
    stats: dict = {}

    conv_map = {"features.0": ("features", "conv1"),
                "features.4": ("features", "conv2")}
    bn_map = {"features.1": ("features", "bn1"),
              "features.5": ("features", "bn2")}
    for tname, fpath in conv_map.items():
        _set(params, fpath + ("kernel",),
             sd[f"{tname}.weight"].transpose(2, 3, 1, 0))
        _set(params, fpath + ("bias",), sd[f"{tname}.bias"])
    for tname, fpath in bn_map.items():
        _set(params, fpath + ("scale",), sd[f"{tname}.weight"])
        _set(params, fpath + ("bias",), sd[f"{tname}.bias"])
        _set(stats, fpath + ("mean",), sd[f"{tname}.running_mean"])
        _set(stats, fpath + ("var",), sd[f"{tname}.running_var"])

    for tidx, name in ((0, "classifier_0"), (3, "classifier_3")):
        w = sd[f"classifier.{tidx}.weight"]
        if tidx == 0:
            # input is the flattened conv stack: (64, 7, 7) CHW -> HWC
            w = _chw_to_hwc_columns(w, 64, 7, 7)
        _set(params, (name, "weight"), w)
        _set(params, (name, "alpha"), sd[f"classifier.{tidx}.alpha"])
        if f"classifier.{tidx}.bias" in sd:
            _set(params, (name, "bias"), sd[f"classifier.{tidx}.bias"])
        if use_rpb and f"classifier.{tidx}.precision_mask" in sd:
            m = sd[f"classifier.{tidx}.precision_mask"]
            if tidx == 0:
                m = _chw_to_hwc_columns(m, 64, 7, 7)
            _set(quant, (name, "precision_mask"), m)
            _set(quant, (name, "sparsity_target"), np.float32(0.3))
    return params, quant, stats


def _import_quantized_linear(sd, prefix: str, params: dict, quant: dict,
                             path: tuple, sparsity: float = 0.1):
    """Map one reference TernaryLinear/RPB layer's tensors into our trees."""
    _set(params, path + ("weight",), sd[f"{prefix}.weight"])
    _set(params, path + ("alpha",), sd[f"{prefix}.alpha"])
    if f"{prefix}.bias" in sd:
        _set(params, path + ("bias",), sd[f"{prefix}.bias"])
    if f"{prefix}.precision_mask" in sd:
        _set(quant, path + ("precision_mask",), sd[f"{prefix}.precision_mask"])
        _set(quant, path + ("sparsity_target",), np.float32(sparsity))


def _import_layer_norm(sd, prefix: str, params: dict, path: tuple):
    _set(params, path + ("scale",), sd[f"{prefix}.weight"])
    _set(params, path + ("bias",), sd[f"{prefix}.bias"])


def import_text_encoder_state_dict(sd: Dict[str, np.ndarray],
                                   num_layers: int = 4,
                                   prefix: str = "",
                                   sparsity_target: float = 0.3):
    """Reference ATQTextEncoder state_dict -> (params, quant) for
    models.text_encoder.ATQTextEncoder.

    Reference module names (text_encoder.py:252-314): embedding, embed_norm,
    layers.{i}.self_attn.{pre_layer_norm,q/k/v/out_proj}, layers.{i}.
    {linear1,linear2,norm1,norm2,gate}, norm, attention_pool.{0,2}, scaling.
    The fixed positional encoding is recomputed, not imported.
    """
    p = prefix
    params: dict = {}
    quant: dict = {}
    constants: dict = {}
    initial = min(0.1, sparsity_target)

    # The reference's PE parameter was clobbered by its own xavier re-init
    # (see models/text_encoder.py docstring) — import whatever the
    # checkpoint holds rather than recomputing the sinusoid.
    if f"{p}positional_encoding" in sd:
        _set(constants, ("positional_encoding",),
             sd[f"{p}positional_encoding"])

    _set(params, ("embedding", "embedding"), sd[f"{p}embedding.weight"])
    _import_layer_norm(sd, f"{p}embed_norm", params, ("embed_norm",))

    for i in range(num_layers):
        lp = f"{p}layers.{i}"
        fpath = (f"layers_{i}",)
        _import_layer_norm(sd, f"{lp}.self_attn.pre_layer_norm", params,
                           fpath + ("self_attn", "pre_layer_norm"))
        for proj in ("q_proj", "k_proj", "v_proj", "out_proj"):
            _import_quantized_linear(
                sd, f"{lp}.self_attn.{proj}", params, quant,
                fpath + ("self_attn", proj), sparsity=initial,
            )
        for lin in ("linear1", "linear2"):
            _import_quantized_linear(sd, f"{lp}.{lin}", params, quant,
                                     fpath + (lin,), sparsity=initial)
        for norm in ("norm1", "norm2"):
            _import_layer_norm(sd, f"{lp}.{norm}", params, fpath + (norm,))
        _set(params, fpath + ("gate",), sd[f"{lp}.gate"])

    _import_layer_norm(sd, f"{p}norm", params, ("norm",))
    _import_quantized_linear(sd, f"{p}attention_pool.0", params, quant,
                             ("attention_pool_0",), sparsity=initial)
    _import_quantized_linear(sd, f"{p}attention_pool.2", params, quant,
                             ("attention_pool_2",), sparsity=initial)
    _set(params, ("scaling",), sd[f"{p}scaling"])
    return params, quant, constants


def import_fusion_state_dict(sd: Dict[str, np.ndarray], prefix: str = "",
                             modalities=("image", "text"),
                             fusion_method: str = "cross_attention"):
    """Reference MultimodalFusion state_dict -> (params, quant) for
    models.fusion.MultimodalFusion (reference fusion.py:214-423)."""
    p = prefix
    params: dict = {}
    quant: dict = {}
    initial = 0.05  # fusion initial sparsity (fusion.py:227-229)

    for name in modalities:
        base = f"{p}modality_projections.{name}"
        fpath = (f"modality_projections_{name}",)
        _import_quantized_linear(sd, f"{base}.projection", params, quant,
                                 fpath + ("projection",),
                                 sparsity=min(0.1, {"image": 0.3,
                                                    "text": 0.2}.get(name,
                                                                     0.25)))
        _import_layer_norm(sd, f"{base}.norm", params, fpath + ("norm",))
        _set(params, (f"modality_scales_{name}",),
             sd[f"{p}modality_scales.{name}"])

    if fusion_method == "cross_attention":
        for attn in ("text2image", "image2text"):
            base = f"{p}{attn}"
            fpath = (attn,)
            for proj in ("q_proj", "k_proj", "v_proj", "out_proj"):
                _import_quantized_linear(sd, f"{base}.{proj}", params, quant,
                                         fpath + (proj,), sparsity=initial)
            for ln in ("layer_norm_q", "layer_norm_k", "layer_norm_v",
                       "layer_norm_out"):
                _import_layer_norm(sd, f"{base}.{ln}", params, fpath + (ln,))
            _set(params, fpath + ("gate",), sd[f"{base}.gate"])
            _set(params, fpath + ("attention_scale",),
                 sd[f"{base}.attention_scale"])
        for name in ("text", "image"):
            if f"{p}cross_modal_align.{name}.weight" in sd:
                _import_quantized_linear(
                    sd, f"{p}cross_modal_align.{name}", params, quant,
                    (f"cross_modal_align_{name}",), sparsity=initial,
                )
        _import_quantized_linear(sd, f"{p}final_fusion", params, quant,
                                 ("final_fusion",), sparsity=initial)
    elif fusion_method == "concat":
        _import_quantized_linear(sd, f"{p}fusion_layer", params, quant,
                                 ("fusion_layer",), sparsity=initial)
    else:
        _import_quantized_linear(sd, f"{p}fusion_gate", params, quant,
                                 ("fusion_gate",), sparsity=initial)

    _import_layer_norm(sd, f"{p}norm", params, ("norm",))
    return params, quant


# torchvision wraps the backbone as nn.Sequential(children[:-1]): indices
# 0=conv1, 1=bn1, 4..7=layer1..4 (multimodal_classifier.py:31-38).
_RESNET_SEQ = {"0": "conv1", "1": "bn1", "4": "layer1", "5": "layer2",
               "6": "layer3", "7": "layer4"}


def _import_resnet_sequential(sd, prefix: str, arch: str = "resnet18"):
    """Reference image_encoder.base_model.* (Sequential indices) -> the
    flat torchvision-style names models/resnet.py's converter expects."""
    renamed = {}
    for key, value in sd.items():
        if not key.startswith(prefix):
            continue
        rest = key[len(prefix):]
        idx, _, tail = rest.partition(".")
        if idx not in _RESNET_SEQ:
            continue
        stem = _RESNET_SEQ[idx]
        renamed[f"{stem}.{tail}"] = value
    return load_torch_state_dict(renamed, arch=arch)


def import_retrieval_state_dict(sd: Dict[str, np.ndarray],
                                vision_sparsity: float = 0.3,
                                text_sparsity: float = 0.2,
                                num_text_layers: int = 4,
                                arch: str = "resnet18"):
    """Reference ATQMultimodalRetrieval state_dict -> (params, quant,
    constants, batch_stats) for models.retrieval.ATQMultimodalRetrieval."""
    params: dict = {}
    quant: dict = {}
    stats: dict = {}
    iv = min(0.1, vision_sparsity)
    it = min(0.1, text_sparsity)

    # Image encoder.
    r_params, r_stats = _import_resnet_sequential(
        sd, "image_encoder.base_model.", arch=arch
    )
    params["image_encoder"] = {"base_model": r_params}
    stats["image_encoder"] = {"base_model": r_stats}
    ie = params["image_encoder"]
    _import_layer_norm(sd, "image_encoder.feature_norm", ie,
                       ("feature_norm",))
    ie_quant: dict = {}
    _import_quantized_linear(sd, "image_encoder.projector", ie, ie_quant,
                             ("projector",), sparsity=iv)
    quant["image_encoder"] = ie_quant
    _import_layer_norm(sd, "image_encoder.proj_norm", ie, ("proj_norm",))
    _set(ie, ("scaling",), sd["image_encoder.scaling"])

    # Text encoder.
    t_params, t_quant, t_constants = import_text_encoder_state_dict(
        sd, num_layers=num_text_layers, prefix="text_encoder.",
        sparsity_target=text_sparsity,
    )
    params["text_encoder"] = t_params
    quant["text_encoder"] = t_quant
    constants = {"text_encoder": t_constants}

    # Fusion.
    f_params, f_quant = import_fusion_state_dict(sd, prefix="fusion.")
    params["fusion"] = f_params
    quant["fusion"] = f_quant

    # Joint projectors + norms + temperature.
    _import_quantized_linear(sd, "text_projector", params, quant,
                             ("text_projector",), sparsity=it)
    _import_quantized_linear(sd, "image_projector", params, quant,
                             ("image_projector",), sparsity=iv)
    _import_layer_norm(sd, "img_norm", params, ("img_norm",))
    _import_layer_norm(sd, "text_norm", params, ("text_norm",))
    _set(params, ("temperature",), np.asarray(sd["temperature"]).reshape(()))
    return params, quant, constants, stats


def _export_quantized_linear(sd: dict, prefix: str, node: dict,
                             qnode) -> None:
    sd[f"{prefix}.weight"] = np.asarray(node["weight"])
    sd[f"{prefix}.alpha"] = np.asarray(node["alpha"])
    if "bias" in node:
        sd[f"{prefix}.bias"] = np.asarray(node["bias"])
    if isinstance(qnode, dict) and "precision_mask" in qnode:
        # reference stores the mask as an f32 buffer (precision_boost.py:33)
        sd[f"{prefix}.precision_mask"] = np.asarray(
            qnode["precision_mask"], np.float32)


def _export_layer_norm(sd: dict, prefix: str, node: dict) -> None:
    sd[f"{prefix}.weight"] = np.asarray(node["scale"])
    sd[f"{prefix}.bias"] = np.asarray(node["bias"])


def export_resnet_params(params: dict, stats: dict,
                         arch: str = "resnet18") -> Dict[str, np.ndarray]:
    """Inverse of models/resnet.py:load_torch_state_dict — flax trees back
    to flat torchvision naming (NCHW conv layout)."""
    sd: Dict[str, np.ndarray] = {}

    def conv(torch_name, node):
        sd[f"{torch_name}.weight"] = np.transpose(
            np.asarray(node["kernel"]), (3, 2, 0, 1))

    def bn(torch_name, pnode, snode):
        sd[f"{torch_name}.weight"] = np.asarray(pnode["scale"])
        sd[f"{torch_name}.bias"] = np.asarray(pnode["bias"])
        sd[f"{torch_name}.running_mean"] = np.asarray(snode["mean"])
        sd[f"{torch_name}.running_var"] = np.asarray(snode["var"])

    conv("conv1", params["conv1"])
    bn("bn1", params["bn1"], stats["bn1"])
    stage_sizes = (2, 2, 2, 2) if arch == "resnet18" else (3, 4, 6, 3)
    n_convs = 2 if arch == "resnet18" else 3
    for stage, num_blocks in enumerate(stage_sizes):
        for b in range(num_blocks):
            fkey = f"layer{stage + 1}_{b}"
            tpfx = f"layer{stage + 1}.{b}"
            pnode, snode = params[fkey], stats[fkey]
            for c in range(1, n_convs + 1):
                conv(f"{tpfx}.conv{c}", pnode[f"conv{c}"])
                bn(f"{tpfx}.bn{c}", pnode[f"bn{c}"], snode[f"bn{c}"])
            if "downsample_conv" in pnode:
                conv(f"{tpfx}.downsample.0", pnode["downsample_conv"])
                bn(f"{tpfx}.downsample.1", pnode["downsample_bn"],
                   snode["downsample_bn"])
    return sd


def _unrolled_text_layout(params: dict, quant: dict, num_layers: int):
    """A text-encoder subtree in the unrolled ``layers_{i}`` layout
    (atq_tpu/nn/transformer.py ``normalize_text_encoder_layout``): a
    scanned ``layers/scan/layer`` subtree is unstacked, its layer count
    read off the stacked leaves and checked against ``num_layers``."""
    if not is_scanned_text_layout(params):
        return params, quant
    stacked = list(_flatten(params["layers"]["scan"]).values())
    derived = int(np.shape(stacked[0])[0])
    if num_layers is not None and num_layers != derived:
        raise ValueError(f"scanned checkpoint has {derived} layers, caller "
                         f"expected {num_layers}")
    params = _unroll(params)
    if is_scanned_text_layout(quant):
        quant = _unroll(quant)
    return params, quant


def export_text_encoder_params(params: dict, quant: dict, constants: dict,
                               prefix: str = "",
                               num_layers: int = 4) -> Dict[str, np.ndarray]:
    """Inverse of :func:`import_text_encoder_state_dict`.

    Accepts either text-stack layout: scanned (--scan_layers) subtrees
    are unstacked to the reference's per-layer naming first."""
    params, quant = _unrolled_text_layout(dict(params), dict(quant or {}),
                                          num_layers)
    p = prefix
    sd: Dict[str, np.ndarray] = {}
    if constants and "positional_encoding" in constants:
        sd[f"{p}positional_encoding"] = np.asarray(
            constants["positional_encoding"])
    sd[f"{p}embedding.weight"] = np.asarray(params["embedding"]["embedding"])
    _export_layer_norm(sd, f"{p}embed_norm", params["embed_norm"])
    for i in range(num_layers):
        lp = f"{p}layers.{i}"
        node = params[f"layers_{i}"]
        qnode = (quant or {}).get(f"layers_{i}", {})
        _export_layer_norm(sd, f"{lp}.self_attn.pre_layer_norm",
                           node["self_attn"]["pre_layer_norm"])
        for proj in ("q_proj", "k_proj", "v_proj", "out_proj"):
            _export_quantized_linear(
                sd, f"{lp}.self_attn.{proj}", node["self_attn"][proj],
                qnode.get("self_attn", {}).get(proj))
        for lin in ("linear1", "linear2"):
            _export_quantized_linear(sd, f"{lp}.{lin}", node[lin],
                                     qnode.get(lin))
        for norm in ("norm1", "norm2"):
            _export_layer_norm(sd, f"{lp}.{norm}", node[norm])
        sd[f"{lp}.gate"] = np.asarray(node["gate"])
    _export_layer_norm(sd, f"{p}norm", params["norm"])
    _export_quantized_linear(sd, f"{p}attention_pool.0",
                             params["attention_pool_0"],
                             (quant or {}).get("attention_pool_0"))
    _export_quantized_linear(sd, f"{p}attention_pool.2",
                             params["attention_pool_2"],
                             (quant or {}).get("attention_pool_2"))
    sd[f"{p}scaling"] = np.asarray(params["scaling"])
    return sd


def export_fusion_params(params: dict, quant: dict, prefix: str = "",
                         modalities=("image", "text"),
                         fusion_method: str = "cross_attention"
                         ) -> Dict[str, np.ndarray]:
    """Inverse of :func:`import_fusion_state_dict`."""
    p = prefix
    q = quant or {}
    sd: Dict[str, np.ndarray] = {}
    for name in modalities:
        node = params[f"modality_projections_{name}"]
        qnode = q.get(f"modality_projections_{name}", {})
        base = f"{p}modality_projections.{name}"
        _export_quantized_linear(sd, f"{base}.projection",
                                 node["projection"],
                                 qnode.get("projection"))
        _export_layer_norm(sd, f"{base}.norm", node["norm"])
        sd[f"{p}modality_scales.{name}"] = np.asarray(
            params[f"modality_scales_{name}"])
    if fusion_method == "cross_attention":
        for attn in ("text2image", "image2text"):
            node = params[attn]
            qnode = q.get(attn, {})
            base = f"{p}{attn}"
            for proj in ("q_proj", "k_proj", "v_proj", "out_proj"):
                _export_quantized_linear(sd, f"{base}.{proj}", node[proj],
                                         qnode.get(proj))
            for ln in ("layer_norm_q", "layer_norm_k", "layer_norm_v",
                       "layer_norm_out"):
                _export_layer_norm(sd, f"{base}.{ln}", node[ln])
            sd[f"{base}.gate"] = np.asarray(node["gate"])
            sd[f"{base}.attention_scale"] = np.asarray(
                node["attention_scale"])
        for name in ("text", "image"):
            key = f"cross_modal_align_{name}"
            if key in params:
                _export_quantized_linear(sd, f"{p}cross_modal_align.{name}",
                                         params[key], q.get(key))
        _export_quantized_linear(sd, f"{p}final_fusion",
                                 params["final_fusion"],
                                 q.get("final_fusion"))
    elif fusion_method == "concat":
        _export_quantized_linear(sd, f"{p}fusion_layer",
                                 params["fusion_layer"],
                                 q.get("fusion_layer"))
    else:
        _export_quantized_linear(sd, f"{p}fusion_gate",
                                 params["fusion_gate"], q.get("fusion_gate"))
    _export_layer_norm(sd, f"{p}norm", params["norm"])
    return sd


# Inverse of _RESNET_SEQ for export.
_RESNET_SEQ_INV = {v: k for k, v in _RESNET_SEQ.items()}


def export_retrieval_params(params: dict, quant: dict, constants: dict,
                            batch_stats: dict, num_text_layers: int = 4,
                            arch: str = "resnet18"
                            ) -> Dict[str, np.ndarray]:
    """Inverse of :func:`import_retrieval_state_dict`: this framework's
    trees back to the reference's ``ATQMultimodalRetrieval`` state_dict
    naming (best_model.pth / final_model.pth format,
    the reference train_multimodal.py), so a retrieval model
    trained here round-trips to torch. Bitwise on params and masks."""
    sd: Dict[str, np.ndarray] = {}
    q = quant or {}

    # Image encoder: flat torchvision names -> Sequential indices.
    flat = export_resnet_params(params["image_encoder"]["base_model"],
                                batch_stats["image_encoder"]["base_model"],
                                arch=arch)
    for key, value in flat.items():
        stem, _, tail = key.partition(".")
        sd[f"image_encoder.base_model.{_RESNET_SEQ_INV[stem]}.{tail}"] = value
    ie = params["image_encoder"]
    ie_q = q.get("image_encoder", {})
    _export_layer_norm(sd, "image_encoder.feature_norm", ie["feature_norm"])
    _export_quantized_linear(sd, "image_encoder.projector", ie["projector"],
                             ie_q.get("projector"))
    _export_layer_norm(sd, "image_encoder.proj_norm", ie["proj_norm"])
    sd["image_encoder.scaling"] = np.asarray(ie["scaling"])

    sd.update(export_text_encoder_params(
        params["text_encoder"], q.get("text_encoder", {}),
        (constants or {}).get("text_encoder", {}),
        prefix="text_encoder.", num_layers=num_text_layers))
    sd.update(export_fusion_params(params["fusion"], q.get("fusion", {}),
                                   prefix="fusion."))

    _export_quantized_linear(sd, "text_projector", params["text_projector"],
                             q.get("text_projector"))
    _export_quantized_linear(sd, "image_projector",
                             params["image_projector"],
                             q.get("image_projector"))
    _export_layer_norm(sd, "img_norm", params["img_norm"])
    _export_layer_norm(sd, "text_norm", params["text_norm"])
    sd["temperature"] = np.asarray(params["temperature"]).reshape(())
    return sd


def export_classifier_params(params: dict, quant: dict,
                             batch_stats: dict) -> Dict[str, np.ndarray]:
    """Inverse of :func:`import_classifier_state_dict` (torch naming)."""
    def g(tree, *path):
        node = tree
        for k in path:
            node = node[k]
        return np.asarray(node)

    sd: Dict[str, np.ndarray] = {}
    for tname, fname in (("features.0", "conv1"), ("features.4", "conv2")):
        sd[f"{tname}.weight"] = g(params, "features", fname,
                                  "kernel").transpose(3, 2, 0, 1)
        sd[f"{tname}.bias"] = g(params, "features", fname, "bias")
    for tname, fname in (("features.1", "bn1"), ("features.5", "bn2")):
        sd[f"{tname}.weight"] = g(params, "features", fname, "scale")
        sd[f"{tname}.bias"] = g(params, "features", fname, "bias")
        sd[f"{tname}.running_mean"] = g(batch_stats, "features", fname,
                                        "mean")
        sd[f"{tname}.running_var"] = g(batch_stats, "features", fname, "var")

    def hwc_to_chw_columns(w, c, h, wd):
        out_f = w.shape[0]
        return (w.reshape(out_f, h, wd, c).transpose(0, 3, 1, 2)
                .reshape(out_f, c * h * wd))

    for tidx, name in ((0, "classifier_0"), (3, "classifier_3")):
        w = g(params, name, "weight")
        if tidx == 0:
            w = hwc_to_chw_columns(w, 64, 7, 7)
        sd[f"classifier.{tidx}.weight"] = w
        sd[f"classifier.{tidx}.alpha"] = g(params, name, "alpha")
        sd[f"classifier.{tidx}.bias"] = g(params, name, "bias")
        if quant and name in quant and "precision_mask" in quant[name]:
            m = np.asarray(quant[name]["precision_mask"], np.float32)
            if tidx == 0:
                m = hwc_to_chw_columns(m, 64, 7, 7)
            sd[f"classifier.{tidx}.precision_mask"] = m
    return sd
