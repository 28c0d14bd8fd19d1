"""Visualization utilities (port of atq_tpu/utils/visualization.py).

Each function takes an ``nn.Module``, its flat ``state_dict``-style
``{name: tensor}`` dict, or a JAX-layout param tree (nested dicts). The
first two are read through utils/jax_interop.py's ``to_jax_variables``,
so the layers are found and named as in the JAX module: ``weight`` and
``kernel`` leaves (conv kernels HWIO), no BatchNorm (a ``bn`` in the
path), and no LayerNorm scale or embedding table (JAX names them ``scale``
and ``embedding``).

The ternary pie chart recomputes the threshold with the CLASSIC
``0.05 * mean|w|`` method, not the sparsity-targeted quantizer, so it can
disagree with training-time sparsity: a quirk of the reference that the
JAX module documents and keeps, kept here too.

matplotlib is imported inside the functions that draw (the card's machine
has none; nothing on the training path calls this module).
"""

from __future__ import annotations

from typing import Dict

import numpy as np
import torch

from atq_tpu_torch.utils.jax_interop import to_jax_variables
from atq_tpu_torch.utils.metrics import (
    count_parameters,
    measure_inference_time,
    measure_model_memory,
)


def _param_tree(params) -> Dict:
    if isinstance(params, torch.nn.Module):
        params = params.state_dict()
    if params and all(isinstance(v, torch.Tensor) for v in params.values()):
        return to_jax_variables(params).get("params", {})
    return params


def _named_weights(params):
    """``(dotted name, array)`` of each weight, in the JAX tree order
    (keys sorted), which decides the first layer a name matches."""
    def walk(node, keys):
        if isinstance(node, dict):
            for k, v in sorted(node.items()):
                yield from walk(v, keys + [str(k)])
        elif keys and keys[-1] in ("weight", "kernel") and not any(
                "bn" in k for k in keys):
            yield ".".join(keys), np.asarray(node)

    yield from walk(_param_tree(params), [])


def _pyplot():
    import matplotlib

    matplotlib.use("Agg")
    import matplotlib.pyplot as plt

    return plt


def plot_weight_distribution(params, layer_name: str | None = None,
                             out_path: str | None = None):
    """Histogram of weight values per layer."""
    plt = _pyplot()
    weights = {
        name: w.ravel() for name, w in _named_weights(params)
        if layer_name is None or layer_name in name
    }
    if not weights:
        print("No weights found with the specified layer name.")
        return
    plt.figure(figsize=(12, 8))
    for i, (name, w) in enumerate(weights.items()):
        plt.subplot(len(weights), 1, i + 1)
        plt.hist(w, bins=100)
        plt.title(f"Weight Distribution: {name}")
        plt.xlabel("Weight Value")
        plt.ylabel("Count")
    plt.tight_layout()
    if out_path:
        plt.savefig(out_path)
    plt.close()


def visualize_ternary_weights(params, layer_name: str,
                              out_path: str | None = None):
    """Pie chart of the {-1, 0, +1} distribution of the first layer whose
    name contains ``layer_name``, by the classic threshold (the module
    docstring's quirk), and the counts printed."""
    plt = _pyplot()
    weight = None
    for name, w in _named_weights(params):
        if layer_name in name:
            weight = w
            break
    if weight is None:
        print(f"Layer {layer_name} not found.")
        return

    threshold = 0.05 * np.mean(np.abs(weight))
    ternary = np.zeros_like(weight)
    ternary[weight > threshold] = 1
    ternary[weight < -threshold] = -1

    neg = int(np.sum(ternary == -1))
    zero = int(np.sum(ternary == 0))
    pos = int(np.sum(ternary == 1))
    total = ternary.size

    plt.figure(figsize=(10, 6))
    plt.pie([neg, zero, pos], labels=["-1", "0", "+1"], autopct="%1.1f%%",
            colors=["red", "gray", "blue"])
    plt.title(f"Ternary Weight Distribution for {layer_name}")
    if out_path:
        plt.savefig(out_path)
    plt.close()

    print(f"Layer: {layer_name}")
    print(f"Total weights: {total}")
    print(f"-1: {neg} ({neg / total * 100:.2f}%)")
    print(f" 0: {zero} ({zero / total * 100:.2f}%)")
    print(f"+1: {pos} ({pos / total * 100:.2f}%)")


def compare_model_efficiency(models: Dict[str, dict], input_size=None,
                             out_path: str | None = None):
    """Parameters, memory and inference time of each model, as a table and
    a bar chart. Each entry: ``{"model": nn.Module, "inputs": tensor}``,
    and optionally ``"apply_fn"`` (called as ``apply_fn(inputs)``; the
    model by default). ``input_size`` is kept for the JAX signature."""
    plt = _pyplot()
    metric_fns = {
        "Parameters (M)": lambda m: count_parameters(m["model"]) / 1e6,
        "Memory (MB)": lambda m: measure_model_memory(m["model"]),
        "Inference Time (ms)": lambda m: measure_inference_time(
            m.get("apply_fn", m["model"]), m["inputs"]),
    }
    results = {
        name: {mn: fn(model) for mn, fn in metric_fns.items()}
        for name, model in models.items()
    }

    plt.figure(figsize=(15, 5))
    for i, metric_name in enumerate(metric_fns):
        plt.subplot(1, 3, i + 1)
        values = [results[n][metric_name] for n in models]
        plt.bar(list(models.keys()), values)
        plt.title(metric_name)
        plt.xticks(rotation=45)
    plt.tight_layout()
    if out_path:
        plt.savefig(out_path)
    plt.close()

    header = ("Model".ljust(20) + " | "
              + " | ".join(m.ljust(15) for m in metric_fns))
    print("-" * len(header))
    print(header)
    print("-" * len(header))
    for name in models:
        row = name.ljust(20) + " | " + " | ".join(
            f"{results[name][m]:.4f}".ljust(15) for m in metric_fns
        )
        print(row)
    print("-" * len(header))
    return results
