"""Metrics, device selection, visualization and JAX-checkpoint interop
(port of atq_tpu/utils). JAX's ``apply_platform_env`` is
``resolve_device`` here."""

from atq_tpu_torch.utils.metrics import (
    accuracy,
    confusion_matrix,
    count_parameters,
    estimate_flops,
    measure_inference_time,
    measure_model_memory,
)
from atq_tpu_torch.utils.platform import resolve_device
from atq_tpu_torch.utils.visualization import (
    compare_model_efficiency,
    plot_weight_distribution,
    visualize_ternary_weights,
)

__all__ = [
    "count_parameters",
    "measure_model_memory",
    "measure_inference_time",
    "estimate_flops",
    "accuracy",
    "confusion_matrix",
    "resolve_device",
    "plot_weight_distribution",
    "visualize_ternary_weights",
    "compare_model_efficiency",
]
