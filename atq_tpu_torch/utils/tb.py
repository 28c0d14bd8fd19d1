"""Optional TensorBoard metric writer (port of atq_tpu/utils/tb.py).

The trainers' JSON artifacts (``metrics.jsonl``, ``training_history.json``)
stay the record; ``--tensorboard-dir`` / ``--tensorboard_dir`` adds the same
scalars as TensorBoard events. The backends are ``tensorboardX``, then
``torch.utils.tensorboard`` (which needs the ``tensorboard`` package); each
is imported when a writer is made, never when this module is. When neither
works, the writer warns once and every call is a no-op, the JAX package's
documented behaviour for a missing optional logger, so the trainers call it
unconditionally.
"""

from __future__ import annotations

from typing import Dict, Optional


class MetricsWriter:
    """Per-epoch scalar writer; ``None``/missing logdir or a missing
    tensorboard backend make every call a no-op."""

    def __init__(self, logdir: Optional[str]):
        self._writer = None
        if not logdir:
            return
        # Broad except, as in the JAX module: a present-but-broken backend
        # (a protobuf mismatch raising TypeError at import, a constructor
        # failure) degrades to the next backend or the no-op rather than
        # abort training at start-up.
        for importer in (
            lambda: __import__("tensorboardX").SummaryWriter,
            lambda: __import__(
                "torch.utils.tensorboard", fromlist=["SummaryWriter"]
            ).SummaryWriter,
        ):
            try:
                self._writer = importer()(logdir)
                return
            except Exception:
                continue
        import warnings

        warnings.warn(
            "tensorboard logdir given but no working tensorboardX / "
            "torch SummaryWriter; metrics go to the JSON artifacts only")

    @property
    def active(self) -> bool:
        return self._writer is not None

    def scalars(self, step: int, metrics: Dict[str, float],
                prefix: str = "") -> None:
        if self._writer is None:
            return
        for key, value in metrics.items():
            try:
                value = float(value)
            except (TypeError, ValueError):
                continue
            self._writer.add_scalar(f"{prefix}{key}", value, int(step))

    def flush(self) -> None:
        if self._writer is not None:
            self._writer.flush()

    def close(self) -> None:
        if self._writer is not None:
            self._writer.close()
            self._writer = None
