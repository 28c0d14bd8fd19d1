"""Training for the port (classification: ``python -m atq_tpu_torch.train``;
retrieval: ``python -m atq_tpu_torch.train.retrieval``).

The exports are the JAX package's, imported on first use: an eager import
of ``train.retrieval`` here would load that module before ``python -m``
runs it as ``__main__``, so it would run twice.
"""

import importlib

_EXPORTS = {"train_classifier": "classifier",
            "ClassifierConfig": "classifier",
            "train_retrieval": "retrieval",
            "RetrievalConfig": "retrieval"}

__all__ = list(_EXPORTS)


def __getattr__(name):
    if name not in _EXPORTS:
        raise AttributeError(f"module {__name__!r} has no attribute {name!r}")
    module = importlib.import_module(f"{__name__}.{_EXPORTS[name]}")
    return getattr(module, name)


def __dir__():
    return sorted(set(globals()) | set(__all__))
