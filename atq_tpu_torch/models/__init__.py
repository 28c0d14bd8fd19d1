"""Models (port of atq_tpu/models)."""
