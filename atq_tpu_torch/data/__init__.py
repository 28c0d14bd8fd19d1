"""Data helpers (port of atq_tpu/data)."""
