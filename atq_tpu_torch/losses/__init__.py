"""Contrastive losses (port of atq_tpu/losses)."""
