"""Serving stack (port of atq_tpu/serve); ``python -m atq_tpu_torch.serve``."""
