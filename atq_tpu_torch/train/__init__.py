"""Training for the port (classification: ``python -m atq_tpu_torch.train``)."""
