"""Runnable examples of the port (``python -m hpdg_tpu_torch.examples.<name>``)."""
