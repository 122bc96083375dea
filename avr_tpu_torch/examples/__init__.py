"""Runnable examples of the port (``python -m avr_tpu_torch.examples.<name>``)."""
