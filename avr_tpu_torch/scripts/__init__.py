"""Command-line scripts of the port (``python -m avr_tpu_torch.scripts.<name>``)."""
