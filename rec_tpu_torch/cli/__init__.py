"""Command-line entry points of the port (``python -m
rec_tpu_torch.cli.<name>``)."""
