"""Command-line entry points of the port (``python -m skyeye_tpu_torch.cli.<name>``)."""
