"""Command-line entry points (python -m mvc_tpu_torch.cli.<name>)."""
