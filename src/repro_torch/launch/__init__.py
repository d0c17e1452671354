"""Command-line drivers (`python -m repro_torch.launch.serve`)."""
