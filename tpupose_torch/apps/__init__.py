"""Command-line apps of the port (``python -m tpupose_torch.apps.<name>``)."""
