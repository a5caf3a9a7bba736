"""Benchmarks of the port (``python -m drake_tpu_torch.benchmarks.<name>``)."""
