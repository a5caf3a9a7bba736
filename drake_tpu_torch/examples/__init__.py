"""Demos of the port (``python -m drake_tpu_torch.examples.<name>``)."""
