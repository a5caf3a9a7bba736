"""Host-side I/O on PyTorch (counterpart of drake_tpu.io)."""
