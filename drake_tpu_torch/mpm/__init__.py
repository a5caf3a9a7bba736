"""MLS-MPM on PyTorch (counterpart of drake_tpu.mpm)."""
