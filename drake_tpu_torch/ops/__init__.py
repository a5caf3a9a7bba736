"""Hand-written CUDA kernels and their plain PyTorch versions
(counterpart of drake_tpu.ops)."""
