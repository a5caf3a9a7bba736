"""drake_tpu_torch: the PyTorch + CUDA (NVIDIA Hopper) port of drake_tpu.

The package mirrors the layout of ``drake_tpu`` so that each module sits where
its JAX counterpart does.  It imports ``torch`` and never ``jax`` or
``drake_tpu``; the JAX package stays the reference the port is tested against.
Hand-written CUDA kernels live under ``ops/csrc`` and are built with ``nvcc``
at first use (see ``ops/_build.py``).
"""

__version__ = "0.1.0"
