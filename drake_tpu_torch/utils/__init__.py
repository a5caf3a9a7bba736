"""Tensor dataclass utilities (counterpart of drake_tpu.utils)."""
