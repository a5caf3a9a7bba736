"""NLP and QP solvers on PyTorch (counterpart of drake_tpu.solvers)."""
