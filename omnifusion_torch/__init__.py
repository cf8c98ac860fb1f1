"""PyTorch/CUDA port of OmniFusion for one NVIDIA H100.

The JAX package ``omnifusion_tpu`` beside it is the reference: every part of
this package is held against its output on the same inputs and weights
(tests/test_torch_port_*.py). This package imports neither JAX nor anything
of ``omnifusion_tpu``. Its kernels are hand-written CUDA under ``csrc/``.
"""
