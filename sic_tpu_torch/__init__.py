"""PyTorch/CUDA port of sic_tpu, decode path.

A second package beside the JAX one: same specs, parameter tree and wire
format, NHWC feature maps and batch-major sequences at module boundaries,
and hand-written CUDA kernels (``csrc/``) where the JAX package runs Pallas
TPU kernels.  Imports torch, numpy, scipy and PIL; never JAX.
"""
__version__ = "0.1.0"
