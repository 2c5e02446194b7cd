"""raytracingweekend_tpu_torch — the path tracer on PyTorch and CUDA.

The port of `raytracingweekend_tpu` (JAX/Pallas on a TPU) to PyTorch with
hand-written CUDA kernels for NVIDIA Hopper (sm_90a). Each module sits at
the same relative path as its JAX counterpart. Host scene data are numpy
dataclasses; device work takes tensors with an explicit `device`; every
kernel has a plain PyTorch version beside it that runs on CPU tensors.

This package imports torch and numpy, never jax.
"""

__version__ = "0.1.0"
