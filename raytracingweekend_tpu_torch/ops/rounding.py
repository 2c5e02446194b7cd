"""Fused multiply-adds of the plain PyTorch versions.

The JAX kernel runs its arithmetic under XLA, whose CPU backend contracts
every single-use multiply feeding an add into an FMA (LLVM's rule: in
x*y + z*w the first product is fused), and the CUDA kernel is built with
-fmad=false and writes the same fmaf calls. The plain versions write each
of those FMAs out, with one rounding: the product of two float32 values is
exact in float64.
"""
import numpy as np
import torch


def _f64(x):
    """float64 view of a float32 tensor or (float32-rounded) constant."""
    return x.double() if isinstance(x, torch.Tensor) else float(np.float32(x))


def _fma(a, b, c) -> torch.Tensor:
    """a * b + c in float32 with one rounding."""
    return (_f64(a) * _f64(b) + _f64(c)).to(torch.float32)
