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


def _fma_rn(a, b, c) -> torch.Tensor:
    """a * b + c in float32 rounded once, as fmaf, for results in float32's
    normal range. `_fma` rounds the exact product's float64 sum and then
    to float32, which differs from one rounding only where the float64 sum
    falls exactly on a float32 tie while the exact sum does not; there the
    sum moves one float64 ulp toward the exact value (its error recovered
    by TwoSum) before the float32 rounding."""
    p = _f64(a) * _f64(b)                # exact
    c = _f64(c)
    s = p + c
    tie = (s.view(torch.int64) & 0x1FFFFFFF) == 0x10000000
    if bool(tie.any()):
        bb = s - p
        e = (p - (s - bb)) + (c - bb)    # s + e == p + c exactly
        step = torch.where((e > 0) == (s > 0), 1, -1)
        nudged = (s.view(torch.int64) + step).view(torch.float64)
        s = torch.where(tie & ((e > 0) | (e < 0)), nudged, s)
    return s.to(torch.float32)
