"""Perlin noise with the reference's deterministic lookup tables.

The port of raytracingweekend_tpu/ops/noise.py's tables and of the
megakernel's noise helpers (`_perlin_noise`, `_turb`, `_marble` in
raytracingweekend_tpu/ops/megakernel.py). The 256-entry tables are made
eagerly with the reference's LCG (std::minstd_rand, default seed 1,
noise.h:166-213). The torch functions compute what the JAX kernel computes,
in its op order and with XLA's multiply-add fusion written out, but index
the exact float32 gradients instead of reconstructing them from bf16
halves (the JAX kernel's one-hot MXU lookup is a TPU device).

`perlin_noise`, `turb` and `marble` are the plain PyTorch versions of the
CUDA kernel's `perlin`, `turb` and `marble` (csrc/megakernel.cu). `noise`
and `turbulence` are the wavefront's (raytracingweekend_tpu/ops/noise.py
`noise` and `turb`): points of shape (..., 3), all three interpolation
modes of the reference (noise.h:100-150) and both smoothsteps
(noise.h:9-20).
"""
from __future__ import annotations

import functools

import numpy as np
import torch

from ..utils.detrng import minstd_stream
from .rounding import _fma

__all__ = ["NOISE_TABLES", "noise_tables", "perlin_noise", "turb", "marble",
           "noise", "turbulence"]

_SIZE = 256


def _make_tables():
    """(ranfloat, ranvec, perm_x, perm_y, perm_z) as numpy: float32 (256,),
    float32 (256, 3) unit vectors, int32 (256,) permutations."""
    # ranfloat: 256 uniforms (noise.h:189-198)
    ranfloat = minstd_stream(_SIZE)
    # ranvec: 256 normalised vectors from the [-1, 1]^3 cube
    # (noise.h:200-213); g++ evaluates the vec3 constructor's arguments
    # right to left, so per vector the first draw is z
    u = minstd_stream(3 * _SIZE).reshape(_SIZE, 3)
    ranvec = -1.0 + 2.0 * u[:, ::-1]
    ranvec /= np.linalg.norm(ranvec, axis=-1, keepdims=True)
    # permutations: the identity shuffled by Fisher-Yates (noise.h:166-187).
    # permute() builds a fresh default-seeded engine per call, so the three
    # permutations are equal.
    p = np.arange(_SIZE, dtype=np.int64)
    stream = minstd_stream(_SIZE)
    for si, i in enumerate(range(_SIZE - 1, 0, -1)):
        target = int(stream[si] * (i + 1))
        p[i], p[target] = p[target], p[i]
    perm = p.astype(np.int32)
    return (ranfloat.astype(np.float32), ranvec.astype(np.float32), perm,
            perm.copy(), perm.copy())


NOISE_TABLES = _make_tables()


@functools.lru_cache(maxsize=8)
def noise_tables(device: str):
    """(perm int32 (256,), ranvec float32 (256, 3)) on `device`, made once
    per device: the megakernel's noise inputs."""
    _, ranvec, perm, _, _ = NOISE_TABLES
    return (torch.from_numpy(perm).to(device),
            torch.from_numpy(ranvec).to(device))


def perlin_noise(px, py, pz, perm: torch.Tensor,
                 ranvec: torch.Tensor) -> torch.Tensor:
    """Gradient Perlin noise in [-1, 1] (noise.h:89-151, hermite
    smoothstep) at points (px, py, pz), float32 tensors of one shape."""
    fx, fy, fz = torch.floor(px), torch.floor(py), torch.floor(pz)
    u, v, w = px - fx, py - fy, pz - fz
    # int64 corners: & 255 wraps a negative lattice coordinate as int32 does
    i, j, k = (f.to(torch.int64) for f in (fx, fy, fz))
    perm = perm.to(torch.int64)
    uu = u * u * (3.0 - 2.0 * u)
    vv = v * v * (3.0 - 2.0 * v)
    ww = w * w * (3.0 - 2.0 * w)
    pi = (perm[i & 255], perm[(i + 1) & 255])
    pj = (perm[j & 255], perm[(j + 1) & 255])
    pk = (perm[k & 255], perm[(k + 1) & 255])
    acc = torch.zeros_like(px)
    for di in (0, 1):
        wu = uu if di else 1.0 - uu
        ru = u - float(di)
        for dj in (0, 1):
            wv = vv if dj else 1.0 - vv
            rv = v - float(dj)
            for dk in (0, 1):
                wwk = ww if dk else 1.0 - ww
                rw = w - float(dk)
                g = ranvec[pi[di] ^ pj[dj] ^ pk[dk]]
                dot = _fma(g[..., 2], rw, _fma(g[..., 0], ru, g[..., 1] * rv))
                acc = _fma(wu * wv * wwk, dot, acc)
    return acc


def turb(px, py, pz, perm: torch.Tensor, ranvec: torch.Tensor,
         depth: int = 7) -> torch.Tensor:
    """|fBm| turbulence over `depth` octaves (noise.h:74-86). The octave
    weights and scales are powers of two, so their products are exact."""
    acc = torch.zeros_like(px)
    wgt = sc = 1.0
    for _ in range(depth):
        acc = acc + wgt * perlin_noise(px * sc, py * sc, pz * sc, perm,
                                       ranvec)
        wgt *= 0.5
        sc *= 2.0
    return acc.abs()


def marble(px, py, pz, scale, perm: torch.Tensor, ranvec: torch.Tensor,
           depth: int = 7) -> torch.Tensor:
    """0.5 (1 + sin(scale z + 10 turb(p))) (texture.h:67); the turbulence
    is taken at the unscaled point."""
    t = turb(px, py, pz, perm, ranvec, depth)
    return 0.5 * (1.0 + torch.sin(_fma(scale, pz, 10.0 * t)))


@functools.lru_cache(maxsize=8)
def _wavefront_tables(device: str):
    """(ranfloat (256,), ranvec (256, 3), perm int64 (256,)) on `device`."""
    ranfloat, ranvec, perm, _, _ = NOISE_TABLES
    return (torch.from_numpy(ranfloat).to(device),
            torch.from_numpy(ranvec).to(device),
            torch.from_numpy(perm.astype(np.int64)).to(device))


def _smooth(x: torch.Tensor, smoother: bool) -> torch.Tensor:
    if smoother:
        # Perlin's quintic smootherstep (noise.h:14-17, the inactive variant)
        return x * x * x * (x * (x * 6.0 - 15.0) + 10.0)
    # Hermite cubic (noise.h:9-12, the active #define at noise.h:19)
    return x * x * (3.0 - 2.0 * x)


def noise(p: torch.Tensor, mode: str = "perlin",
          smoother: bool = False) -> torch.Tensor:
    """Perlin noise in [-1, 1] at points p (..., 3) (noise.h:89-151).
    mode: "perlin" (gradient interpolation, the reference's active mode),
    "trilinear" (scalar-table interpolation) or "none" (raw hash)."""
    ranfloat, ranvec, perm = _wavefront_tables(str(p.device))
    if mode == "none":
        i, j, k = ((4.0 * p[..., a]).to(torch.int32).long() & 255
                   for a in range(3))
        return ranfloat[perm[i] ^ perm[j] ^ perm[k]]
    pf = torch.floor(p)
    u, v, w = (p[..., a] - pf[..., a] for a in range(3))
    i, j, k = (pf[..., a].to(torch.int32).long() for a in range(3))
    uu, vv, ww = (_smooth(x, smoother) for x in (u, v, w))
    acc = torch.zeros_like(u)
    for di in (0, 1):
        for dj in (0, 1):
            for dk in (0, 1):
                idx = (perm[(i + di) & 255] ^ perm[(j + dj) & 255]
                       ^ perm[(k + dk) & 255])
                wgt = ((uu if di else 1.0 - uu) * (vv if dj else 1.0 - vv)
                       * (ww if dk else 1.0 - ww))
                if mode == "trilinear":
                    val = ranfloat[idx]
                else:
                    g = ranvec[idx]
                    val = (g[..., 0] * (u - di) + g[..., 1] * (v - dj)
                           + g[..., 2] * (w - dk))
                acc = acc + wgt * val
    return acc


def turbulence(p: torch.Tensor, depth: int = 7, mode: str = "perlin",
               smoother: bool = False) -> torch.Tensor:
    """|fBm| turbulence over `depth` octaves at points p (..., 3)
    (noise.h:74-86)."""
    acc = torch.zeros(p.shape[:-1], dtype=p.dtype, device=p.device)
    wgt = sc = 1.0
    for _ in range(depth):
        acc = acc + wgt * noise(p * sc, mode, smoother)
        wgt *= 0.5
        sc *= 2.0
    return acc.abs()
