"""Keyed, vectorized Monte Carlo samplers.

The port of raytracingweekend_tpu/ops/sampling.py (reference: utility.h:14-82,
camera.h:61-69). Every sampler is a function of a threefry key
(utils/prng.py: the JAX package's keys, bit for bit) and a batch shape, so
it draws the JAX sampler's uniforms; the rejection loops of the reference
are the JAX package's closed forms.
"""
from __future__ import annotations

import math

import torch

from ..utils import prng
from . import linalg

__all__ = [
    "uniform", "random_int", "random_in_unit_sphere", "random_unit_vector",
    "random_in_hemisphere", "random_cosine_direction", "random_to_sphere",
    "random_in_unit_disk", "get_sphere_uv",
]

_TWO_PI = 2.0 * math.pi


def uniform(key, shape=(), a: float = 0.0, b: float = 1.0,
            device="cuda") -> torch.Tensor:
    """U[a, b) in float32 (utility.h:14-20 random_double)."""
    return prng.uniform(key, shape, a, b, device=device)


def random_int(key, shape, a: int, b: int, device="cuda") -> torch.Tensor:
    """Uniform integer in [a, b] (utility.h:22-25):
    a + min(b - a, int((b - a + 1) U)), int64."""
    u = uniform(key, shape, device=device)
    return a + torch.clamp_max(((b - a + 1) * u).to(torch.int32),
                               b - a).long()


def random_unit_vector(key, shape=(), device="cuda") -> torch.Tensor:
    """Uniform direction on the unit sphere (utility.h:37-43), (..., 3)."""
    ka, kz = prng.split(key)
    a = uniform(ka, shape, 0.0, _TWO_PI, device)
    z = uniform(kz, shape, -1.0, 1.0, device)
    r = torch.sqrt(torch.clamp_min(1.0 - z * z, 0.0))
    return torch.stack([r * torch.cos(a), r * torch.sin(a), z], dim=-1)


def random_in_unit_sphere(key, shape=(), device="cuda") -> torch.Tensor:
    """Uniform point in the unit ball: a uniform direction at radius
    U^(1/3) (closed form of utility.h:27-35)."""
    kd, kr = prng.split(key)
    d = random_unit_vector(kd, shape, device)
    r = uniform(kr, shape, device=device) ** (1.0 / 3.0)
    return d * r[..., None]


def random_in_hemisphere(key, normal: torch.Tensor) -> torch.Tensor:
    """A unit-ball point folded into the normal's hemisphere
    (utility.h:45-52)."""
    p = random_in_unit_sphere(key, normal.shape[:-1], normal.device)
    same = linalg.dot(p, normal) > 0.0
    return torch.where(same[..., None], p, -p)


def random_cosine_direction(key, shape=(), device="cuda") -> torch.Tensor:
    """Cosine-weighted direction about +z (utility.h:54-67)."""
    k1, k2 = prng.split(key)
    r1 = uniform(k1, shape, device=device)
    r2 = uniform(k2, shape, device=device)
    z = torch.sqrt(torch.clamp_min(1.0 - r2, 0.0))
    phi = _TWO_PI * r1
    sq = torch.sqrt(r2)
    return torch.stack([torch.cos(phi) * sq, torch.sin(phi) * sq, z], dim=-1)


def random_to_sphere(key, radius: torch.Tensor,
                     distance_squared: torch.Tensor) -> torch.Tensor:
    """Cone sample toward a sphere of `radius` at squared distance
    `distance_squared` (utility.h:69-82), (..., 3) in the cone's frame."""
    shape = torch.broadcast_shapes(radius.shape, distance_squared.shape)
    dev = radius.device
    k1, k2 = prng.split(key)
    r1 = uniform(k1, shape, device=dev)
    r2 = uniform(k2, shape, device=dev)
    ctm = linalg.safe_sqrt(1.0 - radius * radius / distance_squared)
    z = 1.0 + r2 * (ctm - 1.0)
    phi = _TWO_PI * r1
    s = linalg.safe_sqrt(1.0 - z * z)
    return torch.stack([torch.cos(phi) * s, torch.sin(phi) * s, z], dim=-1)


def random_in_unit_disk(key, shape=(), device="cuda") -> torch.Tensor:
    """Uniform point in the unit disk, z = 0: radius sqrt(U), uniform
    angle (closed form of camera.h:61-69)."""
    kr, ka = prng.split(key)
    r = torch.sqrt(uniform(kr, shape, device=device))
    a = uniform(ka, shape, 0.0, _TWO_PI, device)
    return torch.stack([r * torch.cos(a), r * torch.sin(a),
                        torch.zeros_like(r)], dim=-1)


def get_sphere_uv(p: torch.Tensor):
    """(u, v) of a unit-sphere point (utility.h:6-12, sphere.h:115-122),
    with the true atan2 and asin (the megakernel keeps polynomials)."""
    phi = torch.atan2(p[..., 2], p[..., 0])
    theta = torch.asin(torch.clamp(p[..., 1], -1.0, 1.0))
    u = 1.0 - (phi + math.pi) / _TWO_PI
    v = (theta + math.pi / 2.0) / math.pi
    return u, v
