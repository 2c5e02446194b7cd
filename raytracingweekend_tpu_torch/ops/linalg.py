"""3-vector math over tensors of shape (..., 3).

The port of raytracingweekend_tpu/ops/linalg.py (reference: vec3.h, onb.h,
material.h:10-49): a "vec3" is the trailing axis of a tensor, so every
function is elementwise work over a whole wavefront.
"""
from __future__ import annotations

import torch

__all__ = [
    "dot", "cross", "length", "length_squared", "normalize", "reflect",
    "refract", "schlick", "onb_from_w", "onb_local", "safe_sqrt",
]


def safe_sqrt(x: torch.Tensor) -> torch.Tensor:
    """sqrt clamped at 0 (the JAX package's NaN-free form: where x <= 0
    the result is 0)."""
    pos = x > 0
    return torch.where(pos, torch.sqrt(torch.where(pos, x, torch.ones_like(x))),
                       torch.zeros_like(x))


def dot(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Batched dot product over the trailing xyz axis (vec3.h:52)."""
    return (a * b).sum(dim=-1)


def cross(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Batched cross product (vec3.h:54-59)."""
    return torch.linalg.cross(a, b, dim=-1)


def length_squared(v: torch.Tensor) -> torch.Tensor:
    return dot(v, v)


def length(v: torch.Tensor) -> torch.Tensor:
    return torch.sqrt(length_squared(v))


def normalize(v: torch.Tensor) -> torch.Tensor:
    """Normalize over the trailing axis (vec3.h:61-67)."""
    return v / length(v)[..., None]


def reflect(v: torch.Tensor, n: torch.Tensor) -> torch.Tensor:
    """Mirror reflection about normal n (material.h:10-13)."""
    return v - 2.0 * dot(v, n)[..., None] * n


def refract(v: torch.Tensor, n: torch.Tensor, ni_over_nt: torch.Tensor):
    """Snell refraction with total-internal-reflection detection
    (material.h:17-39): `v` is normalized here, `n` points against the
    incident ray. Returns (refracted, can_refract); `refracted` means
    something only where `can_refract`."""
    uv = normalize(v)
    dt = dot(uv, n)
    disc = 1.0 - ni_over_nt * ni_over_nt * (1.0 - dt * dt)
    can_refract = disc > 0
    refr = (ni_over_nt[..., None] * (uv - n * dt[..., None])
            - n * safe_sqrt(disc)[..., None])
    return refr, can_refract


def schlick(cosine: torch.Tensor, ref_idx) -> torch.Tensor:
    """Schlick Fresnel approximation (material.h:44-49)."""
    r0 = (1.0 - ref_idx) / (1.0 + ref_idx)
    r0 = r0 * r0
    return r0 + (1.0 - r0) * (1.0 - cosine) ** 5


def onb_from_w(n: torch.Tensor):
    """Orthonormal basis from a (not necessarily unit) normal (onb.h:32-38):
    w = normalize(n); helper axis y where |w.x| > 0.9, else x;
    v = normalize(w x a); u = w x v. Returns (u, v, w), each (..., 3)."""
    w = normalize(n)
    ex = torch.tensor([1.0, 0.0, 0.0], dtype=w.dtype, device=w.device)
    ey = torch.tensor([0.0, 1.0, 0.0], dtype=w.dtype, device=w.device)
    a = torch.where(w[..., 0:1].abs() > 0.9, ey, ex)
    v = normalize(cross(w, a))
    u = cross(w, v)
    return u, v, w


def onb_local(u, v, w, a: torch.Tensor) -> torch.Tensor:
    """Map tangent-space direction `a` to world space (onb.h:16-24)."""
    return a[..., 0:1] * u + a[..., 1:2] * v + a[..., 2:3] * w
