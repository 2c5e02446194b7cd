"""Thin-lens camera basis (reference: camera.h:7-34).

Host-side only: the megakernel generates its rays on the device from the
basis packed by ops/megakernel.build_tables. Float32 numpy arithmetic in the
same op order as raytracingweekend_tpu/ops/camera.make_camera, so the basis
is bitwise equal to the JAX one.
"""
from __future__ import annotations

import math

import numpy as np

from ..models.scene_types import Camera


def _normalize(v: np.ndarray) -> np.ndarray:
    return v / np.sqrt(np.sum(v * v, axis=-1))


def make_camera(lookfrom, lookat, vup, vfov, aspect, aperture, focus_dist,
                t0=0.0, t1=1.0) -> Camera:
    """Mirror of camera.h:13-34. vfov is the full vertical fov in degrees;
    aperture is the lens *diameter* (camera.h:18-19)."""
    f32 = np.float32
    lookfrom = np.asarray(lookfrom, f32)
    lookat = np.asarray(lookat, f32)
    vup = np.asarray(vup, f32)
    theta = vfov * math.pi / 180.0
    half_height = math.tan(theta / 2.0)
    half_width = aspect * half_height
    w = _normalize(lookfrom - lookat)
    u = _normalize(np.cross(vup, w))
    v = np.cross(w, u)
    lower_left = (lookfrom - half_width * focus_dist * u
                  - half_height * focus_dist * v - focus_dist * w)
    return Camera(
        origin=lookfrom,
        lower_left_corner=lower_left,
        horizontal=2.0 * half_width * focus_dist * u,
        vertical=2.0 * half_height * focus_dist * v,
        u=u, v=v, w=w,
        lens_radius=np.asarray(aperture / 2.0, f32),
        time0=np.asarray(t0, f32),
        time1=np.asarray(t1, f32),
    )
