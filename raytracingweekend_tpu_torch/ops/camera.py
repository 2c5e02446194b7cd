"""Thin-lens camera (reference: camera.h:7-74).

`make_camera` builds the basis on the host in float32 numpy arithmetic, in
the same op order as raytracingweekend_tpu/ops/camera.make_camera, so the
basis is bitwise equal to the JAX one. The megakernel generates its rays on
the device from the basis packed by ops/megakernel.build_tables; the
wavefront integrators take theirs from `get_rays`.
"""
from __future__ import annotations

import math

import numpy as np
import torch

from ..models.scene_types import Camera
from ..utils import prng
from . import linalg, sampling


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


def get_rays(key, cam, s: torch.Tensor, t: torch.Tensor):
    """camera::get_ray (camera.h:36-50) for pixel parameters s, t (N,),
    with `cam` the camera's tensors on their device (packing.DeviceScene).
    Returns (origin (N, 3), normalized direction (N, 3), time (N,))."""
    kd, kt = prng.split(key)
    shape = tuple(s.shape)
    rd = cam.lens_radius * sampling.random_in_unit_disk(kd, shape, s.device)
    offset = cam.u[None, :] * rd[..., 0:1] + cam.v[None, :] * rd[..., 1:2]
    time = cam.time0 + sampling.uniform(kt, shape, device=s.device) * (
        cam.time1 - cam.time0)
    direction = (cam.lower_left_corner[None, :]
                 + s[..., None] * cam.horizontal[None, :]
                 + t[..., None] * cam.vertical[None, :]
                 - cam.origin[None, :] - offset)
    origin = cam.origin[None, :] + offset
    return origin, linalg.normalize(direction), time
