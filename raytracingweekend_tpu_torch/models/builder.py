"""SceneBuilder — compositional scene construction compiled to flat SoA
tables (the reference's make_shared<...> object graph, Scene/scene.h).

The port's counterpart of raytracingweekend_tpu/models/builder.py for the
book-1 subset: constant textures, lambertian / metal / dielectric
materials, static and moving spheres, and the camera. `build()` pads and
types every table exactly as the JAX builder does, so the two produce
bitwise-equal scenes. Rects, boxes, media, lights, checker / noise / image
textures and instancing transforms come with the next slices (ROADMAP
Queue 1 item 5).
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import List, Optional, Tuple

import numpy as np

from . import scene_types as st
from ..ops.camera import make_camera

_REAL = np.float32


def _pad_to(n: int, multiple: int) -> int:
    return max(multiple, ((n + multiple - 1) // multiple) * multiple)


@dataclass
class _Tex:
    ttype: int
    color: Tuple[float, float, float] = (0.0, 0.0, 0.0)
    scale: float = 1.0
    noise_mode: int = st.NOISE_MARBLE
    even: int = 0
    odd: int = 0
    image_id: int = 0


@dataclass
class _Mat:
    mtype: int
    tex: int = 0
    fuzz: float = 0.0
    ref_idx: float = 1.0


@dataclass
class _Sphere:
    center0: Tuple[float, float, float]
    center1: Tuple[float, float, float]
    time0: float
    time1: float
    radius: float
    mat: int


class SceneBuilder:
    """Build a Scene by declaring textures -> materials -> spheres.

    Texture and material constructors return plain int handles; `sphere`
    returns a ('sphere', row_index) handle like the JAX builder."""

    SPHERE_BLOCK = 256  # sphere-table padding block of the JAX builder

    def __init__(self):
        self._textures: List[_Tex] = []
        self._materials: List[_Mat] = []
        self._spheres: List[_Sphere] = []
        self._camera: Optional[st.Camera] = None
        self._has_moving = False

    # ---- textures (texture.h) ----
    def constant(self, color) -> int:
        self._textures.append(_Tex(st.TEX_CONSTANT, tuple(color)))
        return len(self._textures) - 1

    # ---- materials (material.h) ----
    def lambertian(self, tex: int) -> int:
        self._materials.append(_Mat(st.MAT_LAMBERTIAN, tex=tex))
        return len(self._materials) - 1

    def metal(self, color, fuzz: float = 0.0) -> int:
        tex = self.constant(color)
        self._materials.append(_Mat(st.MAT_METAL, tex=tex, fuzz=fuzz))
        return len(self._materials) - 1

    def dielectric(self, ref_idx: float) -> int:
        tex = self.constant((1.0, 1.0, 1.0))
        self._materials.append(_Mat(st.MAT_DIELECTRIC, tex=tex,
                                    ref_idx=ref_idx))
        return len(self._materials) - 1

    # ---- primitives ----
    def sphere(self, center, radius: float, mat: int, *, center1=None,
               time0: float = 0.0, time1: float = 1.0, flip: bool = False):
        """sphere / moving_sphere (sphere.h:130-131). Negative radius (or
        flip=True) gives inward normals (hollow glass, Scene/scene.h:85-86).
        """
        # "+ 0.0" maps -0.0 to +0.0, as the JAX builder's identity
        # instancing transform does (x_world = R x + offset).
        c0 = tuple(float(x) + 0.0 for x in center)
        c1 = (c0 if center1 is None
              else tuple(float(x) + 0.0 for x in center1))
        if c1 != c0:
            self._has_moving = True
        if flip:
            radius = -radius
        self._spheres.append(
            _Sphere(c0, c1, float(time0), float(time1), float(radius), mat))
        return ("sphere", len(self._spheres) - 1)

    def camera(self, lookfrom, lookat, vup, vfov, aspect, aperture,
               focus_dist, t0=0.0, t1=1.0):
        self._camera = make_camera(lookfrom, lookat, vup, vfov, aspect,
                                   aperture, focus_dist, t0, t1)

    # ---- compile ----
    def build(self, *, background: int = st.BG_GRADIENT,
              render_type: int = st.RENDER_SHADED, name: str = "",
              lambertian_strategy: str = "mis") -> st.Scene:
        assert self._camera is not None, "call camera(...) before build()"

        ns = len(self._spheres)
        S = _pad_to(ns, 8) if ns <= self.SPHERE_BLOCK else _pad_to(
            ns, self.SPHERE_BLOCK)
        c0 = np.zeros((S, 3), _REAL)
        c1 = np.zeros((S, 3), _REAL)
        t0 = np.zeros(S, _REAL)
        t1 = np.ones(S, _REAL)
        rad = np.ones(S, _REAL)
        smat = np.zeros(S, np.int32)
        sact = np.zeros(S, bool)
        for i, s in enumerate(self._spheres):
            c0[i] = s.center0
            c1[i] = s.center1
            t0[i], t1[i] = s.time0, s.time1
            rad[i] = s.radius
            smat[i] = s.mat
            sact[i] = True
        spheres = st.Spheres(center0=c0, center1=c1, time0=t0, time1=t1,
                             radius=rad, mat=smat, active=sact)

        # No rects or media in this slice: zero-row tables, exactly what
        # the JAX builder emits for a scene without them.
        rects = st.Rects(
            axis=np.zeros(0, np.int32),
            **{k: np.zeros(0, _REAL) for k in
               ("a0", "a1", "b0", "b1", "k", "flip", "cos_t", "sin_t")},
            offset=np.zeros((0, 3), _REAL), mat=np.zeros(0, np.int32),
            active=np.zeros(0, bool))
        media = st.Media(
            kind=np.zeros(0, np.int32), p0=np.zeros((0, 3), _REAL),
            p1=np.ones((0, 3), _REAL), cos_t=np.ones(0, _REAL),
            sin_t=np.zeros(0, _REAL), offset=np.zeros((0, 3), _REAL),
            density=np.ones(0, _REAL), mat=np.zeros(0, np.int32),
            active=np.zeros(0, bool))

        mats = self._materials or [_Mat(st.MAT_LAMBERTIAN)]
        materials = st.Materials(
            mtype=np.asarray([m.mtype for m in mats], np.int32),
            tex=np.asarray([m.tex for m in mats], np.int32),
            fuzz=np.asarray([m.fuzz for m in mats], np.float32),
            ref_idx=np.asarray([m.ref_idx for m in mats], np.float32))

        texs = self._textures or [_Tex(st.TEX_CONSTANT)]
        textures = st.Textures(
            ttype=np.asarray([t.ttype for t in texs], np.int32),
            color=np.asarray([t.color for t in texs], np.float32),
            scale=np.asarray([t.scale for t in texs], np.float32),
            noise_mode=np.asarray([t.noise_mode for t in texs], np.int32),
            even=np.asarray([t.even for t in texs], np.int32),
            odd=np.asarray([t.odd for t in texs], np.int32),
            image_id=np.asarray([t.image_id for t in texs], np.int32))

        # The JAX builder pads the lights list to one row; num = 0 lights.
        lights = st.Lights(kind=np.asarray([st.LIGHT_RECT], np.int32),
                           index=np.asarray([0], np.int32), num=0)

        return st.Scene(
            spheres=spheres, rects=rects, media=media, materials=materials,
            textures=textures, lights=lights, camera=self._camera,
            background=background, render_type=render_type,
            has_moving_spheres=self._has_moving,
            has_metal=any(m.mtype == st.MAT_METAL for m in mats),
            has_dielectric=any(m.mtype == st.MAT_DIELECTRIC for m in mats),
            has_isotropic=False, has_lights_mat=False,
            lambertian_strategy=lambertian_strategy, name=name)
