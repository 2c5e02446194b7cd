"""SceneBuilder — compositional scene construction compiled to flat SoA
tables (the reference's make_shared<...> object graph, Scene/scene.h).

The port's counterpart of raytracingweekend_tpu/models/builder.py:
constant, checker, Perlin-noise and image textures; lambertian, metal,
dielectric, diffuse_light and isotropic materials; static and moving
spheres, axis rects, boxes and constant media (sphere or box boundary)
under the `Transform` instancing wrappers; the MIS lights list; and the
camera. `build()` pads and types every table exactly as the JAX builder
does, so the two produce bitwise-equal scenes; `use_bvh` adds the sphere
BVH of ops/bvh.py, which the wavefront path traverses.
"""
from __future__ import annotations

import math
from dataclasses import dataclass
from typing import List, Optional, Tuple

import numpy as np

from . import scene_types as st
from .camera import make_camera

_REAL = np.float32


def _pad_to(n: int, multiple: int) -> int:
    return max(multiple, ((n + multiple - 1) // multiple) * multiple)


@dataclass(frozen=True)
class Transform:
    """Rigid y-rotation + translation: the closure of the reference's
    translate / rotate_y instancing wrappers (hittable.h:269-416) under
    composition, so a nested wrapper chain bakes down to one (cos, sin,
    offset) column set per primitive.

    World mapping: x_world = Ry(theta) @ x_object + offset, with
    Ry = [[c, 0, s], [0, 1, 0], [-s, 0, c]] (hittable.h:390-397). Compose
    with `outer @ inner`: translate(rotate_y(obj)) ==
    Transform.translate(o) @ Transform.rotate_y(a)."""
    cos_t: float = 1.0
    sin_t: float = 0.0
    offset: Tuple[float, float, float] = (0.0, 0.0, 0.0)

    @staticmethod
    def rotate_y(degrees: float) -> "Transform":
        r = math.radians(degrees)
        return Transform(math.cos(r), math.sin(r), (0.0, 0.0, 0.0))

    @staticmethod
    def translate(offset) -> "Transform":
        ox, oy, oz = (float(v) for v in offset)
        return Transform(1.0, 0.0, (ox, oy, oz))

    @staticmethod
    def identity() -> "Transform":
        return Transform()

    def apply(self, p) -> Tuple[float, float, float]:
        """Map an object-space point to world space."""
        x, y, z = (float(v) for v in p)
        c, s = self.cos_t, self.sin_t
        return (c * x + s * z + self.offset[0],
                y + self.offset[1],
                -s * x + c * z + self.offset[2])

    def __matmul__(self, inner: "Transform") -> "Transform":
        """outer @ inner: rotations add, the inner offset is rotated into
        the outer frame."""
        c = self.cos_t * inner.cos_t - self.sin_t * inner.sin_t
        s = self.sin_t * inner.cos_t + self.cos_t * inner.sin_t
        return Transform(c, s, self.apply(inner.offset))

    def is_identity(self) -> bool:
        return (self.cos_t == 1.0 and self.sin_t == 0.0
                and self.offset == (0.0, 0.0, 0.0))


def _combine_transform(transform: Optional[Transform], rotate_y: float,
                       translate) -> Transform:
    """Builder kwarg convention: `transform` (outermost) wraps the
    translate(rotate_y(...)) that the plain kwargs express."""
    t = Transform.translate(translate) @ Transform.rotate_y(rotate_y)
    return t if transform is None else transform @ t


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


@dataclass
class _Rect:
    axis: int
    a0: float
    a1: float
    b0: float
    b1: float
    k: float
    flip: float
    cos_t: float
    sin_t: float
    offset: Tuple[float, float, float]
    mat: int


@dataclass
class _Medium:
    kind: int
    p0: Tuple[float, float, float]
    p1: Tuple[float, float, float]
    cos_t: float
    sin_t: float
    offset: Tuple[float, float, float]
    density: float
    mat: int


class SceneBuilder:
    """Build a Scene by declaring textures -> materials -> primitives.

    Texture and material constructors return plain int handles; primitive
    constructors return ('sphere' | 'rect' | 'medium', row_index) handles
    like the JAX builder's, usable with `add_light`."""

    SPHERE_BLOCK = 256  # sphere-table padding block of the JAX builder

    def __init__(self):
        self._textures: List[_Tex] = []
        self._materials: List[_Mat] = []
        self._spheres: List[_Sphere] = []
        self._rects: List[_Rect] = []
        self._media: List[_Medium] = []
        self._lights: List[Tuple[int, int]] = []
        self._images: List[np.ndarray] = []
        self._camera: Optional[st.Camera] = None
        self._has_rect_transforms = False
        self._has_moving = False

    # ---- textures (texture.h) ----
    def constant(self, color) -> int:
        self._textures.append(_Tex(st.TEX_CONSTANT, tuple(color)))
        return len(self._textures) - 1

    def checker(self, even: int, odd: int) -> int:
        """checker_texture (texture.h:29-50) of two texture handles."""
        self._textures.append(_Tex(st.TEX_CHECKER, even=even, odd=odd))
        return len(self._textures) - 1

    def noise(self, scale: float = 5.0, mode: int = st.NOISE_MARBLE) -> int:
        """noise_texture (texture.h:52-71) in display mode NOISE_*."""
        self._textures.append(_Tex(st.TEX_NOISE, scale=scale,
                                   noise_mode=mode))
        return len(self._textures) - 1

    def image(self, pixels: np.ndarray) -> int:
        """image_texture (texture.h:73-98) from an (H, W, 3) float array in
        [0, 1] with row 0 at the image bottom (the `utils.image.load_image`
        convention), stored top-down so the reference's (1 - v) row lookup
        (texture.h:84) applies as it is."""
        pixels = np.asarray(pixels, dtype=_REAL)
        assert pixels.ndim == 3 and pixels.shape[-1] == 3
        self._images.append(pixels[::-1])
        self._textures.append(_Tex(st.TEX_IMAGE,
                                   image_id=len(self._images) - 1))
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

    def diffuse_light(self, tex) -> int:
        """Emitter (material.h:227-247); `tex` is a texture handle or a
        color."""
        if not isinstance(tex, int):
            tex = self.constant(tex)
        self._materials.append(_Mat(st.MAT_DIFFUSE_LIGHT, tex=tex))
        return len(self._materials) - 1

    def isotropic(self, tex) -> int:
        """Phase function of a constant medium (material.h:252-265)."""
        if not isinstance(tex, int):
            tex = self.constant(tex)
        self._materials.append(_Mat(st.MAT_ISOTROPIC, tex=tex))
        return len(self._materials) - 1

    # ---- primitives ----
    def sphere(self, center, radius: float, mat: int, *, center1=None,
               time0: float = 0.0, time1: float = 1.0,
               rotate_y: float = 0.0, translate=(0.0, 0.0, 0.0),
               transform: Optional[Transform] = None, flip: bool = False):
        """sphere / moving_sphere (sphere.h:130-131). Negative radius (or
        flip=True) gives inward normals (hollow glass, Scene/scene.h:85-86).
        A sphere is rotation-invariant about its centre, so the instancing
        wrappers bake into the centre(s)."""
        tr = _combine_transform(transform, rotate_y, translate)
        c0 = tr.apply(center)
        c1 = c0 if center1 is None else tr.apply(center1)
        if c1 != c0:
            self._has_moving = True
        if flip:
            radius = -radius
        self._spheres.append(
            _Sphere(c0, c1, float(time0), float(time1), float(radius), mat))
        return ("sphere", len(self._spheres) - 1)

    def rect(self, axis: str, a0, a1, b0, b1, k, mat: int, *,
             flip: bool = False, rotate_y: float = 0.0,
             translate=(0.0, 0.0, 0.0), transform: Optional[Transform] = None):
        """xy / xz / yz rect (hittable.h:142-267) with the flip_normals /
        rotate_y (degrees) / translate wrappers baked in; `transform`
        composes an arbitrary nested wrapper chain outside those."""
        code = {"xy": st.RECT_XY, "xz": st.RECT_XZ, "yz": st.RECT_YZ}[axis]
        tr = _combine_transform(transform, rotate_y, translate)
        if not tr.is_identity():
            self._has_rect_transforms = True
        self._rects.append(_Rect(
            code, float(a0), float(a1), float(b0), float(b1), float(k),
            -1.0 if flip else 1.0, tr.cos_t, tr.sin_t, tr.offset, mat))
        return ("rect", len(self._rects) - 1)

    def box(self, p0, p1, mat: int, *, rotate_y: float = 0.0,
            translate=(0.0, 0.0, 0.0), transform: Optional[Transform] = None):
        """Axis box as 6 rects with the reference's face flips
        (hittable_list.h:65-114), sharing one instancing transform."""
        x0, y0, z0 = (float(v) for v in p0)
        x1, y1, z1 = (float(v) for v in p1)
        kw = dict(rotate_y=rotate_y, translate=translate, transform=transform)
        return [
            self.rect("xy", x0, x1, y0, y1, z1, mat, **kw),
            self.rect("xy", x0, x1, y0, y1, z0, mat, flip=True, **kw),
            self.rect("xz", x0, x1, z0, z1, y1, mat, **kw),
            self.rect("xz", x0, x1, z0, z1, y0, mat, flip=True, **kw),
            self.rect("yz", y0, y1, z0, z1, x1, mat, **kw),
            self.rect("yz", y0, y1, z0, z1, x0, mat, flip=True, **kw),
        ]

    def constant_medium_sphere(self, center, radius: float, density: float,
                               mat: int, *, rotate_y: float = 0.0,
                               translate=(0.0, 0.0, 0.0),
                               transform: Optional[Transform] = None):
        """constant_medium with a sphere boundary (hittable.h:420-489)."""
        tr = _combine_transform(transform, rotate_y, translate)
        self._media.append(_Medium(
            st.MEDIUM_SPHERE, tuple(float(x) for x in center),
            (float(radius), 0.0, 0.0), tr.cos_t, tr.sin_t, tr.offset,
            float(density), mat))
        return ("medium", len(self._media) - 1)

    def constant_medium_box(self, p0, p1, density: float, mat: int, *,
                            rotate_y: float = 0.0, translate=(0.0, 0.0, 0.0),
                            transform: Optional[Transform] = None):
        """constant_medium with a box boundary."""
        tr = _combine_transform(transform, rotate_y, translate)
        self._media.append(_Medium(
            st.MEDIUM_BOX, tuple(float(x) for x in p0),
            tuple(float(x) for x in p1), tr.cos_t, tr.sin_t, tr.offset,
            float(density), mat))
        return ("medium", len(self._media) - 1)

    def add_light(self, handle):
        """Register a rect or sphere in the MIS lights list
        (Scene/scene.h:27,35)."""
        kind, idx = handle
        code = {"rect": st.LIGHT_RECT, "sphere": st.LIGHT_SPHERE}[kind]
        self._lights.append((code, idx))

    def camera(self, lookfrom, lookat, vup, vfov, aspect, aperture,
               focus_dist, t0=0.0, t1=1.0):
        self._camera = make_camera(lookfrom, lookat, vup, vfov, aspect,
                                   aperture, focus_dist, t0, t1)

    # ---- compile ----
    def build(self, *, background: int = st.BG_GRADIENT,
              render_type: int = st.RENDER_SHADED, name: str = "",
              use_bvh: bool = False,
              lambertian_strategy: str = "mis") -> st.Scene:
        """Compile to a Scene. use_bvh builds a sphere BVH (ops/bvh.py) and
        stores it on the scene; the wavefront's closest hit then traverses
        it instead of the brute-force table scan."""
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

        # Rects, padded to 8 (0 rows when the scene has none).
        nr = len(self._rects)
        R = _pad_to(nr, 8) if nr else 0
        rdat = {k: np.zeros(R, _REAL) for k in
                ("a0", "a1", "b0", "b1", "k", "flip", "cos_t", "sin_t")}
        rdat["flip"][:] = 1.0
        rdat["cos_t"][:] = 1.0
        raxis = np.zeros(R, np.int32)
        roff = np.zeros((R, 3), _REAL)
        rmat = np.zeros(R, np.int32)
        ract = np.zeros(R, bool)
        for i, r in enumerate(self._rects):
            raxis[i] = r.axis
            for kk in rdat:
                rdat[kk][i] = getattr(r, kk)
            roff[i] = r.offset
            rmat[i] = r.mat
            ract[i] = True
        # a1 = b1 = 1 on padding rows, as the JAX builder pads them
        rdat["a1"][nr:] = 1.0
        rdat["b1"][nr:] = 1.0
        rects = st.Rects(axis=raxis, **rdat, offset=roff, mat=rmat,
                         active=ract)

        # Media, padded to 4 (0 rows when unused).
        nv = len(self._media)
        V = _pad_to(nv, 4) if nv else 0
        mkind = np.zeros(V, np.int32)
        mp0 = np.zeros((V, 3), _REAL)
        mp1 = np.ones((V, 3), _REAL)
        mcos = np.ones(V, _REAL)
        msin = np.zeros(V, _REAL)
        moff = np.zeros((V, 3), _REAL)
        mden = np.ones(V, _REAL)
        mmat = np.zeros(V, np.int32)
        mact = np.zeros(V, bool)
        for i, m in enumerate(self._media):
            mkind[i] = m.kind
            mp0[i] = m.p0
            mp1[i] = m.p1
            mcos[i], msin[i] = m.cos_t, m.sin_t
            moff[i] = m.offset
            mden[i] = m.density
            mmat[i] = m.mat
            mact[i] = True
        media = st.Media(kind=mkind, p0=mp0, p1=mp1, cos_t=mcos, sin_t=msin,
                         offset=moff, density=mden, mat=mmat, active=mact)

        mats = self._materials or [_Mat(st.MAT_LAMBERTIAN)]
        materials = st.Materials(
            mtype=np.asarray([m.mtype for m in mats], np.int32),
            tex=np.asarray([m.tex for m in mats], np.int32),
            fuzz=np.asarray([m.fuzz for m in mats], np.float32),
            ref_idx=np.asarray([m.ref_idx for m in mats], np.float32))

        texs = self._textures or [_Tex(st.TEX_CONSTANT)]
        images = image_hw = None
        if self._images:   # one (I, Hmax, Wmax, 3) table, zero-padded
            hmax = max(im.shape[0] for im in self._images)
            wmax = max(im.shape[1] for im in self._images)
            images = np.zeros((len(self._images), hmax, wmax, 3), _REAL)
            image_hw = np.zeros((len(self._images), 2), np.int32)
            for i, im in enumerate(self._images):
                images[i, :im.shape[0], :im.shape[1]] = im
                image_hw[i] = im.shape[:2]
        textures = st.Textures(
            ttype=np.asarray([t.ttype for t in texs], np.int32),
            color=np.asarray([t.color for t in texs], np.float32),
            scale=np.asarray([t.scale for t in texs], np.float32),
            noise_mode=np.asarray([t.noise_mode for t in texs], np.int32),
            even=np.asarray([t.even for t in texs], np.int32),
            odd=np.asarray([t.odd for t in texs], np.int32),
            image_id=np.asarray([t.image_id for t in texs], np.int32),
            images=images, image_hw=image_hw)

        # The lights list, padded to one row; num is the true count.
        lt = self._lights or [(st.LIGHT_RECT, 0)]
        lights = st.Lights(kind=np.asarray([l[0] for l in lt], np.int32),
                           index=np.asarray([l[1] for l in lt], np.int32),
                           num=len(self._lights))

        tree = None
        if use_bvh:
            from ..ops.bvh import build_sphere_bvh
            tree = build_sphere_bvh(spheres)

        ttypes = {t.ttype for t in self._textures}
        # a checker whose child is not a constant texture needs the
        # wavefront's recursive texture evaluation
        complex_checker = any(
            t.ttype == st.TEX_CHECKER
            and (self._textures[t.even].ttype != st.TEX_CONSTANT
                 or self._textures[t.odd].ttype != st.TEX_CONSTANT)
            for t in self._textures)
        return st.Scene(
            spheres=spheres, rects=rects, media=media, materials=materials,
            textures=textures, lights=lights, camera=self._camera, bvh=tree,
            background=background, render_type=render_type,
            has_moving_spheres=self._has_moving,
            has_rect_transforms=self._has_rect_transforms,
            has_media=bool(self._media),
            has_noise_tex=st.TEX_NOISE in ttypes,
            noise_modes=tuple(sorted({t.noise_mode for t in self._textures
                                      if t.ttype == st.TEX_NOISE})),
            has_image_tex=st.TEX_IMAGE in ttypes,
            has_checker_tex=st.TEX_CHECKER in ttypes,
            has_metal=any(m.mtype == st.MAT_METAL for m in mats),
            has_dielectric=any(m.mtype == st.MAT_DIELECTRIC for m in mats),
            has_isotropic=any(m.mtype == st.MAT_ISOTROPIC for m in mats),
            has_lights_mat=any(m.mtype == st.MAT_DIFFUSE_LIGHT for m in mats),
            lambertian_strategy=lambertian_strategy,
            needs_legacy_textures=complex_checker, name=name)
