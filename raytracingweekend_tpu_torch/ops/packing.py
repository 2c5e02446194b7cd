"""Packed per-primitive attribute rows, and the scene's tables on a device.

The port of raytracingweekend_tpu/ops/packing.py. Everything a ray needs
after intersection sits in two rows per primitive, P = S + R + V rows
(spheres, then rects, then media):

- geometry row (P, 16): sphere centre / motion / radius, or rect transform
  and extents, with the material index at lane 15;
- shading row (P, 16): the primitive's material and its texture, checker
  children's constant colours baked in.

The rows are made on the host in float32 numpy, bitwise the JAX package's,
and copied to the device once per (scene, device) by `device_scene`, which
also carries every table of the scene as tensors, the K7 sphere table
(ops/intersect.py), the light rows of ops/pdfs.py and the BVH arrays.
"""
from __future__ import annotations

import dataclasses
import types
import weakref

import numpy as np
import torch

from ..models import scene_types as st
from . import intersect

# Geometry-row lanes (meaning depends on primitive kind).
G_MAT = 15          # material index, all kinds
# sphere lanes
GS_C0X, GS_C0Y, GS_C0Z = 0, 1, 2
GS_DCX, GS_DCY, GS_DCZ = 3, 4, 5
GS_T0, GS_IDT, GS_RAD = 6, 7, 8
# rect lanes
GR_OFFX, GR_OFFY, GR_OFFZ = 0, 1, 2
GR_COS, GR_SIN, GR_AXIS, GR_FLIP = 3, 4, 5, 6
GR_A0, GR_A1, GR_B0, GR_B1, GR_K = 7, 8, 9, 10, 11

# Shading-row lanes.
S_MTYPE, S_FUZZ, S_RIDX = 0, 1, 2
S_COL = 3           # 3..5 base/albedo/emission color (texture color)
S_TTYPE, S_SCALE, S_NMODE = 6, 7, 8
S_EVEN = 9          # 9..11 checker even color
S_ODD = 12          # 12..14 checker odd color
S_IMG = 15          # image atlas id

LANES = 16

# Light-row lanes (pdfs.lights_sample).
(L_KIND, L_A0, L_A1, L_B0, L_B1, L_K, L_AXIS, L_COS, L_SIN,
 L_OFFX, L_OFFY, L_OFFZ, L_CX, L_CY, L_CZ, L_RAD) = range(16)

_F32 = np.float32


def prim_offsets(scene):
    """(sphere_base, rect_base, media_base) row offsets into the packed
    tables, of a Scene or its DeviceScene."""
    S = scene.spheres.mat.shape[0]
    R = scene.rects.mat.shape[0]
    return 0, S, S + R


def _inv_dt(time0, time1) -> np.ndarray:
    dt = np.asarray(time1, _F32) - np.asarray(time0, _F32)
    nz = dt != 0
    return np.where(nz, _F32(1.0) / np.where(nz, dt, _F32(1.0)), _F32(0.0))


def pack_geometry(scene: st.Scene) -> np.ndarray:
    """(P, 16) float32 geometry rows."""
    sph = scene.spheres
    c0 = np.asarray(sph.center0, _F32)
    g_s = np.zeros((c0.shape[0], LANES), _F32)
    g_s[:, GS_C0X:GS_C0Z + 1] = c0
    g_s[:, GS_DCX:GS_DCZ + 1] = np.asarray(sph.center1, _F32) - c0
    g_s[:, GS_T0] = sph.time0
    g_s[:, GS_IDT] = _inv_dt(sph.time0, sph.time1)
    g_s[:, GS_RAD] = sph.radius
    g_s[:, G_MAT] = sph.mat
    parts = [g_s]
    r = scene.rects
    if r.mat.shape[0]:
        g_r = np.zeros((r.mat.shape[0], LANES), _F32)
        g_r[:, GR_OFFX:GR_OFFZ + 1] = r.offset
        g_r[:, GR_COS] = r.cos_t
        g_r[:, GR_SIN] = r.sin_t
        g_r[:, GR_AXIS] = r.axis
        g_r[:, GR_FLIP] = r.flip
        g_r[:, GR_A0] = r.a0
        g_r[:, GR_A1] = r.a1
        g_r[:, GR_B0] = r.b0
        g_r[:, GR_B1] = r.b1
        g_r[:, GR_K] = r.k
        g_r[:, G_MAT] = r.mat
        parts.append(g_r)
    m = scene.media
    if m.mat.shape[0]:
        g_m = np.zeros((m.mat.shape[0], LANES), _F32)
        g_m[:, G_MAT] = m.mat
        parts.append(g_m)
    return np.concatenate(parts, axis=0)


def _material_rows(scene: st.Scene) -> np.ndarray:
    """(M, 16) float32: material attributes + flattened texture attributes,
    the checker children's constant colours baked in."""
    mats, tex = scene.materials, scene.textures
    ti = np.asarray(mats.tex)
    rows = np.zeros((ti.shape[0], LANES), _F32)
    rows[:, S_MTYPE] = mats.mtype
    rows[:, S_FUZZ] = mats.fuzz
    rows[:, S_RIDX] = mats.ref_idx
    color = np.asarray(tex.color, _F32)
    rows[:, S_COL:S_COL + 3] = color[ti]
    rows[:, S_TTYPE] = np.asarray(tex.ttype)[ti]
    rows[:, S_SCALE] = np.asarray(tex.scale, _F32)[ti]
    rows[:, S_NMODE] = np.asarray(tex.noise_mode)[ti]
    rows[:, S_EVEN:S_EVEN + 3] = color[np.asarray(tex.even)[ti]]
    rows[:, S_ODD:S_ODD + 3] = color[np.asarray(tex.odd)[ti]]
    rows[:, S_IMG] = np.asarray(tex.image_id)[ti]
    return rows


def pack_shading(scene: st.Scene) -> np.ndarray:
    """(P, 16) float32 shading rows aligned with pack_geometry's."""
    mat_rows = _material_rows(scene)
    cols = [mat_rows[np.asarray(scene.spheres.mat)]]
    if scene.rects.mat.shape[0]:
        cols.append(mat_rows[np.asarray(scene.rects.mat)])
    if scene.media.mat.shape[0]:
        cols.append(mat_rows[np.asarray(scene.media.mat)])
    return np.concatenate(cols, axis=0)


def light_rows(scene: st.Scene) -> np.ndarray:
    """(L, 16) float32 rows of each light's sampling attributes: rect
    extents and transform, or sphere centre and radius (pdfs._light_rows)."""
    lights = scene.lights
    kind = np.asarray(lights.kind)
    index = np.asarray(lights.index)
    rows = np.zeros((kind.shape[0], 16), _F32)
    rows[:, L_KIND] = kind
    r = scene.rects
    if r.mat.shape[0]:
        ri = np.where(kind == st.LIGHT_RECT, index, 0)
        for lane, col in ((L_A0, r.a0), (L_A1, r.a1), (L_B0, r.b0),
                          (L_B1, r.b1), (L_K, r.k), (L_AXIS, r.axis),
                          (L_COS, r.cos_t), (L_SIN, r.sin_t)):
            rows[:, lane] = np.asarray(col)[ri]
        rows[:, L_OFFX:L_OFFZ + 1] = np.asarray(r.offset, _F32)[ri]
    sph = scene.spheres
    if sph.mat.shape[0]:
        si = np.where(kind == st.LIGHT_SPHERE, index, 0)
        rows[:, L_CX:L_CZ + 1] = np.asarray(sph.center0, _F32)[si]
        rows[:, L_RAD] = np.asarray(sph.radius, _F32)[si]
    return rows


@dataclasses.dataclass
class DeviceScene:
    """A scene's tables as tensors on one device (integer fields int64,
    flags bool), the packed rows, the K7 table and the BVH arrays; `scene`
    holds the host scene's static fields (scene_types.STATIC_FIELDS),
    which select the code paths, and no reference to the scene itself."""
    scene: types.SimpleNamespace
    device: torch.device
    spheres: types.SimpleNamespace
    rects: types.SimpleNamespace
    media: types.SimpleNamespace
    materials: types.SimpleNamespace
    textures: types.SimpleNamespace
    lights: types.SimpleNamespace
    camera: types.SimpleNamespace
    geo: torch.Tensor
    shading: torch.Tensor
    sphere_table: torch.Tensor
    light_rows: torch.Tensor
    bvh: types.SimpleNamespace | None


def _to_device(obj, device) -> types.SimpleNamespace:
    out = {}
    for f in dataclasses.fields(obj):
        v = getattr(obj, f.name)
        if v is None or isinstance(v, int):     # absent images, lights.num
            out[f.name] = v
            continue
        a = np.asarray(v)
        if a.dtype.kind in "iu":
            a = a.astype(np.int64)
        out[f.name] = torch.from_numpy(np.ascontiguousarray(a)).to(device)
    return types.SimpleNamespace(**out)


_CACHE: dict = {}


def device_scene(scene: st.Scene, device) -> DeviceScene:
    """The scene's DeviceScene on `device`, made once per (scene object,
    device) and dropped from the cache when the scene is collected."""
    device = torch.device(device)
    key = (id(scene), str(device))
    hit = _CACHE.get(key)
    if hit is not None and hit[0]() is scene:
        return hit[1]

    def t(a):
        return torch.from_numpy(np.ascontiguousarray(a)).to(device)

    ds = DeviceScene(
        scene=types.SimpleNamespace(
            **{f: getattr(scene, f) for f in st.STATIC_FIELDS}),
        device=device,
        spheres=_to_device(scene.spheres, device),
        rects=_to_device(scene.rects, device),
        media=_to_device(scene.media, device),
        materials=_to_device(scene.materials, device),
        textures=_to_device(scene.textures, device),
        lights=_to_device(scene.lights, device),
        camera=_to_device(scene.camera, device),
        geo=t(pack_geometry(scene)), shading=t(pack_shading(scene)),
        sphere_table=t(intersect.pack_spheres(scene.spheres)),
        light_rows=t(light_rows(scene)),
        bvh=None if scene.bvh is None else _to_device(scene.bvh, device))
    cache = _CACHE
    cache[key] = (weakref.ref(scene, lambda _: cache.pop(key, None)), ds)
    return ds
