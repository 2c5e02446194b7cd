"""Packed per-primitive attribute rows, and the scene's tables on a device.

The port of raytracingweekend_tpu/ops/packing.py. Everything a ray needs
after intersection sits in two rows per primitive, P = S + R + V rows
(spheres, then rects, then media):

- geometry row (P, 16): sphere centre / motion / radius, or rect transform
  and extents, with the material index at lane 15;
- shading row (P, 16): the primitive's material and its texture, checker
  children's constant colours baked in.

`device_scene` packs the rows in float32 torch ops on the device
(`_torch_rows`), bitwise the JAX package's `pack_geometry`, `pack_shading`
and light rows, together with every table of the scene as tensors, the
K7 sphere table (ops/intersect.py) and the BVH arrays, once per (scene,
device). A differentiable scene (`dataclasses.replace` has put float32
tensors into some of its continuous leaves) packs the same way, its rows
differentiable w.r.t. those leaves, and is never cached: each call packs
it anew at its current values.
"""
from __future__ import annotations

import dataclasses
import functools
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


def leaf_tensor(x, device, dtype=torch.float32) -> torch.Tensor:
    """A scene leaf as a tensor on `device`: a tensor keeps its autograd
    graph (moved and cast as needed), anything else is copied from
    numpy."""
    if isinstance(x, torch.Tensor):
        return x.to(device=device, dtype=dtype)
    return torch.as_tensor(np.asarray(x), dtype=dtype, device=device)


def has_tensor_leaves(scene: st.Scene) -> bool:
    """True when a table or camera field of `scene` holds a torch tensor
    (a differentiable scene: gradients flow to those leaves)."""
    return any(isinstance(getattr(tab, f.name), torch.Tensor)
               for tab in (scene.spheres, scene.rects, scene.media,
                           scene.materials, scene.textures, scene.camera)
               for f in dataclasses.fields(tab))


def prim_offsets(scene):
    """(sphere_base, rect_base, media_base) row offsets into the packed
    tables, of a Scene or its DeviceScene."""
    S = scene.spheres.mat.shape[0]
    R = scene.rects.mat.shape[0]
    return 0, S, S + R


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

    @functools.cached_property
    def sphere_layout(self) -> intersect.SphereLayout:
        """The K7 table staged as the kernel reads it (made at first use:
        one host read of its form)."""
        return intersect.sphere_layout(self.sphere_table,
                                       self.scene.has_moving_spheres)


def _to_device(obj, device) -> types.SimpleNamespace:
    out = {}
    for f in dataclasses.fields(obj):
        v = getattr(obj, f.name)
        if v is None or isinstance(v, int):     # absent images, lights.num
            out[f.name] = v
            continue
        if isinstance(v, torch.Tensor):         # a differentiable leaf
            out[f.name] = v.to(device)
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
    if has_tensor_leaves(scene):
        return _device_scene(scene, device, *_torch_rows(scene, device))
    key = (id(scene), str(device))
    hit = _CACHE.get(key)
    if hit is not None and hit[0]() is scene:
        return hit[1]
    ds = _device_scene(scene, device, *_torch_rows(scene, device))
    cache = _CACHE
    cache[key] = (weakref.ref(scene, lambda _: cache.pop(key, None)), ds)
    return ds


def _device_scene(scene, device, geo, shading, sphere_table,
                  lights) -> DeviceScene:
    return DeviceScene(
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
        geo=geo, shading=shading, sphere_table=sphere_table,
        light_rows=lights,
        bvh=None if scene.bvh is None else _to_device(scene.bvh, device))


def _torch_rows(scene: st.Scene, device):
    """(geometry rows (P, 16), shading rows (P, 16), K7 sphere table
    (S, 12), light rows (L, 16)) in float32 torch ops on `device`, as the
    JAX package computes them (`pack_geometry`, `pack_shading`,
    `pallas_intersect.pack_spheres` in the port's lanes, pdfs'
    `_light_rows`), with the structure (type codes, indices, flags) read
    from the scene's numpy fields. The geometry row holds a sphere's
    centre, motion, t0, 1 / dt and radius or a rect's transform and
    extents, the material index at lane 15; the shading row the
    primitive's material and texture, checker children's colours baked
    in; the light row a rect light's extents and transform or a sphere
    light's centre and radius."""
    f32 = torch.float32

    def leaf(x):
        return leaf_tensor(x, device)

    def code(x):
        return torch.as_tensor(np.asarray(x, np.float32), device=device)

    def idx(x):
        return torch.as_tensor(np.asarray(x, np.int64), device=device)

    def rows(n, lanes):
        tab = torch.zeros((n, LANES), dtype=f32, device=device)
        for lane, v in lanes:
            if v.dim() == 2:
                tab[:, lane:lane + v.shape[1]] = v
            else:
                tab[:, lane] = v
        return tab

    sph, r, m = scene.spheres, scene.rects, scene.media
    c0, t0, t1 = leaf(sph.center0), leaf(sph.time0), leaf(sph.time1)
    dc = leaf(sph.center1) - c0
    dt = t1 - t0
    inv_dt = torch.where(dt != 0, 1.0 / torch.where(dt != 0, dt, 1.0), 0.0)
    rad = leaf(sph.radius)
    parts = [rows(c0.shape[0], ((GS_C0X, c0), (GS_DCX, dc), (GS_T0, t0),
                                (GS_IDT, inv_dt), (GS_RAD, rad),
                                (G_MAT, code(sph.mat))))]
    if r.mat.shape[0]:
        parts.append(rows(r.mat.shape[0], (
            (GR_OFFX, leaf(r.offset)), (GR_COS, leaf(r.cos_t)),
            (GR_SIN, leaf(r.sin_t)), (GR_AXIS, code(r.axis)),
            (GR_FLIP, leaf(r.flip)), (GR_A0, leaf(r.a0)),
            (GR_A1, leaf(r.a1)), (GR_B0, leaf(r.b0)), (GR_B1, leaf(r.b1)),
            (GR_K, leaf(r.k)), (G_MAT, code(r.mat)))))
    if m.mat.shape[0]:
        parts.append(rows(m.mat.shape[0], ((G_MAT, code(m.mat)),)))
    geo = torch.cat(parts)

    mats, tex = scene.materials, scene.textures
    ti = np.asarray(mats.tex)
    color = leaf(tex.color)
    mat_rows = rows(ti.shape[0], (
        (S_MTYPE, code(mats.mtype)), (S_FUZZ, leaf(mats.fuzz)),
        (S_RIDX, leaf(mats.ref_idx)), (S_COL, color[idx(ti)]),
        (S_TTYPE, code(np.asarray(tex.ttype)[ti])),
        (S_SCALE, leaf(tex.scale)[idx(ti)]),
        (S_NMODE, code(np.asarray(tex.noise_mode)[ti])),
        (S_EVEN, color[idx(np.asarray(tex.even)[ti])]),
        (S_ODD, color[idx(np.asarray(tex.odd)[ti])]),
        (S_IMG, code(np.asarray(tex.image_id)[ti]))))
    shading = torch.cat([mat_rows[idx(t.mat)] for t in (sph, r, m)
                         if t is sph or t.mat.shape[0]])

    table = torch.zeros((c0.shape[0], intersect.LANES), dtype=f32,
                        device=device)
    table[:, intersect.K_CX:intersect.K_CZ + 1] = c0
    table[:, intersect.K_R2] = rad * rad
    table[:, intersect.K_DCX:intersect.K_DCZ + 1] = dc
    table[:, intersect.K_T0] = t0
    table[:, intersect.K_IDT] = inv_dt
    table[:, intersect.K_ACT] = code(np.asarray(sph.active, bool))

    kind = np.asarray(scene.lights.kind)
    lr = [(L_KIND, code(kind))]
    if r.mat.shape[0]:
        ri = idx(np.where(kind == st.LIGHT_RECT, np.asarray(scene.lights.index),
                          0))
        lr += [(lane, leaf(col)[ri]) for lane, col in (
            (L_A0, r.a0), (L_A1, r.a1), (L_B0, r.b0), (L_B1, r.b1),
            (L_K, r.k), (L_AXIS, np.asarray(r.axis, np.float32)),
            (L_COS, r.cos_t), (L_SIN, r.sin_t), (L_OFFX, r.offset))]
    if sph.mat.shape[0]:
        si = idx(np.where(kind == st.LIGHT_SPHERE,
                          np.asarray(scene.lights.index), 0))
        lr += [(L_CX, c0[si]), (L_RAD, rad[si])]
    return geo, shading, table, rows(kind.shape[0], lr)
