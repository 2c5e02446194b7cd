"""Wavefront closest-hit intersection over flat primitive tables.

The port of raytracingweekend_tpu/ops/geometry.py (reference:
hittable_list.h:11-37 and the hit() methods of sphere.h:46-81,
hittable.h:149-267,299-404,430-479). A whole wavefront of N rays meets each
primitive table at once:

- spheres: kernel K7 (ops/intersect.py, csrc/intersect.cu) on CUDA
  tensors, its plain version on CPU tensors; the tensor's device decides.
  A BVH scene traverses its tree instead (ops/bvh.py);
- rects: a dense (N x R) test with the translate / rotate_y instancing
  baked into per-rect ray transforms;
- constant media: analytic convex entry / exit plus the stochastic scatter
  distance of hittable.h:463-474, order-independent.

The JAX package's TPU gather workaround (`lookup.table_lookup`) is plain
indexing here, and its RTW_DISABLE_PALLAS / RTW_FORCE_PALLAS_INTERPRET
switches have no counterpart.
"""
from __future__ import annotations

import dataclasses

import torch

from ..models import scene_types as st
from . import intersect, linalg, packing, sampling

# Large finite sentinel (RayTracingWeekend.cpp:52's max double,
# float32-safe).
BIG = intersect.BIG

T_MIN = 0.001  # hit interval lower bound (RayTracingWeekend.cpp:52)

KIND_NONE = -1
KIND_SPHERE = 0
KIND_RECT = 1
KIND_MEDIUM = 2


@dataclasses.dataclass
class Hit:
    """Wavefront hit_record (hittable.h:16-29) over N rays; `sattr` is the
    winner's packed shading row (ops/packing.py)."""
    hit: torch.Tensor      # (N,) bool
    t: torch.Tensor        # (N,)
    p: torch.Tensor        # (N, 3)
    normal: torch.Tensor   # (N, 3)
    u: torch.Tensor        # (N,)
    v: torch.Tensor        # (N,)
    mat: torch.Tensor      # (N,) int64
    sattr: torch.Tensor | None = None   # (N, 16)


def _miss(n: int, device):
    return (torch.full((n,), BIG, dtype=torch.float32, device=device),
            torch.full((n,), -1, dtype=torch.int64, device=device))


def hit_spheres(o, d, time, ds: packing.DeviceScene, t_min: float = T_MIN):
    """Closest sphere hit (best_t (N,), best_idx (N,) int64) over the
    scene's K7 table: the CUDA kernel for CUDA tensors, its plain version
    for CPU tensors. Misses read BIG (callers test best_t < BIG)."""
    if ds.sphere_table.shape[0] == 0:
        return _miss(o.shape[0], o.device)
    hit = (intersect.hit_spheres_kernel if o.is_cuda
           else intersect.hit_spheres_reference)
    return hit(o, d, time, ds.sphere_table, ds.scene.has_moving_spheres,
               t_min)


def _rect_object_space_components(o, d, rects, transforms: bool):
    """Ray components in every rect's object space: translate by -offset
    (hittable.h:299-301), then the rotate_y frame (hittable.h:373-382).
    Six (N, R) (or broadcastable) component tensors."""
    ox_w, oy, oz_w = o[:, 0:1], o[:, 1:2], o[:, 2:3]
    dx_w, dy, dz_w = d[:, 0:1], d[:, 1:2], d[:, 2:3]
    if not transforms:
        return ox_w, oy, oz_w, dx_w, dy, dz_w
    offx, offy, offz = (rects.offset[None, :, k] for k in range(3))
    c, s = rects.cos_t[None, :], rects.sin_t[None, :]
    shx = ox_w - offx
    shz = oz_w - offz
    ox = c * shx - s * shz
    oz = s * shx + c * shz
    dx = c * dx_w - s * dz_w
    dz = s * dx_w + c * dz_w
    return ox, oy - offy, oz, dx, dy * torch.ones_like(dx), dz


def _select_axis(axis, x, y, z):
    """Per-rect (a, b, n) components by axis code: xy -> (x, y, z),
    xz -> (x, z, y), yz -> (y, z, x) (hittable.h:142-267)."""
    a = torch.where(axis == st.RECT_YZ, y, x)
    b = torch.where(axis == st.RECT_XY, y, z)
    n = torch.where(axis == st.RECT_XY, z,
                    torch.where(axis == st.RECT_XZ, y, x))
    return a, b, n


def hit_rects(o, d, t_min: float, rects, transforms: bool):
    """Closest axis-rect hit (best_t (N,), best_idx (N,) int64): a dense
    (N x R) test."""
    N = o.shape[0]
    R = rects.axis.shape[0]
    if R == 0:
        return _miss(N, o.device)
    ox, oy, oz, dx, dy, dz = _rect_object_space_components(o, d, rects,
                                                           transforms)
    axis = rects.axis[None, :]
    o_a, o_b, o_n = _select_axis(axis, ox, oy, oz)
    d_a, d_b, d_n = _select_axis(axis, dx, dy, dz)
    t = (rects.k[None, :] - o_n) / d_n
    pa = o_a + t * d_a
    pb = o_b + t * d_b
    valid = ((t > t_min)
             & (pa >= rects.a0[None, :]) & (pa <= rects.a1[None, :])
             & (pb >= rects.b0[None, :]) & (pb <= rects.b1[None, :])
             & rects.active[None, :])
    t_cand = torch.where(valid, t, torch.full_like(t, BIG))
    best_t, best_idx = t_cand.min(dim=-1)
    return best_t, best_idx


def _medium_object_space_ray(o, d, media):
    osh = o[:, None, :] - media.offset[None, :, :]
    c, s = media.cos_t[None, :], media.sin_t[None, :]
    ox = c * osh[..., 0] - s * osh[..., 2]
    oz = s * osh[..., 0] + c * osh[..., 2]
    dx = c * d[:, None, 0] - s * d[:, None, 2]
    dz = s * d[:, None, 0] + c * d[:, None, 2]
    o_rot = torch.stack([ox, osh[..., 1], oz], dim=-1)
    d_rot = torch.stack([dx, d[:, None, 1].expand_as(dx), dz], dim=-1)
    return o_rot, d_rot


def _boundary_entry_exit(o_rot, d_rot, media):
    """Entry / exit parameters of each convex boundary over (-inf, inf)
    (hittable.h:438-449): (entry (N, V), exit (N, V), hit (N, V))."""
    oc = o_rot - media.p0[None, :, :]
    a = (d_rot * d_rot).sum(-1)
    b = (oc * d_rot).sum(-1)
    r = media.p1[None, :, 0]
    cc = (oc * oc).sum(-1) - r * r
    disc = b * b - a * cc
    sq = linalg.safe_sqrt(disc)
    s_entry = (-b - sq) / a
    s_exit = (-b + sq) / a
    s_hit = disc > 0
    inv = 1.0 / d_rot
    tt0 = (media.p0[None, :, :] - o_rot) * inv
    tt1 = (media.p1[None, :, :] - o_rot) * inv
    tlo = torch.minimum(tt0, tt1).amax(dim=-1)
    thi = torch.maximum(tt0, tt1).amin(dim=-1)
    b_hit = thi > tlo
    is_sphere = media.kind[None, :] == st.MEDIUM_SPHERE
    entry = torch.where(is_sphere, s_entry, tlo)
    exit_ = torch.where(is_sphere, s_exit, thi)
    hit = torch.where(is_sphere, s_hit, b_hit)
    return entry, exit_, hit


def hit_media(key, o, d, t_min: float, media):
    """Stochastic constant-medium candidate hit (hittable.h:430-479): the
    scatter point lies at entry + (-1/rho) ln(U) / |d| and counts only
    before the boundary exit. (best_t (N,), best_idx (N,) int64)."""
    N = o.shape[0]
    V = media.kind.shape[0]
    if V == 0:
        return _miss(N, o.device)
    o_rot, d_rot = _medium_object_space_ray(o, d, media)
    entry, exit_, bhit = _boundary_entry_exit(o_rot, d_rot, media)
    entry = torch.clamp_min(entry, t_min)
    dlen = torch.sqrt((d * d).sum(-1))[:, None]
    u = sampling.uniform(key, (N, V), device=o.device)
    hit_distance = -(1.0 / media.density[None, :]) * torch.log(
        torch.clamp_min(u, 1e-38))
    t_cand = entry + hit_distance / dlen
    valid = bhit & (entry < exit_) & (t_cand < exit_) & media.active[None, :]
    t_cand = torch.where(valid, t_cand, torch.full_like(t_cand, BIG))
    best_t, best_idx = t_cand.min(dim=-1)
    return best_t, best_idx


def closest_hit(key, o, d, time, ds: packing.DeviceScene, t_min=T_MIN,
                want_uv: bool | None = None) -> Hit:
    """Full-scene closest hit of N rays, with the winner's surface
    attributes (p, normal, u, v, mat) resolved from its packed rows. uv is
    computed only where the scene has an image texture (else 0) unless
    `want_uv`."""
    scene = ds.scene
    if want_uv is None:
        want_uv = scene.has_image_tex
    N = o.shape[0]
    dev = o.device
    if ds.bvh is not None:
        from .bvh import hit_spheres_bvh
        st_t, st_i = hit_spheres_bvh(o, d, time, t_min, ds.spheres, ds.bvh,
                                     scene.has_moving_spheres)
    else:
        st_t, st_i = hit_spheres(o, d, time, ds, t_min)
    rc_t, rc_i = hit_rects(o, d, t_min, ds.rects, scene.has_rect_transforms)
    if scene.has_media:
        md_t, md_i = hit_media(key, o, d, t_min, ds.media)
    else:
        md_t, md_i = _miss(N, dev)

    best_t = torch.minimum(torch.minimum(st_t, rc_t), md_t)
    kind = torch.where(st_t == best_t, KIND_SPHERE,
                       torch.where(rc_t == best_t, KIND_RECT, KIND_MEDIUM))
    hit = best_t < BIG
    kind = torch.where(hit, kind, KIND_NONE)
    idx = torch.where(kind == KIND_SPHERE, st_i,
                      torch.where(kind == KIND_RECT, rc_i, md_i))
    idx = torch.clamp_min(idx, 0)

    p_world = o + best_t[:, None] * d

    base_r, base_v = packing.prim_offsets(ds)[1:]
    prim = torch.where(kind == KIND_SPHERE, idx,
                       torch.where(kind == KIND_RECT, idx + base_r,
                                   idx + base_v))
    prim = torch.clamp(prim, 0, ds.geo.shape[0] - 1)
    geo = ds.geo[prim]
    sattr = ds.shading[prim]
    mat = torch.where(hit, geo[:, packing.G_MAT].long(),
                      torch.zeros_like(prim))

    is_s = kind == KIND_SPHERE
    is_r = kind == KIND_RECT

    # sphere normal / uv (sphere.h:56-77,115-122)
    cx = geo[:, packing.GS_C0X]
    cy = geo[:, packing.GS_C0Y]
    cz = geo[:, packing.GS_C0Z]
    if scene.has_moving_spheres:
        frac = (time - geo[:, packing.GS_T0]) * geo[:, packing.GS_IDT]
        cx = cx + frac * geo[:, packing.GS_DCX]
        cy = cy + frac * geo[:, packing.GS_DCY]
        cz = cz + frac * geo[:, packing.GS_DCZ]
    rad = geo[:, packing.GS_RAD]
    nz = rad != 0
    inv_r = torch.where(nz, 1.0 / torch.where(nz, rad, torch.ones_like(rad)),
                        torch.zeros_like(rad))
    s_normal = (p_world - torch.stack([cx, cy, cz], dim=-1)) * inv_r[:, None]
    zeros = torch.zeros((N,), dtype=o.dtype, device=dev)
    if want_uv:
        s_u, s_v = sampling.get_sphere_uv(s_normal)
    else:
        s_u = s_v = zeros

    # rect normal / uv (hittable.h:149-267 + baked transforms)
    if ds.rects.axis.shape[0]:
        axis = geo[:, packing.GR_AXIS]
        flip = geo[:, packing.GR_FLIP]
        zero = torch.zeros_like(flip)
        nx_o = torch.where(axis == st.RECT_YZ, flip, zero)
        ny_o = torch.where(axis == st.RECT_XZ, flip, zero)
        nz_o = torch.where(axis == st.RECT_XY, flip, zero)
        rc = geo[:, packing.GR_COS]
        rs = geo[:, packing.GR_SIN]
        if scene.has_rect_transforms:
            r_normal = torch.stack([rc * nx_o + rs * nz_o, ny_o,
                                    -rs * nx_o + rc * nz_o], dim=-1)
        else:
            r_normal = torch.stack([nx_o, ny_o, nz_o], dim=-1)
        if want_uv:
            if scene.has_rect_transforms:
                shx = o[:, 0] - geo[:, packing.GR_OFFX]
                shy = o[:, 1] - geo[:, packing.GR_OFFY]
                shz = o[:, 2] - geo[:, packing.GR_OFFZ]
                ox_o = rc * shx - rs * shz
                oz_o = rs * shx + rc * shz
                dx_o = rc * d[:, 0] - rs * d[:, 2]
                dz_o = rs * d[:, 0] + rc * d[:, 2]
                px = ox_o + best_t * dx_o
                py = shy + best_t * d[:, 1]
                pz = oz_o + best_t * dz_o
            else:
                px, py, pz = p_world[:, 0], p_world[:, 1], p_world[:, 2]
            pa, pb, _ = _select_axis(axis, px, py, pz)
            a0 = geo[:, packing.GR_A0]
            a1 = geo[:, packing.GR_A1]
            b0 = geo[:, packing.GR_B0]
            b1 = geo[:, packing.GR_B1]
            da, db = a1 - a0, b1 - b0
            nza, nzb = da != 0, db != 0
            one = torch.ones_like(da)
            r_u = (pa - a0) * torch.where(nza, 1.0 / torch.where(nza, da, one),
                                          zero)
            r_v = (pb - b0) * torch.where(nzb, 1.0 / torch.where(nzb, db, one),
                                          zero)
        else:
            r_u = r_v = zeros
    else:
        r_normal = torch.zeros((N, 3), dtype=o.dtype, device=dev)
        r_u = r_v = zeros

    # medium normal: arbitrary (1, 0, 0) (hittable.h:469-473)
    m_normal = torch.tensor([1.0, 0.0, 0.0], dtype=o.dtype,
                            device=dev).expand(N, 3)
    normal = torch.where(is_s[:, None], s_normal,
                         torch.where(is_r[:, None], r_normal, m_normal))
    uu = torch.where(is_s, s_u, torch.where(is_r, r_u, zeros))
    vv = torch.where(is_s, s_v, torch.where(is_r, r_v, zeros))
    return Hit(hit=hit, t=best_t, p=p_world, normal=normal, u=uu, v=vv,
               mat=mat, sattr=sattr)


def hit_aabb(o, d, box_min, box_max, t_min, t_max):
    """Slab-method AABB test (aabb.h:17-47), batched: (N,) bool."""
    inv = 1.0 / d
    t0 = (box_min - o) * inv
    t1 = (box_max - o) * inv
    lo = torch.minimum(t0, t1)
    hi = torch.maximum(t0, t1)
    tmin = torch.clamp_min(lo.amax(dim=-1), t_min)
    tmax = torch.clamp_max(hi.amin(dim=-1), t_max)
    return tmax > tmin


def surrounding_box(min0, max0, min1, max1):
    """AABB union (aabb.h:49-62)."""
    return torch.minimum(min0, min1), torch.maximum(max0, max1)
