"""Wavefront PDFs for one-sample MIS (reference: pdf.h and the pdf_value /
random hooks at hittable.h:208-228, sphere.h:88-108, hittable_list.h:44-59).

The port of raytracingweekend_tpu/ops/pdfs.py: the lights list is a small
table and every operation runs over the whole wavefront.
`lights_pdf_value` averages the per-light solid-angle PDFs (each re-hits
its shape, like the probe rays at hittable.h:214 / sphere.h:92) and
`lights_sample` picks a uniform light and samples it.
"""
from __future__ import annotations

import math

import torch

from ..models import scene_types as st
from ..utils import prng
from . import linalg, packing, sampling
from .geometry import _select_axis

_EPS_T = 0.001  # probe-ray lower bound (hittable.h:214, sphere.h:92)


def cosine_pdf_value(normal, direction):
    """cosine_pdf::value (pdf.h:20-24): cos(theta) / pi clamped at 0."""
    cosine = linalg.dot(linalg.normalize(direction), linalg.normalize(normal))
    return torch.where(cosine <= 0, torch.zeros_like(cosine),
                       cosine / math.pi)


def cosine_pdf_sample(key, normal):
    """cosine_pdf::generate (pdf.h:26-29): a cosine direction in the
    normal's ONB frame."""
    u, v, w = linalg.onb_from_w(normal)
    a = sampling.random_cosine_direction(key, normal.shape[:-1],
                                         normal.device)
    return linalg.onb_local(u, v, w, a)


def _rect_light_pdf(o, v, ds):
    """xz_rect::pdf_value (hittable.h:208-222) for any axis code and baked
    transform: (N, L)."""
    lights, r = ds.lights, ds.rects
    ri = torch.where(lights.kind == st.LIGHT_RECT, lights.index,
                     torch.zeros_like(lights.index))
    off = r.offset[ri]
    c, s = r.cos_t[ri][None], r.sin_t[ri][None]
    shx = o[:, 0:1] - off[None, :, 0]
    shy = o[:, 1:2] - off[None, :, 1]
    shz = o[:, 2:3] - off[None, :, 2]
    ox = c * shx - s * shz
    oz = s * shx + c * shz
    dx = c * v[:, 0:1] - s * v[:, 2:3]
    dy = v[:, 1:2] * torch.ones_like(dx)
    dz = s * v[:, 0:1] + c * v[:, 2:3]
    axis = r.axis[ri][None]
    o_a, o_b, o_n = _select_axis(axis, ox, shy, oz)
    d_a, d_b, d_n = _select_axis(axis, dx, dy, dz)
    t = (r.k[ri][None] - o_n) / d_n
    pa = o_a + t * d_a
    pb = o_b + t * d_b
    hit = ((t > _EPS_T)
           & (pa >= r.a0[ri][None]) & (pa <= r.a1[ri][None])
           & (pb >= r.b0[ri][None]) & (pb <= r.b1[ri][None]))
    area = ((r.a1[ri] - r.a0[ri]) * (r.b1[ri] - r.b0[ri]))[None]
    v_len2 = linalg.length_squared(v)[:, None]
    dist2 = t * t * v_len2
    # |dot| with the object-space normal is rotation-invariant
    # (hittable.h:219)
    cosine = d_n.abs() / torch.sqrt(v_len2)
    pdf = dist2 / torch.clamp_min(cosine * area, 1e-20)
    return torch.where(hit, pdf, torch.zeros_like(pdf))


def _sphere_light_pdf(o, v, ds):
    """sphere::pdf_value (sphere.h:88-99): 1 / the subtended cone's solid
    angle where the probe ray hits: (N, L)."""
    lights, sph = ds.lights, ds.spheres
    si = torch.where(lights.kind == st.LIGHT_SPHERE, lights.index,
                     torch.zeros_like(lights.index))
    c = sph.center0[si]
    rad = sph.radius[si]
    oc = o[:, None, :] - c[None]
    a = linalg.dot(v, v)[:, None]
    b = (oc * v[:, None, :]).sum(-1)
    cc = (oc * oc).sum(-1) - (rad * rad)[None]
    disc = b * b - a * cc
    sq = linalg.safe_sqrt(disc)
    t_near = (-b - sq) / a
    t_far = (-b + sq) / a
    t = torch.where(t_near > _EPS_T, t_near, t_far)
    hit = (disc > 0) & (t > _EPS_T)
    dist2 = (oc * oc).sum(-1)
    ctm = linalg.safe_sqrt(1.0 - (rad * rad)[None] / dist2)
    solid_angle = 2.0 * math.pi * (1.0 - ctm)
    pdf = 1.0 / torch.clamp_min(solid_angle, 1e-20)
    return torch.where(hit, pdf, torch.zeros_like(pdf))


def lights_pdf_value(o, v, ds):
    """hittable_list::pdf_value over the lights list
    (hittable_list.h:44-53): the uniform average of the per-light PDFs.
    o, v: (N, 3) -> (N,)."""
    lights = ds.lights
    if lights.num == 0:
        return torch.zeros(o.shape[:-1], dtype=o.dtype, device=o.device)
    L = lights.kind.shape[0]
    N = o.shape[0]
    zeros = torch.zeros((N, L), dtype=o.dtype, device=o.device)
    rect_pdf = (_rect_light_pdf(o, v, ds) if ds.rects.axis.shape[0]
                else zeros)
    sph_pdf = (_sphere_light_pdf(o, v, ds) if ds.spheres.radius.shape[0]
               else zeros)
    per_light = torch.where((lights.kind == st.LIGHT_RECT)[None], rect_pdf,
                            sph_pdf)
    live = torch.arange(L, device=o.device) < lights.num
    return torch.where(live[None], per_light, zeros).sum(-1) / lights.num


def lights_sample(key, o, ds):
    """hittable_list::random over the lights list (hittable_list.h:55-59):
    a uniform light, then its direction rule. (N, 3): unnormalized toward a
    rect light (hittable.h:224-228), a unit cone direction toward a sphere
    light (sphere.h:101-108)."""
    N = o.shape[0]
    dev = o.device
    k_pick, k_rect, k_sph = prng.split(key, 3)
    pick = sampling.random_int(k_pick, (N,), 0, ds.lights.num - 1, dev)
    row = ds.light_rows[pick]
    kind = row[:, packing.L_KIND]

    ka, kb = prng.split(k_rect)
    ua = sampling.uniform(ka, (N,), device=dev)
    ub = sampling.uniform(kb, (N,), device=dev)
    pa = row[:, packing.L_A0] + ua * (row[:, packing.L_A1]
                                      - row[:, packing.L_A0])
    pb = row[:, packing.L_B0] + ub * (row[:, packing.L_B1]
                                      - row[:, packing.L_B0])
    kk = row[:, packing.L_K]
    axis = row[:, packing.L_AXIS]
    px = torch.where(axis == st.RECT_YZ, kk, pa)
    py = torch.where(axis == st.RECT_XY, pb,
                     torch.where(axis == st.RECT_XZ, kk, pa))
    pz = torch.where(axis == st.RECT_XY, kk, pb)
    c, s = row[:, packing.L_COS], row[:, packing.L_SIN]
    wx = c * px + s * pz
    wz = -s * px + c * pz
    point = (torch.stack([wx, py, wz], dim=-1)
             + row[:, packing.L_OFFX:packing.L_OFFZ + 1])
    rect_dir = point - o

    to_c = row[:, packing.L_CX:packing.L_CZ + 1] - o
    dist2 = linalg.length_squared(to_c)
    safe = dist2 > 0
    dist2 = torch.where(safe, dist2, torch.ones_like(dist2))
    ex = torch.tensor([1.0, 0.0, 0.0], dtype=o.dtype, device=dev)
    u, v, w = linalg.onb_from_w(torch.where(safe[:, None], to_c, ex))
    local = sampling.random_to_sphere(k_sph, row[:, packing.L_RAD], dist2)
    sph_dir = linalg.onb_local(u, v, w, local)
    return torch.where((kind == st.LIGHT_RECT)[:, None], rect_dir, sph_dir)


def mixture_sample_and_value(key, p, normal, ds):
    """The integrator's sampling step (RayTracingWeekend.cpp:117-124): one
    direction from mixture(cosine_pdf(normal), hittable_pdf(lights, p)) and
    the mixture's PDF there. (direction (N, 3), pdf_val (N,)); with no
    lights the cosine pdf alone (cpp:117-121)."""
    k_coin, k_cos, k_light = prng.split(key, 3)
    dir_cos = cosine_pdf_sample(k_cos, normal)
    if ds.lights.num == 0:
        return dir_cos, cosine_pdf_value(normal, dir_cos)
    coin = sampling.uniform(k_coin, p.shape[:-1], device=p.device) < 0.5
    dir_light = lights_sample(k_light, p, ds)
    direction = torch.where(coin[:, None], dir_cos, dir_light)
    pdf_val = (0.5 * cosine_pdf_value(normal, direction)
               + 0.5 * lights_pdf_value(p, direction, ds))
    return direction, pdf_val
