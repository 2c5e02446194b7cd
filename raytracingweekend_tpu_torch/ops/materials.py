"""Wavefront material shading: scatter / emitted / scattering_pdf as masked
vector branches (reference: material.h).

The port of raytracingweekend_tpu/ops/materials.py. Every material type
the scene has is evaluated over the whole wavefront and selected by type
code. The lambertian branch carries the book-3 one-sample-MIS weighting or
one of the reference's historical strategies (`lambertian_strategy`);
metal, dielectric and isotropic are the reference's specular path
(material.h:51-57, RayTracingWeekend.cpp:114-115).
"""
from __future__ import annotations

import dataclasses
import math

import torch

from ..models import scene_types as st
from ..utils import prng
from . import linalg, packing, pdfs, sampling, textures
from .geometry import Hit


def _eval_texture_packed(sh, u, v, p, ds):
    """texture::value over the packed shading rows (ops/packing.py).
    sh: (N, 16) -> (N, 3)."""
    scene = ds.scene
    ttype = sh[:, packing.S_TTYPE]
    out = sh[:, packing.S_COL:packing.S_COL + 3]
    if scene.has_checker_tex:
        sines = (torch.sin(10.0 * p[..., 0]) * torch.sin(10.0 * p[..., 1])
                 * torch.sin(10.0 * p[..., 2]))
        cval = torch.where(sines[:, None] < 0,
                           sh[:, packing.S_ODD:packing.S_ODD + 3],
                           sh[:, packing.S_EVEN:packing.S_EVEN + 3])
        out = torch.where((ttype == st.TEX_CHECKER)[:, None], cval, out)
    if scene.has_noise_tex:
        modes = scene.noise_modes or (st.NOISE_MARBLE, st.NOISE_SMOOTH,
                                      st.NOISE_TURB)
        nval = textures._noise_value(p, sh[:, packing.S_SCALE],
                                     sh[:, packing.S_NMODE], modes)
        out = torch.where((ttype == st.TEX_NOISE)[:, None], nval[:, None],
                          out)
    if scene.has_image_tex and ds.textures.images is not None:
        ival = textures._image_value(ds.textures,
                                     sh[:, packing.S_IMG].long(), u, v)
        out = torch.where((ttype == st.TEX_IMAGE)[:, None], ival, out)
    return out


@dataclasses.dataclass
class ShadeResult:
    direction: torch.Tensor  # (N, 3) next ray direction (may be unnormalized)
    weight: torch.Tensor     # (N, 3) throughput multiplier of this vertex
    emitted: torch.Tensor    # (N, 3) radiance emitted at this vertex
    scatter: torch.Tensor    # (N,) bool: the path continues


def shade(key, d_in, hit: Hit, ds) -> ShadeResult:
    """One shading step of N rays at their hit points: the Shaded branch
    of color() (RayTracingWeekend.cpp:56-133), emitted + attenuation *
    scattering_pdf * L(next) / pdf_val for the lambertian pdf, attenuation
    * L(next) for the specular materials."""
    scene = ds.scene
    N = d_in.shape[0]
    dev = d_in.device
    zeros3 = torch.zeros((N, 3), dtype=d_in.dtype, device=dev)
    # miss lanes carry p = o + BIG d: zero it (their results are masked)
    p = torch.where(hit.hit[:, None], hit.p, zeros3)
    if hit.sattr is not None and not scene.needs_legacy_textures:
        mtype = hit.sattr[:, packing.S_MTYPE].long()
        fuzz_all = hit.sattr[:, packing.S_FUZZ]
        ref_idx_all = hit.sattr[:, packing.S_RIDX]
        tex_val = _eval_texture_packed(hit.sattr, hit.u, hit.v, p, ds)
    else:
        mats = ds.materials
        mtype = mats.mtype[hit.mat]
        fuzz_all = mats.fuzz[hit.mat]
        ref_idx_all = mats.ref_idx[hit.mat]
        tex_val = textures.eval_texture(mats.tex[hit.mat], hit.u, hit.v, p,
                                        ds)

    k_mix, k_fuzz, k_diel, k_iso = prng.split(key, 4)

    # emission (diffuse_light::emitted, material.h:238-244): one-sided
    if scene.has_lights_mat:
        facing = linalg.dot(hit.normal, d_in) > 0
        is_light = mtype == st.MAT_DIFFUSE_LIGHT
        emitted = torch.where((is_light & facing)[:, None], tex_val, zeros3)
    else:
        is_light = torch.zeros((N,), dtype=torch.bool, device=dev)
        emitted = zeros3

    # lambertian: cosine pdf + MIS mixture (material.h:77-122), or one of
    # the reference's historical strategies (material.h:83-107)
    strategy = scene.lambertian_strategy
    normal = hit.normal
    if strategy == "mis":
        mix_dir, pdf_val = pdfs.mixture_sample_and_value(k_mix, p, normal, ds)
    elif strategy == "unit_sphere":
        mix_dir = normal + sampling.random_in_unit_sphere(k_mix, (N,), dev)
        pdf_val = None
    elif strategy == "unit_vector":
        mix_dir = normal + sampling.random_unit_vector(k_mix, (N,), dev)
        pdf_val = None
    elif strategy == "hemisphere":
        mix_dir = sampling.random_in_hemisphere(k_mix, normal)
        pdf_val = torch.full((N,), 1.0 / (2.0 * math.pi), dtype=d_in.dtype,
                             device=dev)
    elif strategy == "onb":
        mix_dir = pdfs.cosine_pdf_sample(k_mix, normal)
        pdf_val = pdfs.cosine_pdf_value(normal, mix_dir)
    elif strategy == "light_only":
        if ds.lights.num <= 0:
            raise ValueError("light_only needs a lights list")
        mix_dir = pdfs.lights_sample(k_mix, p, ds)
        pdf_val = pdfs.lights_pdf_value(p, mix_dir, ds)
    else:
        raise ValueError(f"unknown lambertian_strategy {strategy!r}")
    cosine = linalg.dot(normal, linalg.normalize(mix_dir))
    spdf = torch.where(cosine < 0, torch.zeros_like(cosine),
                       cosine / math.pi)
    if pdf_val is None:
        # sampling pdf == scattering pdf: the weight is the albedo above
        # the horizon
        lam_ok = spdf > 0.0
        lam_weight = torch.where(lam_ok[:, None], tex_val, zeros3)
    else:
        lam_ok = pdf_val > 0.0
        ratio = spdf / torch.where(lam_ok, pdf_val, torch.ones_like(pdf_val))
        lam_weight = torch.where(lam_ok[:, None], tex_val * ratio[:, None],
                                 zeros3)

    # metal (material.h:124-140)
    if scene.has_metal:
        reflected_unit = linalg.reflect(linalg.normalize(d_in), normal)
        metal_dir = reflected_unit + fuzz_all[:, None] * (
            sampling.random_in_unit_sphere(k_fuzz, (N,), dev))
    else:
        metal_dir = d_in

    # dielectric (material.h:142-225)
    if scene.has_dielectric:
        ref_idx = ref_idx_all
        d_dot_n = linalg.dot(d_in, normal)
        d_len = linalg.length(d_in)
        inside = d_dot_n > 0
        outward_normal = torch.where(inside[:, None], -normal, normal)
        ni_over_nt = torch.where(inside, ref_idx, 1.0 / ref_idx)
        # Schlick cosine: the corrected exit form (material.h:160-183)
        ct = d_dot_n / d_len
        cos_exit = linalg.safe_sqrt(1.0 - ref_idx * ref_idx * (1.0 - ct * ct))
        cos_s = torch.where(inside, cos_exit, -ct)
        reflected = linalg.reflect(d_in, normal)
        refracted, can_refract = linalg.refract(d_in, outward_normal,
                                                ni_over_nt)
        reflect_prob = torch.where(can_refract,
                                   linalg.schlick(cos_s, ref_idx),
                                   torch.ones_like(cos_s))
        coin = sampling.uniform(k_diel, (N,), device=dev) < reflect_prob
        diel_dir = torch.where(coin[:, None], reflected, refracted)
    else:
        diel_dir = d_in

    # isotropic (material.h:252-265)
    iso_dir = (sampling.random_in_unit_sphere(k_iso, (N,), dev)
               if scene.has_isotropic else d_in)

    is_lam = mtype == st.MAT_LAMBERTIAN
    is_metal = mtype == st.MAT_METAL
    is_diel = mtype == st.MAT_DIELECTRIC
    is_iso = mtype == st.MAT_ISOTROPIC
    direction = torch.where(
        is_lam[:, None], mix_dir,
        torch.where(is_metal[:, None], metal_dir,
                    torch.where(is_diel[:, None], diel_dir, iso_dir)))
    weight = torch.where(
        is_lam[:, None], lam_weight,
        torch.where(is_diel[:, None], torch.ones_like(tex_val),
                    torch.where((is_metal | is_iso)[:, None], tex_val,
                                zeros3)))
    scatter = torch.where(is_lam, lam_ok, ~is_light)
    return ShadeResult(direction=direction, weight=weight, emitted=emitted,
                       scatter=scatter)
