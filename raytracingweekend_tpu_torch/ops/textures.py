"""Wavefront texture evaluation over the type-coded texture table.

The port of raytracingweekend_tpu/ops/textures.py (reference:
texture.h:10-98): every ray evaluates every texture type the scene has and
selects by type code; a checker's children are evaluated by one more pass,
so a checker of noise or image textures (the scenes the megakernel
refuses, `needs_legacy_textures`) renders here.
"""
from __future__ import annotations

import torch

from ..models import scene_types as st
from . import noise as noise_mod


def _noise_value(p, scale, mode, modes):
    """noise_texture::value's scalar for each display mode present
    (texture.h:59-67)."""
    nval = torch.zeros(p.shape[:-1], dtype=p.dtype, device=p.device)
    if st.NOISE_MARBLE in modes:
        marble = 0.5 * (1.0 + torch.sin(scale * p[..., 2]
                                        + 10.0 * noise_mod.turbulence(p)))
        nval = torch.where(mode == st.NOISE_MARBLE, marble, nval)
    if st.NOISE_SMOOTH in modes:
        smooth = 0.5 * (1.0 + noise_mod.noise(p * scale[..., None]))
        nval = torch.where(mode == st.NOISE_SMOOTH, smooth, nval)
    if st.NOISE_TURB in modes:
        turbv = noise_mod.turbulence(p * scale[..., None])
        nval = torch.where(mode == st.NOISE_TURB, turbv, nval)
    return nval


def _image_value(tex, img_id, u, v):
    """Nearest texel with the v flip (texture.h:81-94)."""
    hw = tex.image_hw[img_id]
    ny, nx = hw[..., 0], hw[..., 1]
    i = torch.clamp((u * nx).to(torch.int32).long(), min=torch.zeros_like(nx),
                    max=nx - 1)
    j = torch.clamp(((1.0 - v) * ny - 0.001).to(torch.int32).long(),
                    min=torch.zeros_like(ny), max=ny - 1)
    return tex.images[img_id, j, i]


def _eval_non_checker(ti, u, v, p, ds):
    """Texture rows `ti` (N,) taken as not checkers."""
    scene, tex = ds.scene, ds.textures
    out = tex.color[ti]
    if scene.has_noise_tex:
        modes = scene.noise_modes or (st.NOISE_MARBLE, st.NOISE_SMOOTH,
                                      st.NOISE_TURB)
        nval = _noise_value(p, tex.scale[ti], tex.noise_mode[ti], modes)
        out = torch.where((tex.ttype[ti] == st.TEX_NOISE)[..., None],
                          nval[..., None].expand_as(out), out)
    if scene.has_image_tex and tex.images is not None:
        ival = _image_value(tex, tex.image_id[ti], u, v)
        out = torch.where((tex.ttype[ti] == st.TEX_IMAGE)[..., None], ival,
                          out)
    return out


def eval_texture(ti, u, v, p, ds) -> torch.Tensor:
    """texture::value(u, v, p) for texture rows ti (N,) -> (N, 3)."""
    val = _eval_non_checker(ti, u, v, p, ds)
    if ds.scene.has_checker_tex:
        tex = ds.textures
        # the sign of sin(10x) sin(10y) sin(10z) picks the child
        # (texture.h:35-46)
        sines = (torch.sin(10.0 * p[..., 0]) * torch.sin(10.0 * p[..., 1])
                 * torch.sin(10.0 * p[..., 2]))
        child = torch.where(sines < 0, tex.odd[ti], tex.even[ti])
        cval = _eval_non_checker(child, u, v, p, ds)
        val = torch.where((tex.ttype[ti] == st.TEX_CHECKER)[..., None], cval,
                          val)
    return val
