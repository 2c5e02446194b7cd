"""The megakernel: the whole path-trace loop fused in one CUDA kernel.

The port of raytracingweekend_tpu/ops/megakernel.py for scenes of spheres,
axis rects and constant media (ROADMAP kernels K1-K5 and K5s: `_kernel`
with a dense sphere sweep, the rect hit, the one-sample MIS over the
lights list, one-sided emission, the stochastic medium boundaries with
isotropic scatter, checker, Perlin-noise and image textures, and the
cluster-culled sphere sweep of large tables, alone or ahead of the rects,
media and textures). One launch traces every pixel of a frame:
each lane owns one pixel slot and runs

    camera ray -> closest hit over every sphere slot, rect and medium ->
    albedo (constant, checker, Perlin noise or the nearest texel) ->
    shading (lambertian with the light mixture pdf, metal, dielectric,
    emitter, isotropic; gradient or black sky) -> Russian roulette ->
    regeneration of the slot's next sample

until its pixel has its samples. The module holds

- the host plan: bitwise the JAX package's sphere / attribute / cluster /
  rect / light / medium / camera tables (`build_tables`), sphere order
  (`_morton_order`, `_kd_cluster_order`), launch plan (`make_plan`) and
  pixel layout (`_pixel_layout`);
- the device helpers `_uniforms` (the lowbias32 counter-hash RNG, bitwise
  equal to JAX's), `_onb`, `_cossin2pi` and the polynomial `_atan2` /
  `_asin` of the sphere uv, in torch (the Perlin helpers are in
  ops/noise.py);
- `mega_kernel`, the wrapper of the CUDA kernel (csrc/megakernel.cu), and
  `trace_mega_reference`, its plain PyTorch version with the same
  arguments;
- `trace_mega`, the entry point, with the epilogue (overdraw
  renormalisation and the inverse pixel permutation).

Two modes share the kernel. Overdraw (the render path): every valid lane
of a tile keeps tracing samples of its own pixel until the tile's slowest
lane has `spp`, and the epilogue renormalises by the true per-lane count.
Exact-spp (the tape semantics of the JAX package's differentiable path):
each lane traces exactly `spp` samples and records the winner of every
bounce in the JAX encoding (-1 miss, [0, S) sphere slot, S + r rect row,
S + R + v medium row), which holds the port to the JAX package decision
by decision.

On a CPU tensor `trace_mega` runs the plain version; on a CUDA tensor it
launches the kernel or raises.
"""
from __future__ import annotations

import ctypes
import dataclasses
import functools
import math
import weakref
from typing import NamedTuple, Optional

import numpy as np
import torch

from ..models import scene_types as st
from . import _build
from . import noise as _noise
from .integrator import _block_linear_order
from .intersect import AXES_ALL, AXES_STATIC, AXIS_Y, slot_words
from .packing import leaf_tensor
from .rounding import _fma

BIG = 3.0e37
_HIT_CUT = 1.0e30  # best_t above this == miss

# ---- attribute table rows: (24, S), attribute-major (same rows as JAX) ----
(A_CX, A_CY, A_CZ, A_DCX, A_DCY, A_DCZ, A_T0, A_IDT, A_RINV, A_MTYPE,
 A_ALBX, A_ALBY, A_ALBZ, A_MPARAM, A_NSCALE,
 A_CHK, A_EVENX, A_EVENY, A_EVENZ, A_ODDX, A_ODDY, A_ODDZ,
 A_NOISE, A_IMG) = range(24)
A_ROWS = 24

# ---- intersect table lanes: (S, 128), sphere-major (same lanes as JAX) ----
(C_CX, C_CY, C_CZ, C_DCX, C_DCY, C_DCZ, C_T0, C_IDT, C_R2, C_ACT,
 C_NR2) = range(11)
SPH_LANES = 128
# The nine lanes the kernel's sweep reads, in the order of its shared-memory
# SoA (csrc/megakernel.cu, L_*).
SWEEP_LANES = (C_CX, C_CY, C_CZ, C_DCX, C_DCY, C_DCZ, C_T0, C_IDT, C_NR2)

# ---- cluster table lanes: (C, 128), cluster-major (same lanes as JAX): the
# AABB of the motion-swept spheres of each SB-slot cluster ----
(K_MINX, K_MINY, K_MINZ, K_MAXX, K_MAXY, K_MAXZ) = range(6)
CLUS_LANES = 128

# ---- rect table lanes: (max(R, 1), 128), rect-major (same lanes as JAX);
# the kernel reads RT_A0..RT_RIDX ----
(RT_A0, RT_A1, RT_B0, RT_B1, RT_K, RT_COS, RT_SIN, RT_OFFX, RT_OFFY,
 RT_OFFZ, RT_NX, RT_NY, RT_NZ, RT_MTYPE, RT_ALBX, RT_ALBY, RT_ALBZ,
 RT_FUZZ, RT_RIDX, RT_CHK, RT_EVENX, RT_EVENY, RT_EVENZ, RT_ODDX,
 RT_ODDY, RT_ODDZ, RT_NOI, RT_NSC, RT_IMG, RT_IDA, RT_IDB) = range(31)
RECT_LANES = 128

# ---- light table lanes: (max(L, 1), 128), light-major ----
(LT_A0, LT_A1, LT_B0, LT_B1, LT_K, LT_COS, LT_SIN, LT_OFFX, LT_OFFY,
 LT_OFFZ, LT_AREA, LT_CX, LT_CY, LT_CZ, LT_RAD) = range(15)
LIGHT_LANES = 128

# ---- constant-medium lanes: (max(V, 1), 128), medium-major. P0/P1 are the
# sphere centre / (radius, 0, 0) or the box min / max; NIRHO = -1/density;
# the kernel reads MD_P0X..MD_ALBZ ----
(MD_P0X, MD_P0Y, MD_P0Z, MD_P1X, MD_P1Y, MD_P1Z, MD_COS, MD_SIN,
 MD_OFFX, MD_OFFY, MD_OFFZ, MD_NIRHO, MD_ALBX, MD_ALBY,
 MD_ALBZ, MD_NOI, MD_NSC, MD_IMG) = range(18)
MED_LANES = 128

# ---- camera vector lanes: (1, 128) ----
(CAM_OX, CAM_OY, CAM_OZ, CAM_LLX, CAM_LLY, CAM_LLZ, CAM_HX, CAM_HY, CAM_HZ,
 CAM_VX, CAM_VY, CAM_VZ, CAM_UX, CAM_UY, CAM_UZ, CAM_WX, CAM_WY, CAM_WZ,
 CAM_LENS, CAM_T0, CAM_T1) = range(21)

# Output rows of one tile: radiance sums xyz, segments, lane iterations,
# samples done, sweep blocks (row 6: a culled launch counts the clusters
# its warp swept), lane need (row 7: the clusters the lane's own ray needed;
# 0 when dense); exact mode appends n_iters tape rows.
OUT_ROWS = 8
# A culled warp visit that fewer than K_BCAST lanes need is swept once per
# needing lane (csrc/megakernel.cu kBcast, sweep_compact), from K_BCAST on
# by broadcast; the answer is the same either way. An overdraw tile of a
# culled plan holds at most CULLED_MAX_T lanes (kCulledMaxT). The library
# exports both (rtw_culled_consts); `_kernel_lib` holds them to these.
K_BCAST = 20
CULLED_MAX_T = 512
# The dense kernels' (K1-K4) overdraw tiles hold at most DENSE_MAX_T
# lanes: their launch bounds (csrc/sweep.cuh kDenseMaxT). The library
# exports each dense instantiation's limit (rtw_dense_consts);
# `_kernel_lib` holds them to this.
DENSE_MAX_T = 512
# The (moving-axis mask, uniform shutter) forms each dense kernel is
# instantiated for, in the order of rtw_dense_consts (the masks and
# `slot_words`: the staged slot forms the dense sweep shares with K7,
# ops/intersect.py)
DENSE_FORMS = ((AXES_STATIC, False), (AXIS_Y, True), (AXES_ALL, True),
               (AXES_ALL, False))
# The features a surfaces instantiation compiles (csrc/megakernel.cu kF*):
# rects, the MIS lights, constant media, image, checker and noise
# textures; a form holding a feature set serves every scene whose features
# it holds, bit for bit.
F_RECTS, F_LIGHTS, F_MEDIA, F_IMAGE, F_CHECKER, F_NOISE = 1, 2, 4, 8, 16, 32
F_TEX = F_IMAGE | F_CHECKER | F_NOISE
F_SURF = F_RECTS | F_LIGHTS | F_MEDIA
F_ALL = F_SURF | F_TEX
# The dense surfaces kernel's forms, (axes, uniform shutter, features), in
# the order of rtw_surface_forms: the static form, which every surfaces
# scene of the library plans, one a feature set of its scenes (earth,
# earth_rect, two_perlin_spheres, light_sample, checker_spheres,
# cornell_box, then cornell_smoke and the untextured rest, texture_mix and
# the textured rest); the moving forms the general two. `surface_form`
# plans the first that serves the scene.
SURFACE_FORMS = tuple(
    (AXES_STATIC, False, f) for f in (
        F_IMAGE, F_RECTS | F_IMAGE, F_NOISE, F_RECTS | F_NOISE, F_CHECKER,
        F_RECTS | F_LIGHTS, F_SURF, F_ALL)) + tuple(
    (a, u, f) for a, u in DENSE_FORMS[1:] for f in (F_SURF, F_ALL))

# CUDA kernel launches through `mega_kernel` in this process, by ROADMAP
# kernel: "K1" the dense sphere-only instantiations; "K2+K3" the launches
# that run the rect, light or medium parts; "K4" those that run textures
# (a launch of a textured Cornell-like scene counts under both); "K5" the
# cluster-culled sphere kernel; "K5s" the cluster-culled kernel of scenes
# with rects, lights, media or textures.
KERNEL_LAUNCHES = {"K1": 0, "K2+K3": 0, "K4": 0, "K5": 0, "K5s": 0}


# ---------------------------------------------------------------------------
# Device helpers (torch): the counter-hash RNG, the ONB and cos/sin(2 pi u)
# ---------------------------------------------------------------------------

_M32 = 0xFFFFFFFF


def _rsqrt(x: torch.Tensor) -> torch.Tensor:
    """1/sqrt(x) in float32. On the card torch.rsqrt, which is CUDA's
    rsqrtf, the kernel's. On the CPU correctly rounded (through float64):
    XLA:CPU's rsqrt (vrsqrtps and two Newton steps) is correctly rounded on
    88% of inputs, torch's CPU 1/sqrt on 77%, and the two agree on 71%, so
    the correctly rounded form holds the plain version closest to the JAX
    kernel's decisions."""
    if x.is_cuda:
        return torch.rsqrt(x)
    return (1.0 / torch.sqrt(x.double())).float()


_F32_MIN_NORMAL = float(np.finfo(np.float32).tiny)


def _rsqrt_ftz(x: torch.Tensor) -> torch.Tensor:
    """`_rsqrt` of x with a subnormal x flushed to a zero of its sign
    first, as the sphere sweeps' root (csrc/sweep.cuh slot_root,
    rsqrt.approx.ftz) takes it: +inf (-inf) there, so a subnormal
    discriminant is a miss."""
    return _rsqrt(torch.where(x.abs() < _F32_MIN_NORMAL, x * 0.0, x))


def _sqrt(x: torch.Tensor) -> torch.Tensor:
    """sqrt(x) in float32, correctly rounded as XLA's and CUDA's sqrtf are:
    on the card torch.sqrt; on the CPU through float64 (torch's CPU sqrt
    is off by an ulp on ~0.3% of inputs)."""
    if x.is_cuda:
        return torch.sqrt(x)
    return torch.sqrt(x.double()).float()


def _mul32(x: torch.Tensor, c: int) -> torch.Tensor:
    """Low 32 bits of x * c for int64 x in [0, 2^32) and a constant c in
    [0, 2^32). Split in 16-bit halves so no int64 product overflows."""
    lo, hi = c & 0xFFFF, c >> 16
    return (x * lo + ((x * hi) & 0xFFFF) * 65536) & _M32


def _stream_base(seed, tile, it, salt: int, lane) -> torch.Tensor:
    """seed + lane*K1 + it*K3 + tile*K4 + salt*K5 (mod 2^32), the row-free
    part of the hash key. tile / lane are int64 tensors (broadcastable),
    seed and it Python ints (it may be -1)."""
    return ((seed & _M32) + _mul32(lane, 0x9E3779B1)
            + ((it & _M32) * 0xC2B2AE3D & _M32)
            + _mul32(tile, 0x27D4EB2F)
            + ((salt * 0x165667B1) & _M32)) & _M32


def _uniform_row(base: torch.Tensor, row: int) -> torch.Tensor:
    """U[0, 1) float32 for one row of the stream: lowbias32 finalizer (two
    xor-multiply rounds) and the mantissa-fill bitcast."""
    x = (base + ((row * 0x85EBCA77) & _M32)) & _M32
    x = x ^ (x >> 16)
    x = _mul32(x, 0x7FEB352D)
    x = x ^ (x >> 15)
    x = _mul32(x, 0x846CA68B)
    x = x ^ (x >> 16)
    return ((x >> 9) | 0x3F800000).to(torch.int32).view(torch.float32) - 1.0


def _uniforms(n_rows: int, T: int, seed: int, tile: int, it: int,
              salt: int, device="cpu") -> torch.Tensor:
    """(n_rows, T) U[0, 1) float32: lowbias32(seed, tile, iteration,
    draw-site salt, row, lane), bitwise equal to the JAX `_uniforms`."""
    lane = torch.arange(T, dtype=torch.int64, device=device)
    tile_t = torch.tensor(tile & _M32, dtype=torch.int64, device=device)
    base = _stream_base(seed, tile_t, it, salt, lane)
    return torch.stack([_uniform_row(base, r) for r in range(n_rows)])


_COS2PI_C = (0.99999999989, -19.739208743454, 64.939389075891,
             -85.456658314741, 60.242131337726, -26.404668183602,
             7.8001314261587, -1.4531123022253)
_SIN2PI_C = (6.2831853068171, -41.34170217066, 81.605245360302,
             -76.705760951618, 42.057370069181, -15.084554762991,
             3.7759575468553, -0.61505995531992)


def _cossin2pi(u: torch.Tensor):
    """(cos(2 pi u), sin(2 pi u)) for u in [0, 1): the JAX package's
    full-period polynomial pair in x = u - 1/2 (max abs error 7e-7)."""
    x = u - 0.5
    x2 = x * x
    cp = _fma(_COS2PI_C[-1], x2, _COS2PI_C[-2])
    for c in _COS2PI_C[-3::-1]:
        cp = _fma(cp, x2, c)
    sp = _fma(_SIN2PI_C[-1], x2, _SIN2PI_C[-2])
    for c in _SIN2PI_C[-3::-1]:
        sp = _fma(sp, x2, c)
    # the fit is about x = u - 1/2: cos(2 pi u) = -cos(2 pi x)
    return -cp, -(x * sp)


def _onb(wx, wy, wz):
    """Branchless ONB about unit w (onb.h:32-38): helper axis ey when
    |w.x| > 0.9 else ex; v = normalize(w x a); u = w x v."""
    bigx = wx.abs() > 0.9
    zero = torch.zeros_like(wx)
    vx = torch.where(bigx, -wz, zero)
    vy = torch.where(bigx, zero, wz)
    vz = torch.where(bigx, wx, -wy)
    vinv = _rsqrt(_fma(vz, vz, _fma(vx, vx, vy * vy)) + 1e-30)
    vx = vx * vinv
    vy = vy * vinv
    vz = vz * vinv
    ux = _fma(wy, vz, -(wz * vy))
    uy = _fma(wz, vx, -(wx * vz))
    uz = _fma(wx, vy, -(wy * vx))
    return ux, uy, uz, vx, vy, vz


# pi as the JAX kernel's uv code writes it, and its atan polynomial:
# atan(a) ~ a P(a^2) on [0, 1] (max abs error 5.8e-7)
_PI_UV = 3.14159265358979
_ATAN_C = (0.9999997, -0.33327976, 0.19895026, -0.13537675,
           0.0847597, -0.03775171, 0.008097295)


def _atan2(y: torch.Tensor, x: torch.Tensor) -> torch.Tensor:
    """The JAX kernel's octant-reduced polynomial atan2 (range (-pi, pi],
    atan2(0, 0) = 0, y = -0 on the -pi side), kept instead of torch.atan2:
    the texel index is int(u W), and a true atan2 differs from the
    polynomial by up to 6e-7, enough to move a lane to the next texel."""
    ax, ay = x.abs(), y.abs()
    a = torch.minimum(ax, ay) / torch.clamp_min(torch.maximum(ax, ay),
                                                 _f32(1e-30))
    s = a * a
    p = torch.full_like(a, _f32(_ATAN_C[-1]))
    for c in _ATAN_C[-2::-1]:
        p = _fma(p, s, c)
    r = a * p
    r = torch.where(ay > ax, _f32(0.5 * _PI_UV) - r, r)
    r = torch.where(x < 0.0, _f32(_PI_UV) - r, r)
    return torch.where(torch.signbit(y), -r, r)


def _asin(y: torch.Tensor) -> torch.Tensor:
    """asin(y) = atan2(y, sqrt(1 - y^2)) on y clipped to [-1, 1]."""
    y = torch.clamp(y, -1.0, 1.0)
    return _atan2(y, _sqrt(torch.clamp_min(_fma(-y, y, 1.0), 0.0)))


# ---------------------------------------------------------------------------
# Host plan: scene support, sphere order, tables, launch plan, pixel layout
# ---------------------------------------------------------------------------

_SURFACE_MATS = (st.MAT_LAMBERTIAN, st.MAT_METAL, st.MAT_DIELECTRIC,
                 st.MAT_DIFFUSE_LIGHT)


def unsupported_reason(scene: st.Scene) -> Optional[str]:
    """Why the megakernel cannot render the scene, naming the path that
    can; None when it can. It covers
    spheres, axis rects and constant media; constant, checker (of constant
    children), Perlin-noise and image textures on any of them;
    lambertian / metal / dielectric / diffuse_light surfaces, isotropic
    media, rect and sphere lights, shaded, the `mis` strategy, no BVH.
    Texels live in device memory, so an image has no size cap here."""
    if (scene.bvh is not None or scene.render_type != st.RENDER_SHADED
            or scene.lambertian_strategy != "mis"):
        return ("BVH scenes, normal rendering and non-MIS lambertian "
                "strategies take the wavefront path (loop_mode regen, "
                "tiled, while or scan)")
    if scene.needs_legacy_textures:
        return ("a checker of non-constant textures needs the wavefront's "
                "recursive texture evaluation (loop_mode regen, tiled, "
                "while or scan)")
    act = np.asarray(scene.spheres.active, bool)
    ract = np.asarray(scene.rects.active, bool)
    if not (act.any() or ract.any()):
        return "the scene has no sphere or rect"
    mtype = np.asarray(scene.materials.mtype)
    surf = np.concatenate([np.asarray(scene.spheres.mat)[act],
                           np.asarray(scene.rects.mat)[ract]])
    if not np.all(np.isin(mtype[surf], _SURFACE_MATS)):
        return ("an isotropic sphere or rect: the port shades isotropic "
                "material on constant media only")
    if scene.has_image_tex and scene.textures.images is None:
        return "an image texture without texels"
    return None


def supports_scene(scene: st.Scene) -> bool:
    """True when this slice of the port renders the scene (see
    `unsupported_reason`)."""
    return unsupported_reason(scene) is None


def _morton_order(centers: np.ndarray) -> np.ndarray:
    """Sort order by 3D Morton code of quantized centers (10 bits/axis)."""
    lo = centers.min(axis=0)
    span = np.maximum(centers.max(axis=0) - lo, 1e-9)
    q = np.clip(((centers - lo) / span * 1023.0).astype(np.uint64), 0, 1023)

    def spread(x):
        x = (x | (x << 16)) & np.uint64(0x30000FF)
        x = (x | (x << 8)) & np.uint64(0x300F00F)
        x = (x | (x << 4)) & np.uint64(0x30C30C3)
        x = (x | (x << 2)) & np.uint64(0x9249249)
        return x

    code = spread(q[:, 0]) | (spread(q[:, 1]) << np.uint64(1)) \
        | (spread(q[:, 2]) << np.uint64(2))
    return np.argsort(code, kind="stable").astype(np.int32)


def _kd_cluster_order(centers: np.ndarray, SB: int) -> np.ndarray:
    """Order by balanced kd-split on the widest axis, so every SB-sized
    chunk is a spatially compact box; every cluster but the last is full."""
    n = centers.shape[0]
    order = np.empty(n, np.int32)
    pos = 0

    def rec(idx):
        nonlocal pos
        if idx.size <= SB:
            order[pos:pos + idx.size] = idx
            pos += idx.size
            return
        pts = centers[idx]
        ax = int(np.argmax(pts.max(axis=0) - pts.min(axis=0)))
        k = -(-idx.size // SB)
        nl = (k // 2) * SB
        part = np.argpartition(pts[:, ax], nl)
        rec(idx[part[:nl]])
        rec(idx[part[nl:]])

    rec(np.arange(n, dtype=np.int32))
    return order


def build_tables(scene: st.Scene, SB: int = 64, order_override=None):
    """Host packing of the scene tables, bitwise equal to the JAX
    `build_tables` without its super-group rows and image atlas (the kernel
    reads the scene's float32 `textures.images` as they are). Returns
    (sph_tab (S, 128), attr_tab (24, S), rect_tab (max(R, 1), 128),
    light_tab (max(L, 1), 128), med_tab (max(V, 1), 128), cam_vec (1, 128),
    meta) as numpy; meta["clus_tab"] (C, 128) holds the cluster AABBs and
    meta["clus_moving"] each cluster's per-axis any-moving flags.

    Live spheres are deduplicated (first of exact geometric duplicates
    wins, as the reference's strict `t < closest` list sweep), ordered
    along a Morton curve (one cluster) or a kd split with the clusters
    holding the biggest spheres first (several clusters), and padded to a
    multiple of SB with inert rows (nr2 = +1 never hits).

    `order_override` (an (S,) int array, a plan's meta["slot_ext"]: the
    scene sphere row of each slot, -1 for padding) pins the slot layout
    instead: a re-tape at updated parameters keeps the slots its winner
    codes name, while the Morton sort and the radius block order would
    follow the new geometry."""
    sph = scene.spheres
    act = np.asarray(sph.active)
    c0 = np.asarray(sph.center0, np.float32)
    c1 = np.asarray(sph.center1, np.float32)
    t0 = np.asarray(sph.time0, np.float32)
    t1 = np.asarray(sph.time1, np.float32)
    rad = np.asarray(sph.radius, np.float32)

    live = np.nonzero(act)[0]
    if order_override is not None:
        live = np.zeros(0, np.int64)   # the pinned order replaces the sort
    if live.size:
        geom = np.stack([c0[live, 0], c0[live, 1], c0[live, 2],
                         c1[live, 0], c1[live, 1], c1[live, 2],
                         rad[live], t0[live], t1[live]], axis=1)
        _, first = np.unique(geom, axis=0, return_index=True)
        live = live[np.sort(first)]
    if live.size > SB:
        order = live[_kd_cluster_order(c0[live], SB)]
    else:
        order = (live[_morton_order(c0[live])] if live.size
                 else live.astype(np.int32))
    n = order.size
    S = max(SB, ((n + SB - 1) // SB) * SB)
    C = S // SB
    idx_ext = np.full((S,), -1, np.int64)
    idx_ext[:n] = order
    if order_override is not None:
        idx_ext = np.asarray(order_override, np.int64)
        S = idx_ext.size
        C = S // SB
        n = int(np.sum(idx_ext >= 0))
    elif C > 1:
        blocks = idx_ext.reshape(C, SB)
        key_r = np.array([np.abs(rad[b[b >= 0]]).max() if (b >= 0).any()
                          else -1.0 for b in blocks])
        blocks = blocks[np.argsort(-key_r, kind="stable")]
        idx_ext = blocks.reshape(S)
    meta = dict(S=S, C=C, SB=SB,
                # scene sphere row of each slot (-1: padding): decodes a
                # winner tape
                slot_ext=idx_ext.astype(np.int32),
                **_rect_meta(scene), **_light_meta(scene),
                **_medium_meta(scene))
    cam_vec, sph_tab, attr_tab, clus_tab, rect_tab, light_tab, med_tab = (
        t.numpy() for t in table_rows(scene, scene, meta, "cpu"))

    # the launch's static flags, read off the tables
    actm = idx_ext >= 0
    R, V = meta["R"], meta["V"]
    dc = sph_tab[:, C_DCX:C_DCZ + 1]
    noise_modes = {int(f) - 1 for f in np.concatenate(
        [attr_tab[A_NOISE][actm], rect_tab[:R, RT_NOI], med_tab[:V, MD_NOI]])
        if f > 0}
    has_image = bool(np.any(attr_tab[A_IMG] > 0)
                     or np.any(rect_tab[:R, RT_IMG] > 0)
                     or np.any(med_tab[:V, MD_IMG] > 0))
    img_hw = (tuple((int(h), int(w)) for h, w in
                    np.asarray(scene.textures.image_hw)) if has_image else ())
    light = float(st.MAT_DIFFUSE_LIGHT)
    # one shared (time0, 1/dt) over the live spheres lets the sweep take
    # the motion fraction once per ray instead of once per sphere
    t0a = sph_tab[actm, C_T0]
    idta = sph_tab[actm, C_IDT]
    cam = scene.camera
    meta.update(
        uniform_time=bool(n and np.all(t0a == t0a[0])
                          and np.all(idta == idta[0])),
        ut_t0=float(t0a[0]) if n else 0.0,
        ut_idt=float(idta[0]) if n else 0.0,
        moving_axes=tuple(bool(np.any(dc[:, ax] != 0)) for ax in range(3)),
        moving=bool(scene.has_moving_spheres),
        lens=float(cam.lens_radius) > 0.0,
        has_metal=bool(scene.has_metal),
        has_dielectric=bool(scene.has_dielectric),
        bg_gradient=scene.background == st.BG_GRADIENT,
        has_spheres=n > 0,
        has_light=bool(np.any(attr_tab[A_MTYPE][actm] == light)
                       or np.any(rect_tab[:R, RT_MTYPE] == light)),
        has_checker=bool(scene.has_checker_tex),
        has_noise=bool(noise_modes),
        noise_modes=tuple(sorted(noise_modes)),
        has_image=has_image, n_img=len(img_hw), img_hw=img_hw,
        has_iso=V > 0, clus_tab=clus_tab,
        # each cluster's per-axis any-moving flags
        clus_moving=tuple(
            tuple(bool(np.any(dc[c * SB:(c + 1) * SB, ax] != 0))
                  for ax in range(3))
            for c in range(C)))
    return sph_tab, attr_tab, rect_tab, light_tab, med_tab, cam_vec, meta


def _rect_meta(scene: st.Scene) -> dict:
    """The live rects' static metadata: row, axis code, rotation /
    translation presence and the transform group (rects sharing one baked
    rotate_y + translate)."""
    rects = scene.rects
    rlive = np.nonzero(np.asarray(rects.active))[0]
    r_cos = np.asarray(rects.cos_t, np.float32)
    r_sin = np.asarray(rects.sin_t, np.float32)
    r_off = np.asarray(rects.offset, np.float32)
    axes, rot, trans, tf, groups = [], [], [], [], {}
    for rr in rlive:
        axes.append(int(np.asarray(rects.axis)[rr]))
        ct_, st_ = float(r_cos[rr]), float(r_sin[rr])
        rot.append((ct_ != 1.0) or (st_ != 0.0))
        trans.append(bool(np.any(r_off[rr] != 0.0)))
        key = (rot[-1], trans[-1], ct_, st_,
               tuple(float(v) for v in r_off[rr]))
        tf.append(groups.setdefault(key, len(groups)))
    return dict(R=int(rlive.size), rect_axes=tuple(axes),
                rect_rot=tuple(rot), rect_trans=tuple(trans),
                rect_tf=tuple(tf), rect_rows=tuple(int(r) for r in rlive))


def _light_meta(scene: st.Scene) -> dict:
    """The MIS lights list's static metadata: kind (rect / sphere), axis,
    rotation, translation, row."""
    lights, rects = scene.lights, scene.rects
    L = int(lights.num)
    kinds, axes, rot, trans = [], [], [], []
    l_idx = np.asarray(lights.index)
    for i in range(L):
        kinds.append(int(np.asarray(lights.kind)[i]))
        if kinds[-1] == st.LIGHT_RECT:
            rr = int(l_idx[i])
            axes.append(int(np.asarray(rects.axis)[rr]))
            rot.append(float(np.asarray(rects.cos_t, np.float32)[rr]) != 1.0
                       or float(np.asarray(rects.sin_t, np.float32)[rr])
                       != 0.0)
            trans.append(bool(np.any(np.asarray(rects.offset,
                                                np.float32)[rr] != 0.0)))
        else:
            axes.append(0)
            rot.append(False)
            trans.append(False)
    return dict(L=L, light_kinds=tuple(kinds), light_axes=tuple(axes),
                light_rot=tuple(rot), light_trans=tuple(trans),
                light_rows=tuple(int(r) for r in l_idx[:L]))


def _medium_meta(scene: st.Scene) -> dict:
    """The live constant media's static metadata: boundary kind, rotation,
    translation, row."""
    media = scene.media
    vlive = np.nonzero(np.asarray(media.active))[0]
    m_cos = np.asarray(media.cos_t, np.float32)
    m_sin = np.asarray(media.sin_t, np.float32)
    m_off = np.asarray(media.offset, np.float32)
    return dict(V=int(vlive.size),
                med_kinds=tuple(int(np.asarray(media.kind)[v])
                                for v in vlive),
                med_rot=tuple(float(m_cos[v]) != 1.0 or float(m_sin[v]) != 0.0
                              for v in vlive),
                med_trans=tuple(bool(np.any(m_off[v] != 0.0))
                                for v in vlive),
                med_rows=tuple(int(v) for v in vlive))


def table_rows(scene: st.Scene, base: st.Scene, meta: dict, device) -> tuple:
    """The scene tables (cam_vec, sph_tab, attr_tab, clus_tab, rect_tab,
    light_tab, med_tab) as float32 torch ops on `device` under meta's slot
    layout and row lists, with the values from `scene`'s leaves (a tensor
    leaf keeps its autograd graph: ops/mega_grad.py differentiates the
    tables) and every structural decision (slot order, material and
    texture indices, type codes, axis codes, light kinds) from the
    concrete `base`. The arithmetic is the JAX package's host float32,
    op for op, so build_tables (which calls it on the CPU) is bitwise
    JAX's.

    Spheres: centre, motion, t0, 1 / dt (0 for a static sphere), r^2
    (-1 on padding rows, so nr2 = +1 never hits), each slot's attribute
    column (material, albedo, fuzz or IOR, checker colours, noise and
    image flags), and the AABB of each SB-slot cluster's motion-swept
    spheres. Rects: extents, plane, transform, world normal, material and
    texture lanes, 1 / extents. Lights: rect extents, plane, transform and
    area, or sphere centre and radius. Media: boundary, transform,
    -1 / density, albedo and texture lanes."""
    f32 = torch.float32

    def leaf(x):
        return leaf_tensor(x, device)

    def idx(a):
        return torch.as_tensor(np.asarray(a, np.int64), device=device)

    def const(a):
        return torch.as_tensor(np.asarray(a, np.float32), device=device)

    slot = np.asarray(meta["slot_ext"], np.int64)
    S = slot.size
    actm = slot >= 0
    act_t = torch.as_tensor(actm, device=device)
    safe_i = idx(np.where(actm, slot, 0))

    def pad(x, fill=0.0):
        x = leaf(x)
        if x.shape[0] == 0:
            return torch.full((S,) + tuple(x.shape[1:]), fill, dtype=f32,
                              device=device)
        m = act_t if x.dim() == 1 else act_t[:, None]
        return torch.where(m, x[safe_i], fill)

    sph, mats, tex = scene.spheres, scene.materials, scene.textures
    c0p, c1p = pad(sph.center0), pad(sph.center1)
    t0p, t1p = pad(sph.time0), pad(sph.time1, 1.0)
    radp = pad(sph.radius)
    actp = const(actm.astype(np.float32))
    dt = t1p - t0p
    idt = torch.where(dt != 0, 1.0 / torch.where(dt != 0, dt, 1.0), 0.0)
    dc = c1p - c0p
    r2 = torch.where(actp > 0, radp * radp, -1.0)
    sph_tab = torch.zeros((S, SPH_LANES), dtype=f32, device=device)
    for lane, v in ((C_CX, c0p[:, 0]), (C_CY, c0p[:, 1]),
                    (C_CZ, c0p[:, 2]), (C_DCX, dc[:, 0]),
                    (C_DCY, dc[:, 1]), (C_DCZ, dc[:, 2]),
                    (C_T0, t0p), (C_IDT, idt), (C_R2, r2),
                    (C_ACT, actp), (C_NR2, -r2)):
        sph_tab[:, lane] = v

    # cluster AABBs of the current geometry (padding never widens a box)
    C, SB = meta["C"], meta["SB"]
    absr = radp.abs()[:, None]
    los = torch.where(actp[:, None] > 0, torch.minimum(c0p, c1p) - absr,
                      float("inf"))
    his = torch.where(actp[:, None] > 0, torch.maximum(c0p, c1p) + absr,
                      float("-inf"))
    clus_tab = torch.zeros((C, CLUS_LANES), dtype=f32, device=device)
    clus_tab[:, K_MINX:K_MINZ + 1] = los.view(C, SB, 3).amin(1)
    clus_tab[:, K_MAXX:K_MAXZ + 1] = his.view(C, SB, 3).amax(1)

    # attribute rows: structure from base, values from the scene's leaves
    b_mats, b_tex = base.materials, base.textures
    base_mat = np.asarray(base.spheres.mat, np.int64)
    matp = (np.where(actm, base_mat[np.where(actm, slot, 0)], 0)
            if base_mat.size else np.zeros(S, np.int64))
    mtype = np.asarray(b_mats.mtype)[matp]
    ti = np.asarray(b_mats.tex)[matp]
    ttype = np.asarray(b_tex.ttype)
    nmode = np.asarray(b_tex.noise_mode)
    color = leaf(tex.color)
    alb = color[idx(ti)]
    fuzz = leaf(mats.fuzz)[idx(matp)]
    ridx = leaf(mats.ref_idx)[idx(matp)]
    rinv = torch.where(radp != 0, 1.0 / torch.where(radp != 0, radp, 1.0),
                       0.0)
    evc = color[idx(np.asarray(b_tex.even)[ti])]
    odc = color[idx(np.asarray(b_tex.odd)[ti])]
    is_noi = ttype[ti] == st.TEX_NOISE
    imgf = np.where(ttype[ti] == st.TEX_IMAGE,
                    1.0 + np.asarray(b_tex.image_id)[ti], 0.0)
    mparam = torch.where(const(mtype == st.MAT_METAL) > 0, fuzz,
                         torch.where(const(mtype == st.MAT_DIELECTRIC) > 0,
                                     ridx, 0.0))
    attr_tab = torch.zeros((A_ROWS, S), dtype=f32, device=device)
    for row, v in ((A_CX, c0p[:, 0]), (A_CY, c0p[:, 1]),
                   (A_CZ, c0p[:, 2]), (A_DCX, dc[:, 0]),
                   (A_DCY, dc[:, 1]), (A_DCZ, dc[:, 2]),
                   (A_T0, t0p), (A_IDT, idt), (A_RINV, rinv),
                   (A_MTYPE, const(mtype)),
                   (A_ALBX, alb[:, 0]), (A_ALBY, alb[:, 1]),
                   (A_ALBZ, alb[:, 2]), (A_MPARAM, mparam),
                   (A_CHK, const(ttype[ti] == st.TEX_CHECKER)),
                   (A_NSCALE, leaf(tex.scale)[idx(ti)]),
                   (A_NOISE, const(np.where(is_noi, 1.0 + nmode[ti],
                                               0.0))),
                   (A_EVENX, evc[:, 0]), (A_EVENY, evc[:, 1]),
                   (A_EVENZ, evc[:, 2]),
                   (A_ODDX, odc[:, 0]), (A_ODDY, odc[:, 1]),
                   (A_ODDZ, odc[:, 2]),
                   (A_IMG, const(np.where(actm, imgf, 0.0)))):
        attr_tab[row] = v

    def tex_lanes(t_i):
        """(albedo, checker flag, even, odd, 1 + noise mode or 0, noise
        scale or 0, 1 + image id or 0) of texture rows t_i."""
        tt = ttype[t_i]
        noi = tt == st.TEX_NOISE
        return (color[idx(t_i)], tt == st.TEX_CHECKER,
                color[idx(np.asarray(b_tex.even)[t_i])],
                color[idx(np.asarray(b_tex.odd)[t_i])],
                np.where(noi, 1.0 + nmode[t_i], 0.0),
                torch.where(const(noi) > 0, leaf(tex.scale)[idx(t_i)], 0.0),
                np.where(tt == st.TEX_IMAGE,
                         1.0 + np.asarray(b_tex.image_id)[t_i], 0.0))

    # rect rows (live rects of base, in order)
    R = meta["R"]
    rect_tab = torch.zeros((max(R, 1), RECT_LANES), dtype=f32,
                           device=device)
    if R:
        rects = scene.rects
        rr = np.asarray(meta["rect_rows"], np.int64)
        rj = idx(rr)
        g = {name: leaf(getattr(rects, name))[rj]
             for name in ("a0", "a1", "b0", "b1", "k", "cos_t", "sin_t",
                          "flip")}
        off = leaf(rects.offset)[rj]
        ax = np.asarray(base.rects.axis, np.int64)[rr]
        mi = np.asarray(base.rects.mat, np.int64)[rr]
        alb_r, chk, ev, od, noi, nsc, img = tex_lanes(
            np.asarray(b_mats.tex, np.int64)[mi])
        chk_t = const(chk)[:, None] > 0
        # object-space normal by axis code (XY -> z, XZ -> y, YZ -> x),
        # flipped, rotated object -> world
        n_o = [torch.where(const(ax == a) > 0, g["flip"], 0.0)
               for a in (2, 1, 0)]
        ct, sn = g["cos_t"], g["sin_t"]
        da, db = g["a1"] - g["a0"], g["b1"] - g["b0"]
        for lane, v in ((RT_A0, g["a0"]), (RT_A1, g["a1"]),
                        (RT_B0, g["b0"]), (RT_B1, g["b1"]),
                        (RT_K, g["k"]), (RT_COS, ct), (RT_SIN, sn),
                        (RT_OFFX, off[:, 0]), (RT_OFFY, off[:, 1]),
                        (RT_OFFZ, off[:, 2]),
                        (RT_NX, ct * n_o[0] + sn * n_o[2]),
                        (RT_NY, n_o[1]),
                        (RT_NZ, -sn * n_o[0] + ct * n_o[2]),
                        (RT_MTYPE, const(np.asarray(b_mats.mtype)[mi])),
                        (RT_ALBX, alb_r[:, 0]), (RT_ALBY, alb_r[:, 1]),
                        (RT_ALBZ, alb_r[:, 2]),
                        (RT_FUZZ, leaf(mats.fuzz)[idx(mi)]),
                        (RT_RIDX, leaf(mats.ref_idx)[idx(mi)]),
                        (RT_CHK, const(chk)),
                        (RT_NOI, const(noi)), (RT_NSC, nsc),
                        (RT_IMG, const(img)),
                        (RT_IDA, torch.where(
                            da != 0, 1.0 / torch.where(da != 0, da, 1.0),
                            0.0)),
                        (RT_IDB, torch.where(
                            db != 0, 1.0 / torch.where(db != 0, db, 1.0),
                            0.0))):
            rect_tab[:R, lane] = v
        rect_tab[:R, RT_EVENX:RT_EVENZ + 1] = torch.where(chk_t, ev,
                                                                0.0)
        rect_tab[:R, RT_ODDX:RT_ODDZ + 1] = torch.where(chk_t, od, 0.0)

    # light rows (kinds and rows static)
    L = meta["L"]
    light_tab = torch.zeros((max(L, 1), LIGHT_LANES), dtype=f32,
                            device=device)
    for i in range(L):
        li = int(meta["light_rows"][i])
        if meta["light_kinds"][i] == st.LIGHT_RECT:
            rects = scene.rects
            v = {name: leaf(getattr(rects, name))[li]
                 for name in ("a0", "a1", "b0", "b1", "k", "cos_t",
                              "sin_t")}
            for lane, name in ((LT_A0, "a0"), (LT_A1, "a1"),
                               (LT_B0, "b0"), (LT_B1, "b1"),
                               (LT_K, "k"), (LT_COS, "cos_t"),
                               (LT_SIN, "sin_t")):
                light_tab[i, lane] = v[name]
            light_tab[i, LT_OFFX:LT_OFFZ + 1] = leaf(rects.offset)[li]
            light_tab[i, LT_AREA] = (v["a1"] - v["a0"]) * (v["b1"]
                                                              - v["b0"])
        else:
            light_tab[i, LT_CX:LT_CZ + 1] = leaf(sph.center0)[li]
            light_tab[i, LT_RAD] = leaf(sph.radius)[li]

    # medium rows (rows and kinds static)
    V = meta["V"]
    med_tab = torch.zeros((max(V, 1), MED_LANES), dtype=f32,
                          device=device)
    if V:
        media = scene.media
        vr = np.asarray(meta["med_rows"], np.int64)
        vj = idx(vr)
        mi = np.asarray(base.media.mat, np.int64)[vr]
        alb_v, _, _, _, noi, nsc, img = tex_lanes(
            np.asarray(b_mats.tex, np.int64)[mi])
        med_tab[:V, MD_P0X:MD_P0Z + 1] = leaf(media.p0)[vj]
        med_tab[:V, MD_P1X:MD_P1Z + 1] = leaf(media.p1)[vj]
        med_tab[:V, MD_COS] = leaf(media.cos_t)[vj]
        med_tab[:V, MD_SIN] = leaf(media.sin_t)[vj]
        med_tab[:V, MD_OFFX:MD_OFFZ + 1] = leaf(media.offset)[vj]
        med_tab[:V, MD_NIRHO] = -1.0 / leaf(media.density)[vj]
        med_tab[:V, MD_ALBX:MD_ALBZ + 1] = alb_v
        med_tab[:V, MD_NOI] = const(noi)
        med_tab[:V, MD_NSC] = nsc
        med_tab[:V, MD_IMG] = const(np.where(noi > 0, 0.0, img))

    cam = scene.camera
    cam_vec = torch.zeros((1, 128), dtype=f32, device=device)
    for lane, v in ((CAM_OX, cam.origin),
                    (CAM_LLX, cam.lower_left_corner),
                    (CAM_HX, cam.horizontal), (CAM_VX, cam.vertical),
                    (CAM_UX, cam.u), (CAM_WX, cam.v)):
        cam_vec[0, lane:lane + 3] = leaf(v)
    cam_vec[0, CAM_LENS] = leaf(cam.lens_radius)
    cam_vec[0, CAM_T0] = leaf(cam.time0)
    cam_vec[0, CAM_T1] = leaf(cam.time1)

    return (cam_vec, sph_tab, attr_tab, clus_tab, rect_tab, light_tab,
            med_tab)


_TABLE_CACHE: dict = {}


def _scene_memo(cache: dict, scene, sub_key, build):
    """Per-scene memo keyed by object identity with weakref eviction, so a
    replaced scene never hits a stale entry."""
    key = id(scene)
    entry = cache.get(key)
    if entry is not None and entry[0]() is scene:
        per = entry[1]
        if sub_key not in per:
            per[sub_key] = build()
        return per[sub_key]
    val = build()
    ref = weakref.ref(scene, lambda _: cache.pop(key, None))
    cache[key] = (ref, {sub_key: val})
    return val


def build_tables_cached(scene: st.Scene, SB: int):
    """Memo of build_tables per scene object."""
    return _scene_memo(_TABLE_CACHE, scene, ("host", SB),
                       lambda: build_tables(scene, SB))


@dataclasses.dataclass(frozen=True)
class MegaPlan:
    """Static launch configuration of one megakernel launch."""
    T: int                 # lanes per tile (the RNG key's tile width)
    SB: int                # cluster size of the slot order
    S: int                 # sphere slots (padded)
    nx: int
    ny: int
    spp: int
    max_depth: int
    rr_depth: Optional[int]  # Russian roulette from this depth; None = off
    exact: bool            # exact-spp mode with the winner tape
    n_iters: int           # tape rows (exact mode), else 0
    t_min: float
    moving: bool           # scene has moving spheres (normal lerp)
    moving_axes: tuple     # per-axis any-moving (sweep lerp)
    uniform_time: bool
    ut_t0: float
    ut_idt: float
    lens: bool
    bg_gradient: bool
    has_spheres: bool      # any live sphere (else the sweep is skipped)
    has_light: bool        # a live surface is a diffuse_light
    R: int                 # live rects
    rect_codes: tuple      # per rect: axis | rotated << 2 | translated << 3
                           #   | transform group << 4
    L: int                 # lights in the MIS list
    light_codes: tuple     # per light: kind | axis << 1 | rot << 3 | tr << 4
    V: int                 # live constant media
    med_codes: tuple       # per medium: kind | rotated << 1 | translated << 2
    has_checker: bool = False   # the scene has a checker texture
    noise_modes: tuple = ()     # NOISE_* display modes that prims use
    img_hw: tuple = ()          # (height, width) per image, when one is used
    C: int = 1                  # sphere clusters of SB slots
    cull: bool = False          # cluster-culled sweep (K5) instead of dense
    dyn_order: int = 0          # culled visit order: near-to-far buckets,
    #                             0 = ascending cluster id
    feat: int = 0               # the surfaces form's features (F_*): a
    #                             dense plan's SURFACE_FORMS entry, F_ALL
    #                             or F_SURF culled; 0 without surfaces

    @property
    def textures(self) -> bool:
        """The launch evaluates checker, noise or image albedos (K4)."""
        return bool(self.has_checker or self.noise_modes or self.img_hw)

    @property
    def needs(self) -> int:
        """The surfaces features (F_*) the scene's rows use: rects, MIS
        lights, media, and each texture kind."""
        return ((F_RECTS if self.R else 0) | (F_LIGHTS if self.L else 0)
                | (F_MEDIA if self.V else 0)
                | (F_IMAGE if self.img_hw else 0)
                | (F_CHECKER if self.has_checker else 0)
                | (F_NOISE if self.noise_modes else 0))

    @property
    def surfaces(self) -> bool:
        """The scene needs the rect / light / medium parts of the kernel
        (K2, K3) or its textures (K4), which live in the same kernel;
        constant-textured sphere-only scenes run the book-1
        instantiations."""
        return bool(self.R or self.L or self.V or self.has_light
                    or self.textures)


def make_plan(scene: st.Scene, nx: int, ny: int, spp: int,
              max_depth: int = 50, rr_depth: Optional[int] = 4,
              T: Optional[int] = None, exact: bool = False,
              SB: Optional[int] = None, cull: Optional[bool] = None,
              dyn_order: Optional[int] = None):
    """Host-side launch plan: the packed tables and the static plan.

    Slots: one cluster of every live sphere up to 512 (the JAX package's
    book-1 order, without its 128-lane padding); beyond, clusters of 128
    slots, or of 256 in exact mode (JAX's tape plan, whose winner codes
    are these slot numbers). `SB` overrides the cluster size. T defaults
    to 256 lanes; in overdraw mode it is the CUDA block size, so
    T <= DENSE_MAX_T (512) or, culled, CULLED_MAX_T (512); exact mode
    runs blocks of 256 and takes any T up to 1024. The TPU's 128-lane
    rounding and 512-lane floor do not apply here.

    `cull` (auto: C > 1, as JAX's, whatever else the scene holds) takes
    a cluster-culled kernel: K5 on sphere-only scenes, K5s (the culled
    sweep ahead of the rects, media and textures) on the others. Each warp
    of 32 lanes votes every cluster's AABB against t_min and its lanes'
    running best and sweeps only the clusters one of its lanes can reach,
    in ascending cluster id or, with `dyn_order` > 0 buckets (auto: 16 in
    overdraw mode from C >= 8, else 0), near to far. The JAX package's
    `dyn_cull` switch has no counterpart: with no fused extraction to
    feed, its survivor-list sweep differs from interleaved votes only in
    the visit order, which is `dyn_order`. Returns (tables, plan); raises
    ValueError where a launch would not fit the card (T, or the tables a
    block holds in shared memory)."""
    reason = unsupported_reason(scene)
    if reason is not None:
        raise NotImplementedError(f"scene {scene.name!r}: {reason}")
    n_live = int(np.sum(np.asarray(scene.spheres.active)))
    if SB is None:
        SB = 512 if n_live <= 512 else (256 if exact else 128)
    SB = min(int(SB), max(8, -(-n_live // 8) * 8))
    tabs = build_tables_cached(scene, SB)
    meta = tabs[-1]
    T = 256 if T is None else int(T)
    if T <= 0 or (not exact and T > 1024):
        raise ValueError(f"tile width T={T} must be in [1, 1024] "
                         "(one CUDA block per tile in overdraw mode)")
    plan = MegaPlan(T=T, SB=SB, S=meta["S"], nx=nx, ny=ny, spp=spp,
                    max_depth=max_depth, rr_depth=rr_depth, exact=exact,
                    n_iters=spp * max_depth if exact else 0, t_min=0.001,
                    moving=meta["moving"], moving_axes=meta["moving_axes"],
                    uniform_time=meta["uniform_time"], ut_t0=meta["ut_t0"],
                    ut_idt=meta["ut_idt"], lens=meta["lens"],
                    bg_gradient=meta["bg_gradient"],
                    has_spheres=meta["has_spheres"],
                    has_light=meta["has_light"], R=meta["R"],
                    rect_codes=tuple(
                        a | r << 2 | t << 3 | g << 4 for a, r, t, g in zip(
                            meta["rect_axes"], meta["rect_rot"],
                            meta["rect_trans"], meta["rect_tf"])),
                    L=meta["L"],
                    light_codes=tuple(
                        k | a << 1 | r << 3 | t << 4 for k, a, r, t in zip(
                            meta["light_kinds"], meta["light_axes"],
                            meta["light_rot"], meta["light_trans"])),
                    V=meta["V"],
                    med_codes=tuple(
                        k | r << 1 | t << 2 for k, r, t in zip(
                            meta["med_kinds"], meta["med_rot"],
                            meta["med_trans"])),
                    has_checker=meta["has_checker"],
                    noise_modes=meta["noise_modes"], img_hw=meta["img_hw"],
                    C=meta["C"])
    if cull is None:
        cull = plan.C > 1
    if cull and T % 32:
        raise ValueError(f"the culled kernel votes per warp of 32 lanes: "
                         f"T={T} must be a multiple of 32")
    if cull and not exact and T > CULLED_MAX_T:
        raise ValueError(f"the culled kernels run blocks of at most "
                         f"{CULLED_MAX_T} lanes (128 registers a lane): "
                         f"T={T}")
    if not cull and not exact and T > DENSE_MAX_T:
        raise ValueError(f"the dense kernels run blocks of at most "
                         f"{DENSE_MAX_T} lanes (their launch bounds): "
                         f"T={T}")
    if dyn_order is None:
        dyn_order = 16 if plan.C >= 8 and not exact else 0
    if dyn_order < 0:
        raise ValueError(f"dyn_order={dyn_order} must be >= 0")
    plan = dataclasses.replace(plan, cull=bool(cull),
                               dyn_order=int(dyn_order) if cull else 0)
    if plan.surfaces:
        plan = dataclasses.replace(plan, feat=(
            (F_ALL if plan.textures else F_SURF) if plan.cull
            else surface_form(plan)))
    smem = shared_bytes(plan)
    if smem > SHARED_MAX:
        what = (f"the culled kernel's {plan.C} cluster boxes"
                if plan.cull else f"the dense sweep over S={plan.S} slots")
        raise ValueError(
            f"scene {scene.name!r}: {what}"
            + (f" and {plan.R} rect, {plan.L} light and {plan.V} medium "
               "rows" if plan.surfaces else "")
            + f" need {smem} bytes of shared memory per block, over the "
            f"card's {SHARED_MAX} (227 KB)"
            + ("" if plan.cull else "; past C = 1 the plan culls (cull=None "
               "or True), and holds only the cluster boxes there"))
    return tabs, plan


def surface_form(plan: MegaPlan, forms=None) -> int:
    """The features of the dense surfaces form that `plan` launches: the
    first of `forms` (default SURFACE_FORMS, the library's) of its (axes,
    uniform shutter) form that holds every feature the scene uses
    (`MegaPlan.needs`) and has textures exactly when the scene does.
    Raises ValueError when no built form serves it."""
    forms = SURFACE_FORMS if forms is None else forms
    need, axes = plan.needs, sweep_axes(plan)
    # the form rtw_mega_launch dispatches: static slots take the static
    # form, y-only motion has one shutter window
    uniform = axes == AXIS_Y or (axes == AXES_ALL and plan.uniform_time)
    for a, u, feat in forms:
        if ((a, u) == (axes, uniform) and feat & need == need
                and bool(feat & F_TEX) == plan.textures):
            return feat
    raise ValueError(
        f"no surfaces form of the kernel library serves the plan (axes "
        f"{axes}, uniform shutter {uniform}, features {need:#04x}): built "
        f"{[f for f in forms if f[:2] == (axes, uniform)]}")


# Shared memory a block can use on an H100 (sm_90), and the float32 lanes
# of each table row that the kernels copy there (csrc/megakernel.cu);
# noise: the Perlin permutation and its gradients as float4
SHARED_MAX = 232448
_SMEM_LANES = dict(rect=RT_RIDX + 1,
                   rect_tex=RT_IDB + 1, light=LT_RAD + 1, med=MD_ALBZ + 1,
                   med_tex=MD_IMG + 1, box=K_MAXZ + 1, noise=5 * 256)
# the staged camera vector's words, and a rect's words in the runs and
# their group headers (csrc/megakernel.cu Tables::runs, grp)
_CAM_WORDS = CAM_T1 + 1
_RUN_WORDS = 12


def sweep_axes(plan: MegaPlan) -> int:
    """The moving-axis mask of the plan's slot loop (bit a: the centres
    move along axis a), as the kernel is instantiated for it: AXES_STATIC,
    AXIS_Y (book 1: centres moving along y only, under one shutter
    window) or AXES_ALL for any other motion, which lerps static axes
    exactly (fmaf(fr, 0, c) == c); a scene marked moving whose centres
    stay put takes AXES_ALL too, as the kernel's moving forms did before
    masks."""
    mask = sum(1 << a for a, m in enumerate(plan.moving_axes) if m)
    if mask == 0:
        return AXES_ALL if plan.moving else AXES_STATIC
    return AXIS_Y if mask == AXIS_Y and plan.uniform_time else AXES_ALL


def shared_bytes(plan: MegaPlan) -> int:
    """Dynamic shared memory of the plan's launch, as the kernel lays it
    out: the dense kernels hold the staged slots (`slot_words` a slot),
    the culled ones (with static spheres) two buffers of a cluster's SB
    centre quads for each warp, then the (C, 6) cluster boxes and, in
    near-to-far order, C bucket slots for each warp; the surfaces kernels
    then, from a float4 boundary, their rect runs and group headers, the
    camera vector, their rect, light and medium rows, their codes, the
    image sizes and the Perlin tables (csrc/megakernel.cu
    surface_words)."""
    n = _SMEM_LANES
    if plan.cull:
        warps = (256 if plan.exact else plan.T) // 32
        # the moving instantiations stage no quads; the surfaces tables
        # start on a float4 boundary
        moving = sweep_axes(plan) != AXES_STATIC
        words = ((0 if moving else warps * 2 * plan.SB * 4)
                 + -(-plan.C * (n["box"] + (warps if plan.dyn_order else 0))
                     // 4) * 4)
    else:
        words = slot_words(sweep_axes(plan), plan.uniform_time) * plan.S
    if plan.surfaces:
        tex = plan.textures
        words += (plan.R * (_RUN_WORDS
                            + (n["rect_tex"] if tex else n["rect"]))
                  + _CAM_WORDS + plan.L * n["light"]
                  + plan.V * (n["med_tex"] if tex else n["med"])
                  + plan.R + plan.L + plan.V)
        if tex:
            words += 2 * len(plan.img_hw) + n["noise"]
    return 4 * words


def _layout_from_order(order, inv, nx: int, ny: int, T: int):
    """Split a pixel permutation into tiles of T lanes, one pixel a lane.
    Returns (pixf (n_tiles, 4, T) float32 rows [i, j, valid, pad], inverse
    permutation) as numpy."""
    n_pix = nx * ny
    n_tiles = -(-n_pix // T)
    order_p = np.pad(order, (0, n_tiles * T - n_pix), constant_values=n_pix)
    lanes = order_p.reshape(n_tiles, T)
    pixf = np.zeros((n_tiles, 4, T), np.float32)
    valid = lanes < n_pix
    safe = np.where(valid, lanes, 0)
    pixf[:, 0, :] = safe % nx
    pixf[:, 1, :] = safe // nx
    pixf[:, 2, :] = valid.astype(np.float32)
    return pixf, inv


@functools.lru_cache(maxsize=8)
def _pixel_layout(nx: int, ny: int, T: int):
    """Block-linear pixel order split into tiles (see _layout_from_order).
    Callers must not modify the returned arrays (they are cached)."""
    order, inv = _block_linear_order(nx, ny)
    return _layout_from_order(order, inv, nx, ny, T)


@functools.lru_cache(maxsize=8)
def _device_layout(nx: int, ny: int, T: int, device: str):
    pixf, inv = _pixel_layout(nx, ny, T)
    return (torch.from_numpy(pixf).to(device),
            torch.from_numpy(inv.astype(np.int64)).to(device))


def device_inputs(scene: st.Scene, plan: MegaPlan, device):
    """The launch's tensors on `device`, in the kernel's argument order:
    (pixf, cam_vec, sph_tab, attr_tab, clus_tab, rect_tab, light_tab,
    med_tab, perm, ranvec, images), plus the inverse pixel permutation.
    clus_tab (C, 128) float32 holds the cluster AABBs; perm (256,) int32
    and ranvec (256, 3) float32 are the Perlin tables; images is the
    scene's (n_img, Hmax, Wmax, 3) float32 texels, or one zero texel when
    the launch reads none. Tables are copied once per (scene, device),
    layouts once per shape; a dense surfaces overdraw plan gets its own
    copy of the layout per scene, whose pad row carries the tile order its
    launches learn (`_longest_first`)."""
    device = torch.device(device)
    tabs = _scene_memo(
        _TABLE_CACHE, scene, ("device", plan.SB, str(device)),
        lambda: table_tensors(build_tables_cached(scene, plan.SB), scene,
                              plan, device))
    pixf, inv = _device_layout(plan.nx, plan.ny, plan.T, str(device))
    if _orders_tiles(plan):
        pixf = _scene_memo(_TABLE_CACHE, scene,
                           ("tile order", plan.nx, plan.ny, plan.T,
                            str(device)), pixf.clone)
    return (pixf, *tabs), inv


def _orders_tiles(plan: MegaPlan) -> bool:
    """The launch runs its blocks in the order of the layout's pad row:
    the dense surfaces kernels in overdraw mode (csrc/megakernel.cu)."""
    return plan.surfaces and not plan.cull and not plan.exact


def _longest_first(pixf: torch.Tensor, out: torch.Tensor) -> None:
    """Order the next launch's blocks longest first (on the device, in
    place): lane 0 of entry b of the layout's pad row gets 1 + the tile
    with the b-th most bounce iterations in `out` (row 4, which every lane
    of an overdraw tile shares). A launch's tiles are the same in any
    order, bit for bit; started first, the longest tiles no longer run
    alone on a few SMs at the end of the launch (PERF.md §6: the grid
    tail). The order carries from launch to launch of one layout."""
    order = torch.argsort(out[:, 4, 0], descending=True, stable=True)
    pixf[:, 3, 0] = order.to(pixf.dtype) + 1.0


def table_tensors(tabs, scene: st.Scene, plan: MegaPlan, device) -> tuple:
    """`build_tables`' host tables (and the scene's texels) as the launch's
    tensors on `device`, in the kernel's argument order after pixf."""
    sph, attr, rect, light, med, cam, meta = tabs
    images = (scene.textures.images if plan.img_hw
              else np.zeros((1, 1, 1, 3), np.float32))
    return (*(torch.from_numpy(a).to(device)
              for a in (cam, sph, attr, meta["clus_tab"], rect, light, med)),
            *_noise.noise_tables(str(device)),
            torch.from_numpy(np.ascontiguousarray(images, np.float32))
            .to(device))


# ---------------------------------------------------------------------------
# The plain PyTorch version of the kernel
# ---------------------------------------------------------------------------

# state rows of the plain version (R_BLK: swept cluster blocks, R_NEED:
# clusters the lane's own ray needed)
(R_OX, R_OY, R_OZ, R_DX, R_DY, R_DZ, R_TIME, R_TPX, R_TPY, R_TPZ,
 R_RX, R_RY, R_RZ, R_AX, R_AY, R_AZ, R_SEGS, R_DEPTH, R_DONE,
 R_ITERS, R_BLK, R_NEED) = range(22)
STATE_ROWS = 22

# (sphere block) x (lanes) elements per sweep step of the plain version,
# and (cluster or cluster slot) x (lanes) elements per culled chunk
_SWEEP_ELEMS = 1 << 24
_CULL_ELEMS = 1 << 22
# the culled sweep's constants, as the JAX kernel's: the slab-entry
# shrink float32(1 - 2.4e-7) of the re-vote, and the survivor cut of the
# near-to-far order (a cluster whose key is past it cannot win: 0.5 BIG
# is beyond the miss cut)
_SHRINK = float(np.float32(1.0 - 2.4e-7))
_SURV_CUT = float(np.float32(0.5 * BIG))


def _check_seed(seed: int) -> int:
    seed = int(seed)
    if not -(1 << 31) <= seed < (1 << 31):
        raise ValueError(f"seed {seed} does not fit in int32")
    return seed


def _f32(x) -> float:
    """A scalar rounded to float32 (host-side float32 arithmetic)."""
    return float(np.float32(x))


_INV_PI = _f32(1.0 / math.pi)
_TWO_PI = _f32(2.0 * math.pi)


def _div(a, x: torch.Tensor) -> torch.Tensor:
    """a / x with one rounding (torch evaluates `float / tensor` as
    x.reciprocal() * a, two roundings); a is a float or a tensor."""
    if isinstance(a, torch.Tensor):
        return a / x
    return torch.full_like(x, a) / x


def _sqrt0(x: torch.Tensor) -> torch.Tensor:
    """sqrt(max(x, 0)) with a finite gradient everywhere: where x <= 0 the
    value is 0 and no gradient flows, so a masked-off lane cannot turn a
    zero cotangent into 0 * inf = NaN under autograd."""
    pos = x > 0.0
    return torch.where(pos, torch.sqrt(torch.where(pos, x, 1.0)), 0.0)


def _rotate_y_inv(cth, sth, x, z):
    """World -> object rotation about y of the (x, z) pair, with the FMAs
    XLA contracts in the JAX kernel (the first product of each sum)."""
    return _fma(cth, x, -(sth * z)), _fma(sth, x, cth * z)


def trace_mega_reference(pixf: torch.Tensor, cam_vec: torch.Tensor,
                         sph_tab: torch.Tensor, attr_tab: torch.Tensor,
                         clus_tab: torch.Tensor, rect_tab: torch.Tensor,
                         light_tab: torch.Tensor, med_tab: torch.Tensor,
                         perm: torch.Tensor, ranvec: torch.Tensor,
                         images: torch.Tensor, seed: int,
                         plan: MegaPlan,
                         tape: Optional[torch.Tensor] = None,
                         need_hist: Optional[torch.Tensor] = None
                         ) -> torch.Tensor:
    """The plain PyTorch version of the megakernel, with the arguments of
    `mega_kernel`: pixf (n_tiles, 4, T), cam_vec (1, 128), sph_tab (S, 128),
    attr_tab (24, S), clus_tab (C, 128), rect_tab (max(R, 1), 128),
    light_tab (max(L, 1), 128) and med_tab (max(V, 1), 128), ranvec
    (256, 3) and images (n_img, Hmax, Wmax, 3) float32, perm (256,) int32,
    on one device; seed an int32. Returns out (n_tiles, 8 + n_iters, T)
    float32.

    Vectorised over the lanes of every tile still running, with a Python
    loop over bounce iterations, in the op order of the JAX kernel. A tile
    runs until its slowest lane has `spp` samples (overdraw: all its valid
    lanes trace on; exact mode: finished lanes idle); lanes of a finished
    tile freeze. A culled plan sweeps as the culled kernel does, warp by
    warp of 32 lanes, so row 6 counts the same swept blocks and row 7 the
    same needed ones; `need_hist`, a (33,) int64 tensor on the device,
    then gains one at k for each swept warp visit that k lanes needed
    (`visits_by_branch` splits it at K_BCAST).

    With `tape` ((n_tiles, n_iters, T) winner codes of an exact-mode
    launch) it replays that launch instead (ops/mega_grad.py): each
    bounce's winner comes from the tape, only the winner's hit distance is
    recomputed (the taped sphere slot's root, the taped rect's plane, the
    taped medium's scatter distance), and every tile runs all n_iters
    iterations out of place, so autograd differentiates the sums w.r.t.
    every table. The arithmetic is the plain version's op for op; the
    square roots and the rect-light pdf are written so that masked lanes
    keep finite gradients, which changes no value a live lane reads."""
    seed = _check_seed(seed)
    if tape is not None and not (plan.exact and plan.rr_depth is None):
        raise ValueError("a tape replays an exact-spp launch without "
                         "Russian roulette")
    dev = pixf.device
    f32 = torch.float32
    n_tiles, _, T = pixf.shape
    S, R, L, V = plan.S, plan.R, plan.L, plan.V
    spp = float(plan.spp)
    t_min = plan.t_min

    # camera lanes and table rows as 0-d tensors: float32 arithmetic with
    # the values a launch reads, differentiable w.r.t. the tables
    cam = cam_vec.reshape(-1)
    c_ox, c_oy, c_oz = cam[CAM_OX], cam[CAM_OY], cam[CAM_OZ]
    c_llx, c_lly, c_llz = cam[CAM_LLX], cam[CAM_LLY], cam[CAM_LLZ]
    c_hx, c_hy, c_hz = cam[CAM_HX], cam[CAM_HY], cam[CAM_HZ]
    c_vx, c_vy, c_vz = cam[CAM_VX], cam[CAM_VY], cam[CAM_VZ]
    c_ux, c_uy, c_uz = cam[CAM_UX], cam[CAM_UY], cam[CAM_UZ]
    c_vvx, c_vvy, c_vvz = cam[CAM_WX], cam[CAM_WY], cam[CAM_WZ]
    c_lens, c_t0 = cam[CAM_LENS], cam[CAM_T0]
    c_dt = cam[CAM_T1] - c_t0
    inv_nx = _f32(1.0 / plan.nx)
    inv_ny = _f32(1.0 / plan.ny)

    # sweep columns (S, 1) and the attribute table with a zero miss column
    col = {ln: sph_tab[:, ln:ln + 1] for ln in SWEEP_LANES}
    attr_ext = torch.cat([attr_tab, torch.zeros((A_ROWS, 1), dtype=f32,
                                                device=dev)], dim=1)
    # rect / medium rows with a zero row for "none"; per-row scalars
    rect_ext = torch.cat([rect_tab[:R], torch.zeros((1, RECT_LANES),
                                                    dtype=f32, device=dev)])
    med_ext = torch.cat([med_tab[:V], torch.zeros((1, MED_LANES), dtype=f32,
                                                  device=dev)])
    rect_rows = list(rect_tab[:R])
    rect_keys = rect_tab[:R, :RT_IDB + 1].tolist()   # transform groups
    img_hw = torch.tensor(plan.img_hw or ((1, 1),), device=dev)
    light_rows = list(light_tab[:L])
    med_rows = list(med_tab[:V])
    lane_ids = torch.arange(T, dtype=torch.int64, device=dev)

    def gen_rays(it, tiles, pxi, pxj):
        """Fresh jittered camera rays (camera.h:36-50), salt 1."""
        base = _stream_base(seed, tiles, it, 1, lane_ids).reshape(-1)
        s = (pxi + _uniform_row(base, 0)) * inv_nx
        t = (pxj + _uniform_row(base, 1)) * inv_ny
        time = _fma(_uniform_row(base, 2), c_dt, c_t0)
        if plan.lens:
            r = c_lens * torch.sqrt(_uniform_row(base, 3))
            cph, sph2 = _cossin2pi(_uniform_row(base, 4))
            rdx = r * cph
            rdy = r * sph2
            offx = _fma(c_ux, rdx, c_vvx * rdy)
            offy = _fma(c_uy, rdx, c_vvy * rdy)
            offz = _fma(c_uz, rdx, c_vvz * rdy)
        else:
            offx = offy = offz = torch.zeros_like(s)
        ox = c_ox + offx
        oy = c_oy + offy
        oz = c_oz + offz
        dx = _fma(t, c_vx, _fma(s, c_hx, c_llx)) - ox
        dy = _fma(t, c_vy, _fma(s, c_hy, c_lly)) - oy
        dz = _fma(t, c_vz, _fma(s, c_hz, c_llz)) - oz
        inv = _rsqrt(_fma(dz, dz, _fma(dx, dx, dy * dy)))
        return ox, oy, oz, dx * inv, dy * inv, dz * inv, time

    # float64 copies of the sweep columns: with float32 operands,
    # addcmul(c, a, b) in float64 is a * b + c with one rounding, so
    # `addcmul(...).float()` is `_fma` without re-converting its operands
    col64 = {ln: c.double() for ln, c in col.items()}

    def quad(cb, cb64, o, dy, dx64, dz64, time, frac64, guard=None):
        """The closest root > t_min (BIG on a miss) of each (slot, lane)
        pair: the sign-flipped half-b quadratic with a = 1 (unit
        directions). cb / cb64 map a sweep lane to its slot columns in
        float32 / float64, broadcastable against the (1, n) rays o, dy,
        dx64, dz64 and time; frac64 is the uniform shutter's motion
        fraction (float64), else None. Lanes off `guard` take disc = 1
        (a replay's non-sphere lanes: finite gradients)."""
        if any(plan.moving_axes) and not plan.uniform_time:
            frac64 = ((time - cb[C_T0]) * cb[C_IDT]).double()
        co = []
        for ax, (lc, ldc) in enumerate(((C_CX, C_DCX), (C_CY, C_DCY),
                                        (C_CZ, C_DCZ))):
            c = cb[lc]
            if plan.moving_axes[ax]:
                c = torch.addcmul(cb64[lc], frac64, cb64[ldc]).float()
            co.append(c - o[ax])
        cox64, coy64, coz64 = (c.double() for c in co)
        nb = torch.addcmul((co[1] * dy).double(), cox64, dx64).float()
        nb64 = torch.addcmul(nb.double(), coz64, dz64).float().double()
        cc = torch.addcmul(cb64[C_NR2], coz64, coz64).float()
        cc = torch.addcmul(cc.double(), coy64, coy64).float()
        cc = torch.addcmul(cc.double(), cox64, cox64).float()
        disc = torch.addcmul(cc.double().neg(), nb64, nb64).float()
        if guard is not None:
            disc = torch.where(guard, disc, 1.0)
        nb = nb64.float()
        # disc < 0 and disc == 0 both give NaN, a subnormal disc +inf (the
        # flush): a miss
        sq = disc * _rsqrt_ftz(disc)
        tf = (nb + sq).masked_fill_(~((nb + sq) > t_min), BIG)
        tn = nb - sq
        return torch.where(tn > t_min, tn, tf)

    def sweep(ox, oy, oz, dx, dy, dz, time):
        """Closest hit over every slot: (best_t, winner slot; S on miss).
        The winner is the first slot with the strictly smallest t."""
        n = ox.numel()
        best = torch.full((n,), BIG, dtype=f32, device=dev)
        bidx = torch.full((n,), S, dtype=torch.int64, device=dev)
        if not plan.has_spheres:
            return best, bidx
        eb = max(1, min(S, _SWEEP_ELEMS // max(n, 1)))
        orig = (ox[None], oy[None], oz[None])
        dx64, dz64 = dx.double()[None], dz.double()[None]
        frac64 = (((time - plan.ut_t0) * plan.ut_idt).double()[None]
                  if plan.uniform_time else None)
        for lo in range(0, S, eb):
            hi = min(S, lo + eb)
            tcv = quad({k: v[lo:hi] for k, v in col.items()},
                       {k: v[lo:hi] for k, v in col64.items()},
                       orig, dy[None], dx64, dz64, time[None], frac64)
            # min over dim 0 returns the first index of the smallest value
            blk_min, cand = tcv.min(dim=0)
            upd = blk_min < best
            bidx = torch.where(upd, cand + lo, bidx)
            best = torch.minimum(best, blk_min)
        return best, bidx

    boxes = clus_tab[:, K_MINX:K_MAXZ + 1].t()          # (6, C)
    t_min_t = torch.tensor(t_min, dtype=f32, device=dev)
    # the slot columns the culled sweep gathers
    cull_lanes = [C_CX, C_CY, C_CZ, C_NR2]
    if any(plan.moving_axes):
        cull_lanes += [C_DCX, C_DCY, C_DCZ]
        if not plan.uniform_time:
            cull_lanes += [C_T0, C_IDT]
    sph_cols = {ln: sph_tab[:, ln] for ln in cull_lanes}

    def slab(box, o, inv_d):
        """Slab entry and exit (tlo >= t_min, thi) of rays o + t d against
        AABBs box (6, ...) broadcast against the rays; NaN-propagating
        min / max, as the JAX kernel's."""
        t0 = [(box[a] - o[a]) * inv_d[a] for a in range(3)]
        t1 = [(box[3 + a] - o[a]) * inv_d[a] for a in range(3)]
        tlo = torch.maximum(
            torch.maximum(torch.minimum(t0[0], t1[0]),
                          torch.minimum(t0[1], t1[1])),
            torch.maximum(torch.minimum(t0[2], t1[2]), t_min_t))
        thi = torch.minimum(torch.minimum(torch.maximum(t0[0], t1[0]),
                                          torch.maximum(t0[1], t1[1])),
                            torch.maximum(t0[2], t1[2]))
        return tlo, thi

    def sweep_culled(ox, oy, oz, dx, dy, dz, time, active, inc):
        """The culled kernel's sweep, warp by warp (32 consecutive lanes):
        visit the clusters in ascending id, or near to far in
        `plan.dyn_order` buckets of the warp's smallest geometric slab
        entry (stable in id within a bucket; no bucket for a cluster no
        active lane reaches); re-vote each against the lanes' running
        best: a lane needs it when it is active and its ray enters the box
        before its best, the warp visits it when one lane needs it, and
        sweeps it for the needing lanes. Returns (best_t, winner slot,
        swept-block increments per lane (every lane of a visiting warp),
        needed-block increments per lane)."""
        n = ox.numel()
        best = torch.full((n,), BIG, dtype=f32, device=dev)
        bidx = torch.full((n,), S, dtype=torch.int64, device=dev)
        blocks = torch.zeros((n,), dtype=f32, device=dev)
        needed = torch.zeros((n,), dtype=f32, device=dev)
        C, SB, NB = plan.C, plan.SB, plan.dyn_order
        # whole warps per chunk, so the (C or SB, lanes) blocks stay small
        step = 32 * max(1, _CULL_ELEMS // (32 * max(C, SB)))
        j_slot = torch.arange(SB, device=dev)[:, None]
        cid = torch.arange(C, device=dev)[:, None]
        for lo in range(0, n, step):
            sl = slice(lo, min(n, lo + step))
            o = (ox[sl], oy[sl], oz[sl])
            inv_d = (1.0 / dx[sl], 1.0 / dy[sl], 1.0 / dz[sl])
            act = active[sl]
            m, W = act.numel(), act.numel() // 32
            tlo, thi = slab(boxes[:, :, None], o, inv_d)      # (C, m)
            if NB:
                key = torch.where((tlo <= thi) & act, tlo, BIG).view(
                    C, W, 32).amin(-1)                       # (C, W)
                surv = key < _SURV_CUT
                kmin = key.amin(0)
                kmax = torch.where(surv, key, -BIG).amax(0)
                scale = _div(float(NB), torch.clamp_min(kmax - kmin,
                                                        _f32(1e-20)))
                bucket = torch.where(
                    surv, torch.clamp((key - kmin) * scale, 0.0,
                                      float(NB - 1)).to(torch.int64), NB)
                order = torch.sort(bucket * C + cid, dim=0).indices
                n_vis = surv.sum(0)
            else:
                order = cid.expand(C, W)
                n_vis = torch.full((W,), C, device=dev)
            b_ = best[sl]
            bi_ = bidx[sl]
            bl_ = blocks[sl]
            nd_ = needed[sl]
            for r in range(int(n_vis.max()) if W else 0):
                cl = order[r].repeat_interleave(32)           # (m,)
                lo_l = tlo.gather(0, cl[None])[0]
                hi_l = thi.gather(0, cl[None])[0]
                need = ((lo_l <= hi_l) & (lo_l * _SHRINK < b_) & act
                        & (r < n_vis).repeat_interleave(32))
                nk = need.view(W, 32).sum(1)                  # (W,)
                if need_hist is not None:
                    need_hist.add_(torch.bincount(nk[nk > 0], minlength=33))
                bl_ += torch.where((nk > 0).repeat_interleave(32), inc[sl],
                                   0.0)
                nd_ += need.to(f32)
                lanes = need.nonzero().squeeze(1)
                if lanes.numel() == 0:
                    continue
                slots = cl[lanes][None] * SB + j_slot          # (SB, k)
                cb = {k: v[slots] for k, v in sph_cols.items()}
                tm = time[sl][lanes][None]
                frac64 = (((tm - plan.ut_t0) * plan.ut_idt).double()
                          if plan.uniform_time else None)
                tcv = quad(cb, {k: v.double() for k, v in cb.items()},
                           tuple(c[lanes][None] for c in o),
                           dy[sl][lanes][None],
                           dx[sl][lanes].double()[None],
                           dz[sl][lanes].double()[None], tm, frac64)
                blk_min, cand = tcv.min(dim=0)
                upd = blk_min < b_[lanes]
                bi_[lanes] = torch.where(upd, cl[lanes] * SB + cand,
                                         bi_[lanes])
                b_[lanes] = torch.minimum(b_[lanes], blk_min)
        return best, bidx, blocks, needed

    def object_ray(code_tr, row, o, d, lanes):
        """A ray in a rect's, light's or medium's object space (translate,
        then rotate_y, undone); code_tr = rotated | translated << 1 and
        lanes name cos, sin, offx, offy, offz in the row."""
        rot, trn = code_tr & 1, code_tr >> 1 & 1
        ox, oy, oz = o
        dx, dy, dz = d
        if rot:
            cth, sth = row[lanes[0]], row[lanes[1]]
            sx = ox - row[lanes[2]]
            ry = oy - row[lanes[3]]
            sz = oz - row[lanes[4]]
            rx, rz = _rotate_y_inv(cth, sth, sx, sz)
            ex, ez = _rotate_y_inv(cth, sth, dx, dz)
            return (rx, ry, rz), (ex, dy, ez)
        if trn:
            return (ox - row[lanes[2]], oy - row[lanes[3]],
                    oz - row[lanes[4]]), d
        return o, d

    def reciprocals(code_tr, d, inv_d):
        """1/d of an object-space direction: rotate_y leaves y alone and
        translate the whole direction, so only a rotation pays."""
        if code_tr & 1:
            return 1.0 / d[0], inv_d[1], 1.0 / d[2]
        return inv_d

    _RT_TF = (RT_COS, RT_SIN, RT_OFFX, RT_OFFY, RT_OFFZ)
    _LT_TF = (LT_COS, LT_SIN, LT_OFFX, LT_OFFY, LT_OFFZ)
    _MD_TF = (MD_COS, MD_SIN, MD_OFFX, MD_OFFY, MD_OFFZ)

    def rect_hit(o, d, inv_d, forced=None):
        """Closest rect (hittable.h:142-267, baked flip / rotate_y /
        translate): (t, winner row; R when none, the winner's planar uv
        when the launch reads images). The first rect with the strictly
        smallest t wins; a replay passes the taped row (`forced`, -1 for
        none) instead."""
        rb_t = torch.full_like(o[0], BIG)
        rwin = torch.full(o[0].shape, R, dtype=torch.int64, device=dev)
        r_u = r_v = None
        if plan.img_hw:
            r_u, r_v = torch.zeros_like(rb_t), torch.zeros_like(rb_t)
        groups = {}
        for ri, row in enumerate(rect_rows):
            code = plan.rect_codes[ri]
            key = (code >> 2, *(rect_keys[ri][k] for k in _RT_TF))
            if key not in groups:   # one object-space ray per transform
                ro, rd = object_ray(code >> 2, row, o, d, _RT_TF)
                groups[key] = ro, rd, reciprocals(code >> 2, rd, inv_d)
            ro, rd, ir = groups[key]
            ax = code & 3
            # XY: plane z = k; XZ: plane y = k; YZ: plane x = k
            ia, ib, i_n = ((0, 1, 2), (0, 2, 1), (1, 2, 0))[ax]
            # d_n == 0 gives t = +-inf or NaN: every comparison then fails
            t_r = (row[RT_K] - ro[i_n]) * ir[i_n]
            pa = _fma(t_r, rd[ia], ro[ia])
            pb = _fma(t_r, rd[ib], ro[ib])
            if forced is None:
                ok = ((t_r > t_min) & (t_r < rb_t)
                      & (pa >= row[RT_A0]) & (pa <= row[RT_A1])
                      & (pb >= row[RT_B0]) & (pb <= row[RT_B1]))
            else:
                ok = forced == ri
            rb_t = torch.where(ok, t_r, rb_t)
            rwin = torch.where(ok, ri, rwin)
            if r_u is not None:   # uv = planar offset / extent
                r_u = torch.where(ok, (pa - row[RT_A0]) * row[RT_IDA], r_u)
                r_v = torch.where(ok, (pb - row[RT_B0]) * row[RT_IDB], r_v)
        return rb_t, rwin, r_u, r_v

    def media_hit(o, d, inv_d, tiles, it, forced=None):
        """Closest constant-medium scatter distance (hittable.h:430-479):
        t_in - log(u) / density inside the boundary, salt 4, one row per
        medium. Returns (t, winner row; V when none); a replay passes the
        taped row (`forced`, -1 for none)."""
        base = _stream_base(seed, tiles, it, 4, lane_ids).reshape(-1)
        md_t = torch.full_like(o[0], BIG)
        mwin = torch.full(o[0].shape, V, dtype=torch.int64, device=dev)
        for vi, row in enumerate(med_rows):
            code = plan.med_codes[vi]
            mo, md = object_ray(code >> 1, row, o, d, _MD_TF)
            if code & 1 == st.MEDIUM_SPHERE:    # sphere boundary (a = 1)
                ocx = mo[0] - row[MD_P0X]
                ocy = mo[1] - row[MD_P0Y]
                ocz = mo[2] - row[MD_P0Z]
                bq = _fma(ocz, md[2], _fma(ocx, md[0], ocy * md[1]))
                rq2 = row[MD_P1X] * row[MD_P1X]
                ccq = _fma(ocz, ocz, _fma(ocx, ocx, ocy * ocy)) - rq2
                dq = _fma(bq, bq, -ccq)
                sqq = _sqrt0(dq)
                m_in = -bq - sqq
                m_out = -bq + sqq
                m_bh = dq > 0.0
            else:   # box boundary: the signed-range slab (aabb.h:17-47)
                iv = reciprocals(code >> 1, md, inv_d)
                t0 = [(row[MD_P0X + a] - mo[a]) * iv[a] for a in range(3)]
                t1 = [(row[MD_P1X + a] - mo[a]) * iv[a] for a in range(3)]
                lo = [torch.minimum(a, b) for a, b in zip(t0, t1)]
                hi = [torch.maximum(a, b) for a, b in zip(t0, t1)]
                m_in = torch.maximum(torch.maximum(lo[0], lo[1]), lo[2])
                m_out = torch.minimum(torch.minimum(hi[0], hi[1]), hi[2])
                m_bh = m_out > m_in
            m_in = torch.maximum(m_in, torch.full_like(m_in, t_min))
            u = torch.clamp_min(_uniform_row(base, vi), 1e-38)
            tci = _fma(row[MD_NIRHO], torch.log(u), m_in)
            ok = (m_bh & (m_in < m_out) & (tci < m_out) & (tci < md_t)
                  if forced is None else forced == vi)
            md_t = torch.where(ok, tci, md_t)
            mwin = torch.where(ok, vi, mwin)
        return md_t, mwin

    def light_dirs(ul, p):
        """One-sample MIS (RayTracingWeekend.cpp:117-124, pdf.h:55-75):
        the direction toward the picked light (li <= u0 * L < li + 1;
        uniform point on a rect light, cone sample of a sphere light)."""
        px_, py_, pz_ = p
        pickf = ul[0] * float(L)
        ld = [torch.zeros_like(px_) for _ in range(3)]
        for li, row in enumerate(light_rows):
            code = plan.light_codes[li]
            if code & 1 == st.LIGHT_RECT:
                pa_s = _fma(ul[1], row[LT_A1] - row[LT_A0], row[LT_A0])
                pb_s = _fma(ul[2], row[LT_B1] - row[LT_B0], row[LT_B0])
                kk = row[LT_K].expand_as(px_)
                ppx, ppy, ppz = ((pa_s, pb_s, kk), (pa_s, kk, pb_s),
                                 (kk, pa_s, pb_s))[code >> 1 & 3]
                if code >> 3 & 1:   # object -> world: Ry(theta)
                    cth, sth = row[LT_COS], row[LT_SIN]
                    ppx, ppz = (_fma(cth, ppx, sth * ppz),
                                _fma(cth, ppz, -(sth * ppx)))
                if code >> 4 & 1:
                    ppx = ppx + row[LT_OFFX]
                    ppy = ppy + row[LT_OFFY]
                    ppz = ppz + row[LT_OFFZ]
                dl = (ppx - px_, ppy - py_, ppz - pz_)
            else:   # sphere.h:101-108, utility.h:69-82
                tcx = row[LT_CX] - px_
                tcy = row[LT_CY] - py_
                tcz = row[LT_CZ] - pz_
                dist2 = _fma(tcz, tcz, _fma(tcx, tcx, tcy * tcy))
                rad2 = row[LT_RAD] * row[LT_RAD]
                ctm = _sqrt0(1.0 - _div(rad2, torch.clamp_min(dist2, 1e-20)))
                zc = _fma(ul[2], ctm - 1.0, 1.0)
                cpl, spl = _cossin2pi(ul[1])
                sc = _sqrt0(_fma(-zc, zc, 1.0))
                winv = _rsqrt(torch.clamp_min(dist2, 1e-20))
                wlx, wly, wlz = tcx * winv, tcy * winv, tcz * winv
                lux, luy, luz, lvx, lvy, lvz = _onb(wlx, wly, wlz)
                cph = cpl * sc
                sph_ = spl * sc
                dl = (_fma(zc, wlx, _fma(cph, lux, sph_ * lvx)),
                      _fma(zc, wly, _fma(cph, luy, sph_ * lvy)),
                      _fma(zc, wlz, _fma(cph, luz, sph_ * lvz)))
            if L == 1:
                ld = list(dl)
            else:
                sel = (pickf >= float(li)) & (pickf < float(li + 1))
                ld = [torch.where(sel, a, b) for a, b in zip(dl, ld)]
        return ld

    def light_pdf(p, mu):
        """hittable_list::pdf_value over the lights list: the sum of each
        light's solid-angle pdf along unit direction mu (hittable.h:208-222,
        sphere.h:88-99)."""
        px_, py_, pz_ = p
        mux, muy, muz = mu
        acc = torch.zeros_like(px_)
        for li, row in enumerate(light_rows):
            code = plan.light_codes[li]
            if code & 1 == st.LIGHT_RECT:
                q, w = object_ray(code >> 3, row, p, mu, _LT_TF)
                ia, ib, i_n = ((0, 1, 2), (0, 2, 1), (1, 2, 0))[code >> 1 & 3]
                # a probe (near) parallel to the plane misses it; its t is
                # kept finite, and |t| <= 1e9 holds every reachable hit
                wn_ok = w[i_n].abs() > 1e-20
                t_l = torch.clamp((row[LT_K] - q[i_n])
                                  / torch.where(wn_ok, w[i_n], 1.0),
                                  -1e9, 1e9)
                hpa = _fma(t_l, w[ia], q[ia])
                hpb = _fma(t_l, w[ib], q[ib])
                lh = (wn_ok & (t_l > t_min)
                      & (hpa >= row[LT_A0]) & (hpa <= row[LT_A1])
                      & (hpb >= row[LT_B0]) & (hpb <= row[LT_B1]))
                # unit probe direction: dist^2 = t^2, cosine = |d_n|
                pdf_l = (t_l * t_l) / torch.clamp_min(
                    w[i_n].abs() * row[LT_AREA], 1e-20)
            else:
                ocx = px_ - row[LT_CX]
                ocy = py_ - row[LT_CY]
                ocz = pz_ - row[LT_CZ]
                rad2 = row[LT_RAD] * row[LT_RAD]
                b_l = _fma(ocz, muz, _fma(ocx, mux, ocy * muy))
                d2l = _fma(ocz, ocz, _fma(ocx, ocx, ocy * ocy))
                cc_l = d2l - rad2
                disc_l = _fma(b_l, b_l, -cc_l)
                sq_l = _sqrt0(disc_l)
                tn_l = -b_l - sq_l
                t_l = torch.where(tn_l > t_min, tn_l, -b_l + sq_l)
                lh = (disc_l > 0.0) & (t_l > t_min)
                ctm = _sqrt0(1.0 - _div(rad2, torch.clamp_min(d2l, 1e-20)))
                solid = _TWO_PI * (1.0 - ctm)
                pdf_l = 1.0 / torch.clamp_min(solid, 1e-20)
            acc = acc + torch.where(lh, pdf_l, 0.0)
        return acc

    def texture_albedo(tx, p, uv, alb):
        """The albedo with the winner's texture applied, in the JAX
        kernel's order (a later override wins): Perlin noise
        (texture.h:55-69, on the lanes that need it), checker
        (texture.h:35-46), the nearest texel (texture.h:73-98)."""
        albx, alby, albz = alb
        if plan.noise_modes:
            lanes = (tx["noi"] > 0.5).nonzero().squeeze(1)
            mval = torch.zeros(lanes.shape, dtype=f32, device=dev)
            mode = tx["noi"][lanes]
            for m in plan.noise_modes:
                sel = lanes[mode == float(1 + m)]
                q = [c[sel] for c in p]
                sc = tx["nsc"][sel]
                if m == st.NOISE_MARBLE:
                    val = _noise.marble(*q, sc, perm, ranvec)
                elif m == st.NOISE_SMOOTH:   # 0.5 (1 + noise(scale p))
                    val = 0.5 * (1.0 + _noise.perlin_noise(
                        *(c * sc for c in q), perm, ranvec))
                else:                        # turb(scale p)
                    val = _noise.turb(*(c * sc for c in q), perm, ranvec)
                mval[mode == float(1 + m)] = val
            albx, alby, albz = (a.index_put((lanes,), mval)
                                for a in (albx, alby, albz))
        if plan.has_checker:
            sines = (torch.sin(10.0 * p[0]) * torch.sin(10.0 * p[1])
                     * torch.sin(10.0 * p[2]))
            is_chk = tx["chk"] > 0.5
            use_odd = is_chk & (sines < 0.0)
            albx = torch.where(use_odd, tx["odx"],
                               torch.where(is_chk, tx["evx"], albx))
            alby = torch.where(use_odd, tx["ody"],
                               torch.where(is_chk, tx["evy"], alby))
            albz = torch.where(use_odd, tx["odz"],
                               torch.where(is_chk, tx["evz"], albz))
        if uv is not None:   # img = 1 + image id; clipped texel indices
            u_img, v_img = uv
            use_img = tx["img"] > 0.5
            ids = torch.where(use_img, tx["img"] - 1.0, 0.0).to(torch.int64)
            h, w = img_hw[ids].unbind(1)
            i_t = torch.minimum(torch.clamp_min(
                (u_img * w.to(f32)).to(torch.int64), 0), w - 1)
            j_t = torch.minimum(torch.clamp_min(_fma(
                1.0 - v_img, h.to(f32), -0.001).to(torch.int64), 0), h - 1)
            tex = images[ids, j_t, i_t]
            albx = torch.where(use_img, tex[:, 0], albx)
            alby = torch.where(use_img, tex[:, 1], alby)
            albz = torch.where(use_img, tex[:, 2], albz)
        return albx, alby, albz

    sweep_cols = sph_tab[:, list(SWEEP_LANES)].t()     # (9, S)

    def taped_hits(w, o, d, time, tiles, it):
        """A replay's intersection: the tape's winner (w: -1 miss, sphere
        slot, S + rect row, S + R + medium row) and its recomputed hit
        distance. Returns what the sweeps return for it."""
        wi = w.to(torch.int64)
        hit = w >= 0.0
        is_sph = hit & (wi < S)
        use_rect = hit & (wi >= S) & (wi < S + R)
        use_med = hit & (wi >= S + R)
        bidx = torch.where(is_sph, wi, S)
        best_t = torch.ones_like(o[0])    # miss lanes: a finite, unread t
        if plan.has_spheres:
            slot = torch.clamp_max(bidx, S - 1)
            cols = sweep_cols.index_select(1, slot)
            cb = {ln: cols[k] for k, ln in enumerate(SWEEP_LANES)}
            frac64 = (((time - plan.ut_t0) * plan.ut_idt).double()
                      if plan.uniform_time else None)
            t_s = quad(cb, {k: v.double() for k, v in cb.items()}, o, d[1],
                       d[0].double(), d[2].double(), time, frac64,
                       guard=is_sph)
            best_t = torch.where(is_sph, t_s, best_t)
        rwin = torch.where(use_rect, wi - S, R)
        mwin = torch.where(use_med, wi - S - R, V)
        r_u = r_v = None
        if R or V:
            inv_d = (1.0 / d[0], 1.0 / d[1], 1.0 / d[2])
        if R:
            rb_t, _, r_u, r_v = rect_hit(o, d, inv_d, forced=rwin)
            best_t = torch.where(use_rect, rb_t, best_t)
        if V:
            md_t, _ = media_hit(o, d, inv_d, tiles, it, forced=mwin)
            best_t = torch.where(use_med, md_t, best_t)
        return best_t, hit, bidx, use_rect, rwin, r_u, r_v, use_med, mwin

    def one_iter(state, it, tiles, pxi, pxj, valid, w=None):
        (ox, oy, oz, dx, dy, dz, time, tpx, tpy, tpz, rx, ry, rz,
         ax, ay, az, segs, depth, done, iters, blk, nd) = state.unbind(0)
        active = (valid & (done < spp)) if plan.exact else valid
        segs = segs + active.to(f32)

        o, d = (ox, oy, oz), (dx, dy, dz)
        if w is not None:
            (best_t, hit, bidx, use_rect, rwin, r_u, r_v, use_med,
             mwin) = taped_hits(w, o, d, time, tiles, it)
            wcode = w
        else:
            if plan.cull:
                # a lane counts a swept block where it counts an iteration
                s_best, bidx, blk_inc, nd_inc = sweep_culled(
                    ox, oy, oz, dx, dy, dz, time, active,
                    active.to(f32) if plan.exact else torch.ones_like(ox))
                blk = blk + blk_inc
                nd = nd + nd_inc
            else:
                s_best, bidx = sweep(ox, oy, oz, dx, dy, dz, time)
            best_t = s_best
            if R or V:
                inv_d = (1.0 / dx, 1.0 / dy, 1.0 / dz)
            if R:
                rb_t, rwin, r_u, r_v = rect_hit(o, d, inv_d)
                use_rect = rb_t < s_best
                best_t = torch.minimum(s_best, rb_t)
            if V:
                md_t, mwin = media_hit(o, d, inv_d, tiles, it)
                use_med = md_t < best_t
                best_t = torch.minimum(best_t, md_t)
            hit = best_t < _HIT_CUT
            # winner code: -1 miss, [0, S) sphere slot, S + r rect,
            # S + R + v medium
            wcode = (bidx.to(f32) if plan.has_spheres
                     else torch.full_like(best_t, -1.0))
            if R:
                wcode = torch.where(use_rect, (S + rwin).to(f32), wcode)
            if V:
                wcode = torch.where(use_med, (S + R + mwin).to(f32), wcode)
            wcode = torch.where(active & hit, wcode, -1.0)

        px_ = _fma(best_t, dx, ox)
        py_ = _fma(best_t, dy, oy)
        pz_ = _fma(best_t, dz, oz)
        # gathers as index_select: a replay's backward is then index_add
        attrs = attr_ext.index_select(1, bidx)

        # ---- sphere normal ((p - c(t)) / r, sphere.h:56-66) ----
        scx, scy, scz = attrs[A_CX], attrs[A_CY], attrs[A_CZ]
        if plan.moving:
            frac = (time - attrs[A_T0]) * attrs[A_IDT]
            scx = _fma(frac, attrs[A_DCX], scx)
            scy = _fma(frac, attrs[A_DCY], scy)
            scz = _fma(frac, attrs[A_DCZ], scz)
        rinv = attrs[A_RINV]
        nx_ = (px_ - scx) * rinv
        ny_ = (py_ - scy) * rinv
        nz_ = (pz_ - scz) * rinv
        mtype = attrs[A_MTYPE]
        albx, alby, albz = attrs[A_ALBX], attrs[A_ALBY], attrs[A_ALBZ]
        fuzz = ridx = attrs[A_MPARAM]   # metal fuzz or dielectric IOR
        if R:   # the rect winner's baked normal and material
            rrow = rect_ext.index_select(0, rwin).t()
            nx_ = torch.where(use_rect, rrow[RT_NX], nx_)
            ny_ = torch.where(use_rect, rrow[RT_NY], ny_)
            nz_ = torch.where(use_rect, rrow[RT_NZ], nz_)
            mtype = torch.where(use_rect, rrow[RT_MTYPE], mtype)
            albx = torch.where(use_rect, rrow[RT_ALBX], albx)
            alby = torch.where(use_rect, rrow[RT_ALBY], alby)
            albz = torch.where(use_rect, rrow[RT_ALBZ], albz)
            fuzz = torch.where(use_rect, rrow[RT_FUZZ], fuzz)
            ridx = torch.where(use_rect, rrow[RT_RIDX], ridx)
        if V:   # medium scatter vertex: isotropic, albedo of the medium
            mrow = med_ext.index_select(0, mwin).t()
            mtype = torch.where(use_med, float(st.MAT_ISOTROPIC), mtype)
            albx = torch.where(use_med, mrow[MD_ALBX], albx)
            alby = torch.where(use_med, mrow[MD_ALBY], alby)
            albz = torch.where(use_med, mrow[MD_ALBZ], albz)
        if plan.textures:
            # the winner's texture lanes (sphere attributes, then the rect
            # and medium winners'); a medium carries no checker
            tx = {k: attrs[r] for k, r in (
                ("noi", A_NOISE), ("nsc", A_NSCALE), ("chk", A_CHK),
                ("img", A_IMG), ("evx", A_EVENX), ("evy", A_EVENY),
                ("evz", A_EVENZ), ("odx", A_ODDX), ("ody", A_ODDY),
                ("odz", A_ODDZ))}
            if R:
                for k, r in (("noi", RT_NOI), ("nsc", RT_NSC),
                             ("chk", RT_CHK), ("img", RT_IMG),
                             ("evx", RT_EVENX), ("evy", RT_EVENY),
                             ("evz", RT_EVENZ), ("odx", RT_ODDX),
                             ("ody", RT_ODDY), ("odz", RT_ODDZ)):
                    tx[k] = torch.where(use_rect, rrow[r], tx[k])
            if V:
                for k, r in (("noi", MD_NOI), ("nsc", MD_NSC),
                             ("img", MD_IMG)):
                    tx[k] = torch.where(use_med, mrow[r], tx[k])
                tx["chk"] = torch.where(use_med, 0.0, tx["chk"])
            uv = None
            if plan.img_hw:
                # sphere uv from the unit normal (sphere.h:115-122); rects
                # take their planar uv, media uv = (0, 0)
                phi = _atan2(nz_, nx_)
                theta = _asin(ny_)
                u_img = _fma(-(phi + _f32(_PI_UV)), 0.5 / _PI_UV, 1.0)
                v_img = (theta + _f32(0.5 * _PI_UV)) * _f32(1.0 / _PI_UV)
                if R:
                    u_img = torch.where(use_rect, r_u, u_img)
                    v_img = torch.where(use_rect, r_v, v_img)
                if V:
                    u_img = torch.where(use_med, 0.0, u_img)
                    v_img = torch.where(use_med, 0.0, v_img)
                uv = u_img, v_img
            albx, alby, albz = texture_albedo(tx, (px_, py_, pz_), uv,
                                              (albx, alby, albz))

        base = _stream_base(seed, tiles, it, 2, lane_ids).reshape(-1)
        u = [_uniform_row(base, r) for r in range(7)]

        # ---- lambertian: cosine sample about the normal ----
        r2 = u[1]
        z = torch.sqrt(torch.clamp_min(1.0 - r2, 0.0))
        sq_ = torch.sqrt(r2)
        cphi, sphi = _cossin2pi(u[0])
        lx_t = cphi * sq_
        ly_t = sphi * sq_
        ux_, uy_, uz_, vx, vy, vz = _onb(nx_, ny_, nz_)
        lamx = _fma(z, nx_, _fma(lx_t, ux_, ly_t * vx))
        lamy = _fma(z, ny_, _fma(lx_t, uy_, ly_t * vy))
        lamz = _fma(z, nz_, _fma(lx_t, uz_, ly_t * vz))
        lam_ok = z > 0.0
        lam_w = None
        if L:
            # ---- one-sample MIS: mixture(cosine pdf, lights pdf), salt 3
            base3 = _stream_base(seed, tiles, it, 3, lane_ids).reshape(-1)
            ul = [_uniform_row(base3, r) for r in range(4)]
            p = (px_, py_, pz_)
            ldx, ldy, ldz = light_dirs(ul, p)
            coin_l = ul[3] < 0.5   # pdf.h:69-75
            mdx = torch.where(coin_l, lamx, ldx)
            mdy = torch.where(coin_l, lamy, ldy)
            mdz = torch.where(coin_l, lamz, ldz)
            minv = _rsqrt(torch.clamp_min(
                _fma(mdz, mdz, _fma(mdx, mdx, mdy * mdy)), 1e-30))
            mu = (mdx * minv, mdy * minv, mdz * minv)
            cosi = _fma(mu[2], nz_, _fma(mu[0], nx_, mu[1] * ny_))
            cpdf = torch.where(cosi <= 0.0, 0.0, cosi * _INV_PI)
            acc = light_pdf(p, mu)
            pdf_val = _fma(0.5, cpdf, 0.5 * acc * _f32(1.0 / L))
            lam_ok = pdf_val > 0.0
            # weight = albedo * scattering_pdf / pdf_val (material.h:115-119)
            lam_w = torch.where(lam_ok,
                                cpdf / torch.where(lam_ok, pdf_val, 1.0), 0.0)
            lamx, lamy, lamz = mdx, mdy, mdz

        # ---- mirror reflection (metal and dielectric) ----
        ddn = _fma(dz, nz_, _fma(dx, nx_, dy * ny_))
        rfx = _fma(-2.0 * ddn, nx_, dx)
        rfy = _fma(-2.0 * ddn, ny_, dy)
        rfz = _fma(-2.0 * ddn, nz_, dz)

        # ---- point in the unit ball: metal fuzz and isotropic scatter ----
        zb = 1.0 - 2.0 * u[2]
        rb = torch.sqrt(torch.clamp_min(_fma(-zb, zb, 1.0), 0.0))
        cpb, spb = _cossin2pi(u[3])
        radb = torch.exp(torch.log(torch.clamp_min(u[4], 1e-30))
                         * (1.0 / 3.0))
        ballx = rb * cpb * radb
        bally = rb * spb * radb
        ballz = zb * radb
        mex = _fma(fuzz, ballx, rfx)
        mey = _fma(fuzz, bally, rfy)
        mez = _fma(fuzz, ballz, rfz)

        # ---- dielectric with the corrected exit cosine (material.h) ----
        inside = ddn > 0.0
        sgn = torch.where(inside, -1.0, 1.0)
        onx = sgn * nx_
        ony = sgn * ny_
        onz = sgn * nz_
        nint = torch.where(inside, ridx, 1.0 / torch.clamp_min(ridx, 1e-6))
        cos_exit2 = _fma(-(ridx * ridx), _fma(-ddn, ddn, 1.0), 1.0)
        cos_exit = _sqrt0(cos_exit2)
        cosine = torch.where(inside, cos_exit, -ddn)
        dt = _fma(dz, onz, _fma(dx, onx, dy * ony))
        disc_r = _fma(-(nint * nint), _fma(-dt, dt, 1.0), 1.0)
        canr = disc_r > 0.0
        sqr = _sqrt0(disc_r)
        refx = _fma(nint, _fma(-onx, dt, dx), -(onx * sqr))
        refy = _fma(nint, _fma(-ony, dt, dy), -(ony * sqr))
        refz = _fma(nint, _fma(-onz, dt, dz), -(onz * sqr))
        r0 = (1.0 - ridx) / (1.0 + ridx)
        r0 = r0 * r0
        omc = 1.0 - cosine
        omc2 = omc * omc
        schl = _fma((1.0 - r0) * omc2 * omc2, omc, r0)
        rp = torch.where(canr, schl, 1.0)
        coin = u[5] < rp
        dex = torch.where(coin, rfx, refx)
        dey = torch.where(coin, rfy, refy)
        dez = torch.where(coin, rfz, refz)

        # ---- select by material type ----
        is_lam = mtype < 0.5
        is_metal = (mtype > 0.5) & (mtype < 1.5)
        is_diel = (mtype > 1.5) & (mtype < 2.5)
        ndx = torch.where(is_lam, lamx, torch.where(is_metal, mex, dex))
        ndy = torch.where(is_lam, lamy, torch.where(is_metal, mey, dey))
        ndz = torch.where(is_lam, lamz, torch.where(is_metal, mez, dez))
        if V:
            is_iso = mtype > 3.5
            ndx = torch.where(is_iso, ballx, ndx)
            ndy = torch.where(is_iso, bally, ndy)
            ndz = torch.where(is_iso, ballz, ndz)
        ninv = _rsqrt(_fma(ndz, ndz, _fma(ndx, ndx, ndy * ndy)) + 1e-30)
        ndx = ndx * ninv
        ndy = ndy * ninv
        ndz = ndz * ninv
        if lam_w is not None:
            albx = torch.where(is_lam, albx * lam_w, albx)
            alby = torch.where(is_lam, alby * lam_w, alby)
            albz = torch.where(is_lam, albz * lam_w, albz)
        wx = torch.where(is_diel, 1.0, albx)
        wy = torch.where(is_diel, 1.0, alby)
        wz = torch.where(is_diel, 1.0, albz)
        scatter_ok = ~is_lam | lam_ok
        if plan.has_light:
            # ---- one-sided emission (material.h:238-244): a light hit
            # emits when the ray runs along the normal, and ends the path
            is_li = (mtype > 2.5) & (mtype < 3.5)
            emitm = active & hit & is_li & (ddn > 0.0)
            rx = rx + torch.where(emitm, tpx * albx, 0.0)
            ry = ry + torch.where(emitm, tpy * alby, 0.0)
            rz = rz + torch.where(emitm, tpz * albz, 0.0)
            scatter_ok = scatter_ok & ~is_li

        # ---- background on miss (RayTracingWeekend.cpp:143-158) ----
        miss = active & ~hit
        if plan.bg_gradient:
            tbg = 0.5 * (dy + 1.0)
            bgx = _fma(tbg, 0.5, 1.0 - tbg)
            bgy = _fma(tbg, 0.7, 1.0 - tbg)
            rx = rx + torch.where(miss, tpx * bgx, 0.0)
            ry = ry + torch.where(miss, tpy * bgy, 0.0)
            rz = rz + torch.where(miss, tpz * 1.0, 0.0)

        # ---- throughput, Russian roulette, termination ----
        live = active & hit
        tpx = torch.where(live, tpx * wx, tpx)
        tpy = torch.where(live, tpy * wy, tpy)
        tpz = torch.where(live, tpz * wz, tpz)
        tpmax = torch.maximum(tpx, torch.maximum(tpy, tpz))
        alive = live & scatter_ok & (tpmax > 0.0)
        if plan.rr_depth is not None:
            do_rr = alive & (depth >= float(plan.rr_depth))
            p_cont = torch.clamp(tpmax, 0.05, 0.95)
            survive = u[6] < p_cont
            keep = do_rr & survive
            inv_p = 1.0 / p_cont
            tpx = torch.where(keep, tpx * inv_p, tpx)
            tpy = torch.where(keep, tpy * inv_p, tpy)
            tpz = torch.where(keep, tpz * inv_p, tpz)
            alive = alive & (~do_rr | survive)
        depth = depth + 1.0
        alive = alive & (depth < float(plan.max_depth))

        finished = active & ~alive
        ax = ax + torch.where(finished, rx, 0.0)
        ay = ay + torch.where(finished, ry, 0.0)
        az = az + torch.where(finished, rz, 0.0)
        done = done + torch.where(finished, 1.0, 0.0)

        # ---- regenerate finished slots' next sample ----
        gox, goy, goz, gdx, gdy, gdz, gtm = gen_rays(it, tiles, pxi, pxj)
        # exact mode counts a lane's own iterations (the kernel's lanes
        # loop independently there); overdraw counts the tile's
        iters = iters + (active.to(f32) if plan.exact else 1.0)
        new = torch.stack([
            torch.where(alive, px_, gox), torch.where(alive, py_, goy),
            torch.where(alive, pz_, goz), torch.where(alive, ndx, gdx),
            torch.where(alive, ndy, gdy), torch.where(alive, ndz, gdz),
            torch.where(alive, time, gtm),
            torch.where(alive, tpx, 1.0), torch.where(alive, tpy, 1.0),
            torch.where(alive, tpz, 1.0),
            torch.where(alive, rx, 0.0), torch.where(alive, ry, 0.0),
            torch.where(alive, rz, 0.0),
            ax, ay, az, segs, torch.where(alive, depth, 0.0), done, iters,
            blk, nd])
        return new, wcode, done

    # ---- init: the first camera rays use it = -1 ----
    all_tiles = torch.arange(n_tiles, dtype=torch.int64, device=dev)[:, None]
    pxi_all = pixf[:, 0, :]
    pxj_all = pixf[:, 1, :]
    valid_all = pixf[:, 2, :] > 0.0
    rays = gen_rays(-1, all_tiles, pxi_all.reshape(-1), pxj_all.reshape(-1))
    state = torch.zeros((STATE_ROWS, n_tiles * T), dtype=f32, device=dev)
    for r, v in zip((R_OX, R_OY, R_OZ, R_DX, R_DY, R_DZ, R_TIME), rays):
        state[r] = v
    state[R_TPX:R_TPZ + 1] = 1.0
    state[R_DONE] = torch.where(valid_all.reshape(-1), 0.0, spp)
    state = state.view(STATE_ROWS, n_tiles, T)

    n_iters = plan.n_iters
    out = torch.zeros((n_tiles, OUT_ROWS + n_iters, T), dtype=f32,
                      device=dev)
    if n_iters:
        out[:, OUT_ROWS:, :] = -1.0
    if tape is not None:
        # every tile, every taped iteration (a finished lane idles)
        pxi, pxj = pxi_all.reshape(-1), pxj_all.reshape(-1)
        valid = valid_all.reshape(-1)
        state = state.view(STATE_ROWS, -1)
        for it in range(n_iters):
            state, wcode, _ = one_iter(state, it, all_tiles, pxi, pxj, valid,
                                       tape[:, it, :].reshape(-1))
            out[:, OUT_ROWS + it, :] = wcode.view(n_tiles, T)
        state = state.view(STATE_ROWS, n_tiles, T)
    running = (valid_all.any(dim=1) if tape is None
               else torch.zeros(n_tiles, dtype=torch.bool, device=dev))
    it = 0
    while True:
        run = running.nonzero().squeeze(1)
        if run.numel() == 0:
            break
        n_run = run.numel()
        sub = state[:, run].reshape(STATE_ROWS, n_run * T)
        new, wcode, done = one_iter(
            sub, it, run[:, None], pxi_all[run].reshape(-1),
            pxj_all[run].reshape(-1), valid_all[run].reshape(-1))
        state[:, run] = new.view(STATE_ROWS, n_run, T)
        if n_iters:
            if it >= n_iters:
                raise RuntimeError("exact-spp run exceeded spp * max_depth "
                                   "iterations")
            out[run, OUT_ROWS + it, :] = wcode.view(n_run, T)
        running[run] = (done.view(n_run, T) < spp).any(dim=1)
        it += 1

    # row 6: swept (cluster, lane) blocks, a dense sweep one a
    # lane-iteration; row 7: needed ones, 0 when dense
    rows = [(0, R_AX), (1, R_AY), (2, R_AZ), (3, R_SEGS), (4, R_ITERS),
            (5, R_DONE), (6, R_BLK if plan.cull else R_ITERS)]
    if plan.cull:
        rows.append((7, R_NEED))
    for row, r in rows:
        out[:, row, :] = state[r]
    return out


def visits_by_branch(need_hist: torch.Tensor) -> dict:
    """Split a `need_hist` of `trace_mega_reference` at K_BCAST: the warp
    visits the culled kernel sweeps compacted (1 to K_BCAST - 1 needing
    lanes) and by broadcast (K_BCAST to 32)."""
    h = need_hist.tolist()
    return dict(compacted=sum(h[1:K_BCAST]), broadcast=sum(h[K_BCAST:]))


# ---------------------------------------------------------------------------
# The CUDA kernel's wrapper
# ---------------------------------------------------------------------------

def mega_kernel(pixf: torch.Tensor, cam_vec: torch.Tensor,
                sph_tab: torch.Tensor, attr_tab: torch.Tensor,
                clus_tab: torch.Tensor, rect_tab: torch.Tensor,
                light_tab: torch.Tensor, med_tab: torch.Tensor,
                perm: torch.Tensor, ranvec: torch.Tensor,
                images: torch.Tensor, seed: int,
                plan: MegaPlan,
                lib: Optional[ctypes.CDLL] = None) -> torch.Tensor:
    """Launch csrc/megakernel.cu on the current CUDA stream: a culled
    kernel for a culled plan, else a dense one. Same arguments and
    result as `trace_mega_reference`. `lib`, a measurement build's library
    passed through `bind` (tools/culled_ab.py), replaces the kernels'
    own. Raises on a CPU tensor, a wrong shape or dtype, a failed build
    and a refused launch."""
    seed = _check_seed(seed)
    n_tiles, _, T = pixf.shape
    S = plan.S
    n_img = len(plan.img_hw)
    f32, i32 = torch.float32, torch.int32
    expect = {"pixf": (pixf, f32, (n_tiles, 4, plan.T)),
              "cam_vec": (cam_vec, f32, (1, 128)),
              "sph_tab": (sph_tab, f32, (S, SPH_LANES)),
              "attr_tab": (attr_tab, f32, (A_ROWS, S)),
              "clus_tab": (clus_tab, f32, (plan.C, CLUS_LANES)),
              "rect_tab": (rect_tab, f32, (max(plan.R, 1), RECT_LANES)),
              "light_tab": (light_tab, f32, (max(plan.L, 1), LIGHT_LANES)),
              "med_tab": (med_tab, f32, (max(plan.V, 1), MED_LANES)),
              "perm": (perm, i32, (256,)),
              "ranvec": (ranvec, f32, (256, 3)),
              "images": (images, f32, (max(n_img, 1),) + (
                  tuple(images.shape[1:]) if n_img else (1, 1, 3)))}
    for name, (t, dtype, shape) in expect.items():
        if not t.is_cuda:
            raise ValueError(f"mega_kernel needs CUDA tensors; {name} is on "
                             f"{t.device}")
        if t.dtype != dtype or tuple(t.shape) != shape:
            raise ValueError(f"{name}: expected {dtype} {shape}, got "
                             f"{t.dtype} {tuple(t.shape)}")
        if t.device != pixf.device:
            raise ValueError(f"{name} is on {t.device}, pixf on {pixf.device}")
    img_h, img_w = images.shape[1:3]
    if images.shape[3] != 3 or any(h > img_h or w > img_w
                                   for h, w in plan.img_hw):
        raise ValueError(f"images {tuple(images.shape)} do not hold the "
                         f"plan's images {plan.img_hw}")
    limit = CULLED_MAX_T if plan.cull else DENSE_MAX_T
    if not plan.exact and T > limit:
        raise ValueError(f"overdraw mode runs one tile per CUDA block of "
                         f"at most {limit} lanes: T={T}")
    if plan.cull and T % 32:
        raise ValueError(f"the culled kernel needs T % 32 == 0, got T={T}")
    lib = _kernel_lib() if lib is None else lib
    pixf, cam_vec, attr_tab, clus_tab, rect_tab, light_tab, med_tab, perm, \
        ranvec, images = (t.contiguous() for t in (
            pixf, cam_vec, attr_tab, clus_tab, rect_tab, light_tab, med_tab,
            perm, ranvec, images))
    sph = _sweep_table(sph_tab, plan)
    # the rect, light and medium codes, (height, width) per image, then
    # the rect runs (`rect_runs`)
    codes = _row_codes(plan.rect_codes + plan.light_codes + plan.med_codes
                       + tuple(v for hw in plan.img_hw for v in hw)
                       + rect_runs(plan.rect_codes), str(pixf.device))
    out = torch.empty((n_tiles, OUT_ROWS + plan.n_iters, T),
                      dtype=torch.float32, device=pixf.device)
    with torch.cuda.device(pixf.device):
        stream = torch.cuda.current_stream().cuda_stream
        rc = lib.rtw_mega_launch(
            pixf.data_ptr(), cam_vec.data_ptr(), sph.data_ptr(),
            attr_tab.data_ptr(), clus_tab.data_ptr(), rect_tab.data_ptr(),
            light_tab.data_ptr(), med_tab.data_ptr(), codes.data_ptr(),
            perm.data_ptr(), ranvec.data_ptr(), images.data_ptr(),
            out.data_ptr(),
            n_tiles, T, S, plan.R, plan.L, plan.V, plan.n_iters, seed,
            plan.spp, plan.max_depth,
            -1 if plan.rr_depth is None else plan.rr_depth,
            n_img, img_h, img_w, plan.C, plan.SB, plan.dyn_order,
            int(plan.exact), int(plan.lens), int(plan.bg_gradient),
            sweep_axes(plan), int(plan.uniform_time),
            plan.feat, int(plan.has_spheres), int(plan.textures),
            int(plan.cull),
            _f32(1.0 / plan.nx), _f32(1.0 / plan.ny), plan.t_min, plan.ut_t0,
            plan.ut_idt, _f32(1.0 / plan.L) if plan.L else 0.0, stream)
    if rc != 0:
        raise RuntimeError(f"megakernel launch failed: CUDA error {rc} "
                           f"({lib.rtw_error_string(rc).decode()})")
    if _orders_tiles(plan):
        _longest_first(pixf, out)
    if plan.cull:
        KERNEL_LAUNCHES["K5s" if plan.surfaces else "K5"] += 1
        return out
    if not plan.surfaces:
        KERNEL_LAUNCHES["K1"] += 1
    if plan.R or plan.L or plan.V or plan.has_light:
        KERNEL_LAUNCHES["K2+K3"] += 1
    if plan.textures:
        KERNEL_LAUNCHES["K4"] += 1
    return out


def _sweep_table(sph_tab: torch.Tensor, plan: MegaPlan) -> torch.Tensor:
    """The sphere slots as the kernel reads them. Dense: the (9, S) SoA
    of SWEEP_LANES, which the kernel stages in shared memory in its own
    layout (csrc/sweep.cuh: the lanes its slot loop reads). Culled: (S,
    4 Q) float32, Q 16-byte quads a slot read through the read-only path:
    (cx, cy, cz, nr2), with moving spheres (dcx, dcy, dcz, 0), without a
    uniform shutter (t0, 1/dt, 0, 0)."""
    if not plan.cull:
        return sph_tab[:, list(SWEEP_LANES)].t().contiguous()
    moving = sweep_axes(plan) != AXES_STATIC
    q = 1 if not moving else (2 if plan.uniform_time else 3)
    quads = sph_tab.new_zeros((plan.S, 4 * q))
    quads[:, 0:4] = sph_tab[:, [C_CX, C_CY, C_CZ, C_NR2]]
    if q > 1:
        quads[:, 4:7] = sph_tab[:, [C_DCX, C_DCY, C_DCZ]]
    if q > 2:
        quads[:, 8:10] = sph_tab[:, [C_T0, C_IDT]]
    return quads


@functools.lru_cache(maxsize=32)
def rect_runs(rect_codes: tuple) -> tuple:
    """The order in which the surfaces kernels test the rects (csrc/
    megakernel.cu Tables::runs), from the rows' static codes: runs of one
    transform group and one axis, groups in their number's order, axes 0,
    1, 2 within a group, rows in row order within a run. As ints: G (the
    groups), the rect row at each run position, then one header a group:
    its first row | rotated << 24 | translated << 25, and its rows along
    axis 0, 1 and 2. Empty without rects. The kernel merges the rows in
    this order keeping the lower row on an equal t, so its winner is the
    row loop's: the first row with the strictly smallest t."""
    if not rect_codes:
        return ()
    G = 1 + max(c >> 4 for c in rect_codes)
    order = sorted(range(len(rect_codes)),
                   key=lambda r: (rect_codes[r] >> 4, rect_codes[r] & 3, r))
    heads = []
    for g in range(G):
        rows = [r for r, c in enumerate(rect_codes) if c >> 4 == g]
        if not rows:
            raise ValueError(f"rect transform groups must be numbered "
                             f"0..G-1 with no gap: {rect_codes}")
        flags = (rect_codes[rows[0]] >> 2) & 3
        heads += [rows[0] | flags << 24,
                  *(sum(rect_codes[r] & 3 == a for r in rows)
                    for a in range(3))]
    return (G, *order, *heads)


@functools.lru_cache(maxsize=32)
def _row_codes(codes: tuple, device: str) -> torch.Tensor:
    """The rows' static codes (and the image sizes) as an int32 tensor on
    `device` (at least one element), made once per plan's codes."""
    return torch.tensor(codes or (0,), dtype=torch.int32, device=device)


def _mega_call(*args):
    """Dispatch one launch (the arguments of `mega_kernel`): the CUDA
    kernel for CUDA tensors, the plain version for CPU tensors."""
    if args[0].is_cuda:
        return mega_kernel(*args)
    return trace_mega_reference(*args)


class MegaResult(NamedTuple):
    """image: (ny, nx, 3) radiance sums renormalised to exactly spp samples
    per pixel (divide by spp for the mean); segments: path segments traced;
    lane_iters: lane-iterations spent; tape: exact mode's (n_tiles, n_iters,
    T) winner codes (-1 miss, [0, S) sphere slot, S + r rect row, S + R + v
    medium row), None in overdraw mode; blocks: swept (cluster, lane)
    blocks, counted where lane_iters counts an iteration, so that
    blocks / (lane_iters * C) is the culling's warp survival (1 when
    dense); lane_need: the (cluster, lane) blocks the lanes' own rays
    needed (row 7), lane_need / (lane_iters * C) the per-lane survival
    (blocks when dense)."""
    image: torch.Tensor
    segments: torch.Tensor
    lane_iters: torch.Tensor
    tape: Optional[torch.Tensor]
    blocks: torch.Tensor
    lane_need: torch.Tensor


def trace_mega(seed: int, scene: st.Scene, nx: int, ny: int, spp: int,
               max_depth: int = 50, rr_depth: Optional[int] = 4,
               T: Optional[int] = None, exact: bool = False,
               device="cuda", SB: Optional[int] = None,
               cull: Optional[bool] = None,
               dyn_order: Optional[int] = None) -> MegaResult:
    """Render one launch of `spp` samples per pixel through the megakernel
    on `device`. `seed` is the launch's int32 RNG seed (the JAX package
    draws it from its key; pass that value to reproduce its streams).
    SB, cull and dyn_order are `make_plan`'s."""
    _, plan = make_plan(scene, nx, ny, spp, max_depth=max_depth,
                        rr_depth=rr_depth, T=T, exact=exact, SB=SB,
                        cull=cull, dyn_order=dyn_order)
    args, inv = device_inputs(scene, plan, device)
    out = _mega_call(*args, seed, plan)
    return _epilogue(out, inv, plan)


def _epilogue(out: torch.Tensor, inv: torch.Tensor,
              plan: MegaPlan) -> MegaResult:
    """Overdraw renormalisation and the inverse pixel permutation."""
    n_tiles, _, T = out.shape
    sums = out[:, 0:3, :].transpose(1, 2)                  # (n_tiles, T, 3)
    # lanes oversample their pixel while the tile drains: rescale each
    # pixel's sum to exactly spp samples by its true count
    scale = plan.spp / torch.clamp_min(out[:, 5, :], 1.0)
    blocked = (sums * scale[..., None]).reshape(n_tiles * T, 3)
    image = blocked[inv].reshape(plan.ny, plan.nx, 3)
    tape = out[:, OUT_ROWS:, :] if plan.exact else None
    # a dense launch's row 6 counts one sweep of all C clusters, every
    # one of them needed
    blocks = out[:, 6, :].sum() * (1 if plan.cull else plan.C)
    lane_need = out[:, 7, :].sum() if plan.cull else blocks
    return MegaResult(image=image, segments=out[:, 3, :].sum(),
                      lane_iters=out[:, 4, :].sum(), tape=tape,
                      blocks=blocks, lane_need=lane_need)


def bind(lib: ctypes.CDLL) -> ctypes.CDLL:
    """`lib` (a build of csrc/megakernel.cu, ops/_build.py) with the
    argtypes and restype of its launch and error entry points."""
    p, i, f = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
    lib.rtw_mega_launch.argtypes = ([p] * 13    # tensors
                                    + [i] * 17  # sizes, seed, spp, depths,
                                    #             image sizes, C, SB, order
                                    + [i] * 9   # mode flags
                                    + [f] * 6   # floats
                                    + [p])      # stream
    lib.rtw_mega_launch.restype = ctypes.c_int
    lib.rtw_error_string.argtypes = [ctypes.c_int]
    lib.rtw_error_string.restype = ctypes.c_char_p
    return lib


@functools.lru_cache(maxsize=None)
def _kernel_lib() -> ctypes.CDLL:
    """The built kernel library (ops/_build.py), bound. Raises if its
    culled kernels' constants (rtw_culled_consts) are not the ones the
    plain version and `make_plan` use, K_BCAST and CULLED_MAX_T, or its
    dense kernels' forms, staged slot words and block limits not
    DENSE_FORMS, `slot_words` and DENSE_MAX_T (check_dense_consts), or
    its surfaces forms and their block limits not SURFACE_FORMS and
    DENSE_MAX_T (check_surface_forms)."""
    lib = bind(_build.load())
    check_culled_consts(lib)
    check_dense_consts(lib)
    check_surface_forms(lib)
    return lib


def dense_consts(lib) -> list:
    """`lib`'s dense kernel forms (rtw_dense_consts): one (axes, uniform
    shutter, staged slot words, block limit of the sphere kernel, of the
    surfaces kernel, of the textured surfaces kernel) a form. Raises if
    the library has another number of forms than DENSE_FORMS or a CUDA
    error."""
    n = len(DENSE_FORMS)
    got = (ctypes.c_int * (6 * n))()
    rc = lib.rtw_dense_consts(got, n)
    if rc != n:
        raise RuntimeError(f"rtw_dense_consts returned {rc}, not {n} forms"
                           + (f" (CUDA error {-rc})" if rc < 0 else ""))
    return [tuple(got[6 * i:6 * i + 6]) for i in range(n)]


def dense_max_threads(lib) -> dict:
    """`lib`'s dense kernels' block limits (CUDA's maxThreadsPerBlock of
    each instantiation) by kernel: {"spheres": [one a DENSE_FORMS form],
    "surfaces": [the forms without textures, then with]}."""
    rows = dense_consts(lib)
    return {"spheres": [r[3] for r in rows],
            "surfaces": [r[4] for r in rows] + [r[5] for r in rows]}


def check_dense_consts(lib) -> None:
    """Raise RuntimeError unless `lib`'s dense kernels are instantiated
    for DENSE_FORMS, in that order, stage `slot_words` a slot (what
    `shared_bytes` counts) and take blocks of exactly DENSE_MAX_T lanes
    for their kernel (the limit `make_plan` holds overdraw tiles to)."""
    rows = dense_consts(lib)
    forms = [(a, bool(u)) for a, u, *_ in rows]
    words = [w for _, _, w, *_ in rows]
    if forms != list(DENSE_FORMS) or words != [
            slot_words(a, u) for a, u in DENSE_FORMS]:
        raise RuntimeError(f"the kernel library's dense forms {forms} "
                           f"stage {words} words a slot, the plan's "
                           f"DENSE_FORMS {list(DENSE_FORMS)} "
                           f"{[slot_words(a, u) for a, u in DENSE_FORMS]}")
    for kind, limits in dense_max_threads(lib).items():
        if set(limits) != {DENSE_MAX_T}:
            raise RuntimeError(f"the kernel library's dense {kind} kernels "
                               f"take at most {limits} lanes a block, "
                               f"DENSE_MAX_T = {DENSE_MAX_T}")


def surface_forms(lib) -> list:
    """`lib`'s dense surfaces instantiations (rtw_surface_forms): one
    (axes, uniform shutter, features, block limit, registers, local bytes)
    a form. Raises on a CUDA error."""
    n = len(SURFACE_FORMS)
    got = (ctypes.c_int * (6 * n))()
    rc = lib.rtw_surface_forms(got, n)
    if rc < 0:
        raise RuntimeError(f"rtw_surface_forms: CUDA error {-rc}")
    return [tuple(got[6 * i:6 * i + 6]) for i in range(min(rc, n))] + [
        None] * max(rc - n, 0)


def check_surface_forms(lib) -> None:
    """Raise RuntimeError unless `lib`'s surfaces instantiations are
    SURFACE_FORMS, in that order (the forms `surface_form` plans), each
    taking blocks of exactly DENSE_MAX_T lanes."""
    rows = surface_forms(lib)
    forms = [None if r is None else (r[0], bool(r[1]), r[2]) for r in rows]
    if forms != list(SURFACE_FORMS):
        raise RuntimeError(f"the kernel library's surfaces forms {forms}, "
                           f"the plan's SURFACE_FORMS "
                           f"{list(SURFACE_FORMS)}")
    limits = [r[3] for r in rows]
    if set(limits) != {DENSE_MAX_T}:
        raise RuntimeError(f"the kernel library's surfaces forms take at "
                           f"most {limits} lanes a block, DENSE_MAX_T = "
                           f"{DENSE_MAX_T}")


def check_culled_consts(lib) -> None:
    """Raise RuntimeError unless `lib`'s rtw_culled_consts give
    (K_BCAST, CULLED_MAX_T)."""
    got = (ctypes.c_int * 2)()
    lib.rtw_culled_consts(got)
    if tuple(got) != (K_BCAST, CULLED_MAX_T):
        raise RuntimeError(f"the kernel library's (kBcast, kCulledMaxT) "
                           f"= {tuple(got)}, the plain version's "
                           f"(K_BCAST, CULLED_MAX_T) = "
                           f"{(K_BCAST, CULLED_MAX_T)}")
