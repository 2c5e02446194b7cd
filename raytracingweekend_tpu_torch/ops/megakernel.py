"""The megakernel: the whole path-trace loop fused in one CUDA kernel.

The port of raytracingweekend_tpu/ops/megakernel.py for sphere scenes (the
book-1 slice: ROADMAP kernel K1, `_kernel` with one dense sphere cluster).
One launch traces every pixel of a frame: each lane owns one pixel slot
and runs

    camera ray -> dense closest hit over every sphere slot -> shading
    (lambertian / metal / dielectric, gradient sky) -> Russian roulette ->
    regeneration of the slot's next sample

until its pixel has its samples. The module holds

- the host plan: bitwise the JAX package's sphere / camera tables
  (`build_tables`), sphere order (`_morton_order`, `_kd_cluster_order`),
  launch plan (`make_plan`) and pixel layout (`_pixel_layout`);
- the device helpers `_uniforms` (the lowbias32 counter-hash RNG, bitwise
  equal to JAX's), `_onb` and `_cossin2pi`, in torch;
- `mega_kernel`, the wrapper of the CUDA kernel (csrc/megakernel.cu), and
  `trace_mega_reference`, its plain PyTorch version with the same
  arguments;
- `trace_mega`, the entry point, with the epilogue (overdraw
  renormalisation and the inverse pixel permutation).

Two modes share the kernel. Overdraw (the render path): every valid lane
of a tile keeps tracing samples of its own pixel until the tile's slowest
lane has `spp`, and the epilogue renormalises by the true per-lane count.
Exact-spp (the tape semantics of the JAX package's differentiable path):
each lane traces exactly `spp` samples and records the winning sphere slot
of every bounce (-1 for a miss), which holds the port to the JAX package
decision by decision.

On a CPU tensor `trace_mega` runs the plain version; on a CUDA tensor it
launches the kernel or raises.
"""
from __future__ import annotations

import ctypes
import dataclasses
import functools
import weakref
from typing import NamedTuple, Optional

import numpy as np
import torch

from ..models import scene_types as st
from . import _build
from .integrator import _block_linear_order

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

# ---- camera vector lanes: (1, 128) ----
(CAM_OX, CAM_OY, CAM_OZ, CAM_LLX, CAM_LLY, CAM_LLZ, CAM_HX, CAM_HY, CAM_HZ,
 CAM_VX, CAM_VY, CAM_VZ, CAM_UX, CAM_UY, CAM_UZ, CAM_WX, CAM_WY, CAM_WZ,
 CAM_LENS, CAM_T0, CAM_T1) = range(21)

# Output rows of one tile: radiance sums xyz, segments, lane iterations,
# samples done, sweep blocks, zero; exact mode appends n_iters tape rows.
OUT_ROWS = 8

# Number of CUDA kernel launches through `mega_kernel` in this process.
KERNEL_LAUNCHES = 0


# ---------------------------------------------------------------------------
# Device helpers (torch): the counter-hash RNG, the ONB and cos/sin(2 pi u)
# ---------------------------------------------------------------------------

_M32 = 0xFFFFFFFF


# Fused multiply-adds. The JAX kernel runs its arithmetic under XLA, whose
# CPU backend contracts every single-use multiply feeding an add into an
# FMA (LLVM's rule: in x*y + z*w the first product is fused), and the CUDA
# kernel is built with -fmad=false and writes the same fmaf calls. The
# plain version writes each of those FMAs out, with one rounding: the
# product of two float32 values is exact in float64.
def _f64(x):
    """float64 view of a float32 tensor or (float32-rounded) constant."""
    return x.double() if isinstance(x, torch.Tensor) else float(np.float32(x))


def _fma(a, b, c) -> torch.Tensor:
    """a * b + c in float32 with one rounding."""
    return (_f64(a) * _f64(b) + _f64(c)).to(torch.float32)


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
    vinv = torch.rsqrt(_fma(vz, vz, _fma(vx, vx, vy * vy)) + 1e-30)
    vx = vx * vinv
    vy = vy * vinv
    vz = vz * vinv
    ux = _fma(wy, vz, -(wz * vy))
    uy = _fma(wz, vx, -(wx * vz))
    uz = _fma(wx, vy, -(wy * vx))
    return ux, uy, uz, vx, vy, vz


# ---------------------------------------------------------------------------
# Host plan: scene support, sphere order, tables, launch plan, pixel layout
# ---------------------------------------------------------------------------

def supports_scene(scene: st.Scene) -> bool:
    """True when this slice of the port renders the scene: spheres only
    (no rects, media or lights), constant textures, lambertian / metal /
    dielectric materials, shaded, the `mis` strategy, no BVH."""
    act = np.asarray(scene.spheres.active, bool)
    if (scene.bvh is not None
            or scene.needs_legacy_textures
            or scene.render_type != st.RENDER_SHADED
            or scene.lambertian_strategy != "mis"
            or not act.any()
            or np.any(np.asarray(scene.rects.active))
            or np.any(np.asarray(scene.media.active))
            or int(scene.lights.num) != 0):
        return False
    mat = np.asarray(scene.spheres.mat)[act]
    mtype = np.asarray(scene.materials.mtype)[mat]
    ttype = np.asarray(scene.textures.ttype)[
        np.asarray(scene.materials.tex)[mat]]
    return bool(np.all(np.isin(mtype, (st.MAT_LAMBERTIAN, st.MAT_METAL,
                                       st.MAT_DIELECTRIC)))
                and np.all(ttype == st.TEX_CONSTANT))


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


def build_tables(scene: st.Scene, SB: int = 64):
    """Host packing of the sphere and camera tables, bitwise equal to the
    sphere / camera part of the JAX `build_tables`. Returns
    (sph_tab (S, 128), attr_tab (24, S), cam_vec (1, 128), meta) as numpy.

    Live spheres are deduplicated (first of exact geometric duplicates
    wins, as the reference's strict `t < closest` list sweep), ordered
    along a Morton curve (one cluster) or a kd split with the clusters
    holding the biggest spheres first (several clusters), and padded to a
    multiple of SB with inert rows (nr2 = +1 never hits)."""
    sph = scene.spheres
    act = np.asarray(sph.active)
    c0 = np.asarray(sph.center0, np.float32)
    c1 = np.asarray(sph.center1, np.float32)
    t0 = np.asarray(sph.time0, np.float32)
    t1 = np.asarray(sph.time1, np.float32)
    rad = np.asarray(sph.radius, np.float32)
    mat = np.asarray(sph.mat)

    live = np.nonzero(act)[0]
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
    if C > 1:
        blocks = idx_ext.reshape(C, SB)
        key_r = np.array([np.abs(rad[b[b >= 0]]).max() if (b >= 0).any()
                          else -1.0 for b in blocks])
        blocks = blocks[np.argsort(-key_r, kind="stable")]
        idx_ext = blocks.reshape(S)
    actm = idx_ext >= 0

    def pad(x, fill=0.0):
        out = np.full((S,) + x.shape[1:], fill, x.dtype)
        out[actm] = x[idx_ext[actm]]
        return out

    c0p, c1p = pad(c0), pad(c1)
    t0p, t1p = pad(t0), pad(t1, 1.0)
    radp = pad(rad)
    actp = actm.astype(np.float32)
    dt = t1p - t0p
    idt = np.where(dt != 0, 1.0 / np.where(dt != 0, dt, 1.0), 0.0)
    dc = c1p - c0p

    # r2 = -1 on padding rows: nr2 = +1 there, so disc < 0 (never a hit)
    r2 = np.where(actp > 0, radp ** 2, -1.0).astype(np.float32)
    sph_tab = np.zeros((S, SPH_LANES), np.float32)
    for lane, v in ((C_CX, c0p[:, 0]), (C_CY, c0p[:, 1]), (C_CZ, c0p[:, 2]),
                    (C_DCX, dc[:, 0]), (C_DCY, dc[:, 1]), (C_DCZ, dc[:, 2]),
                    (C_T0, t0p), (C_IDT, idt), (C_R2, r2),
                    (C_ACT, actp), (C_NR2, -r2)):
        sph_tab[:, lane] = v

    mats = scene.materials
    tex = scene.textures
    matp = pad(mat.astype(np.int64))
    mtype = np.asarray(mats.mtype)[matp]
    ti = np.asarray(mats.tex)[matp]
    col_all = np.asarray(tex.color, np.float32)
    alb = col_all[ti]
    fuzz = np.asarray(mats.fuzz, np.float32)[matp]
    ridx = np.asarray(mats.ref_idx, np.float32)[matp]
    rinv = np.where(radp != 0, 1.0 / np.where(radp != 0, radp, 1.0), 0.0)
    # Checker / noise / image rows keep the JAX layout (their values for
    # constant textures); the sphere slice of the kernel does not read them.
    ttype_np = np.asarray(tex.ttype)
    chk = (ttype_np[ti] == st.TEX_CHECKER).astype(np.float32)
    evc = col_all[np.asarray(tex.even)[ti]]
    odc = col_all[np.asarray(tex.odd)[ti]]
    nmode_np = np.asarray(tex.noise_mode)
    is_noi = ttype_np[ti] == st.TEX_NOISE
    noi = np.where(is_noi, 1.0 + nmode_np[ti], 0.0).astype(np.float32)
    nscale = np.asarray(tex.scale, np.float32)[ti]
    is_img = ttype_np[ti] == st.TEX_IMAGE
    imgf = np.where(is_img, 1.0 + np.asarray(tex.image_id)[ti],
                    0.0).astype(np.float32)
    imgf = np.where(actm, imgf, 0.0).astype(np.float32)

    attr_tab = np.zeros((A_ROWS, S), np.float32)
    for row, v in ((A_CX, c0p[:, 0]), (A_CY, c0p[:, 1]), (A_CZ, c0p[:, 2]),
                   (A_DCX, dc[:, 0]), (A_DCY, dc[:, 1]), (A_DCZ, dc[:, 2]),
                   (A_T0, t0p), (A_IDT, idt), (A_RINV, rinv),
                   (A_MTYPE, mtype.astype(np.float32)),
                   (A_ALBX, alb[:, 0]), (A_ALBY, alb[:, 1]),
                   (A_ALBZ, alb[:, 2]),
                   (A_MPARAM, np.where(mtype == st.MAT_METAL, fuzz,
                                       np.where(mtype == st.MAT_DIELECTRIC,
                                                ridx, 0.0))
                    .astype(np.float32)),
                   (A_CHK, chk), (A_NSCALE, nscale), (A_NOISE, noi),
                   (A_EVENX, evc[:, 0]), (A_EVENY, evc[:, 1]),
                   (A_EVENZ, evc[:, 2]),
                   (A_ODDX, odc[:, 0]), (A_ODDY, odc[:, 1]),
                   (A_ODDZ, odc[:, 2]), (A_IMG, imgf)):
        attr_tab[row] = v

    cam = scene.camera
    cam_vec = np.zeros((1, 128), np.float32)
    for lane, v in ((CAM_OX, cam.origin), (CAM_LLX, cam.lower_left_corner),
                    (CAM_HX, cam.horizontal), (CAM_VX, cam.vertical),
                    (CAM_UX, cam.u), (CAM_WX, cam.v)):
        cam_vec[0, lane:lane + 3] = np.asarray(v, np.float32)
    cam_vec[0, CAM_LENS] = float(cam.lens_radius)
    cam_vec[0, CAM_T0] = float(cam.time0)
    cam_vec[0, CAM_T1] = float(cam.time1)

    # One shared (time0, 1/dt) over the live spheres lets the sweep take
    # the motion fraction once per ray instead of once per sphere.
    t0a = t0p[actm]
    idta = idt[actm]
    uniform_time = bool(n and np.all(t0a == t0a[0])
                        and np.all(idta == idta[0]))
    meta = dict(S=S, C=C, SB=SB,
                uniform_time=uniform_time,
                ut_t0=float(t0a[0]) if n else 0.0,
                ut_idt=float(idta[0]) if n else 0.0,
                moving_axes=tuple(bool(np.any(dc[:, ax] != 0))
                                  for ax in range(3)),
                moving=bool(scene.has_moving_spheres),
                lens=float(cam.lens_radius) > 0.0,
                bg_gradient=scene.background == st.BG_GRADIENT,
                # scene sphere row of each slot (-1: padding): decodes a
                # winner tape
                slot_ext=idx_ext.astype(np.int32))
    return sph_tab, attr_tab, cam_vec, meta


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


def make_plan(scene: st.Scene, nx: int, ny: int, spp: int,
              max_depth: int = 50, rr_depth: Optional[int] = 4,
              T: Optional[int] = None, exact: bool = False):
    """Host-side launch plan: the packed tables and the static plan.

    The slots are one cluster of every live sphere up to 512 (the JAX
    package's book-1 order, without its 128-lane padding) and clusters of
    128 beyond; the kernel sweeps all slots densely either way. T defaults
    to 256 lanes; in overdraw mode it is the CUDA block size, so T <= 1024.
    The TPU's 128-lane rounding and 512-lane floor do not apply here.
    Returns (tables, plan)."""
    if not supports_scene(scene):
        raise NotImplementedError(
            "the port's megakernel covers sphere scenes with constant "
            "textures and lambertian/metal/dielectric materials; rects, "
            "lights, media and textures come with ROADMAP Queue 1 item 5")
    n_live = int(np.sum(np.asarray(scene.spheres.active)))
    SB = min(512 if n_live <= 512 else 128, max(8, -(-n_live // 8) * 8))
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
                    bg_gradient=meta["bg_gradient"])
    return tabs, plan


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
    (pixf, cam_vec, sph_tab, attr_tab), plus the inverse pixel permutation.
    Tables are copied once per (scene, device), layouts once per shape."""
    device = torch.device(device)

    def build():
        sph, attr, cam, _ = build_tables_cached(scene, plan.SB)
        return tuple(torch.from_numpy(a).to(device) for a in (sph, attr, cam))
    sph, attr, cam = _scene_memo(_TABLE_CACHE, scene,
                                 ("device", plan.SB, str(device)), build)
    pixf, inv = _device_layout(plan.nx, plan.ny, plan.T, str(device))
    return (pixf, cam, sph, attr), inv


# ---------------------------------------------------------------------------
# The plain PyTorch version of the kernel
# ---------------------------------------------------------------------------

# state rows of the plain version
(R_OX, R_OY, R_OZ, R_DX, R_DY, R_DZ, R_TIME, R_TPX, R_TPY, R_TPZ,
 R_RX, R_RY, R_RZ, R_AX, R_AY, R_AZ, R_SEGS, R_DEPTH, R_DONE,
 R_ITERS) = range(20)
STATE_ROWS = 20

# (sphere block) x (lanes) elements per sweep step of the plain version
_SWEEP_ELEMS = 1 << 24


def _check_seed(seed: int) -> int:
    seed = int(seed)
    if not -(1 << 31) <= seed < (1 << 31):
        raise ValueError(f"seed {seed} does not fit in int32")
    return seed


def trace_mega_reference(pixf: torch.Tensor, cam_vec: torch.Tensor,
                         sph_tab: torch.Tensor, attr_tab: torch.Tensor,
                         seed: int, plan: MegaPlan) -> torch.Tensor:
    """The plain PyTorch version of the megakernel, with the arguments of
    `mega_kernel`: pixf (n_tiles, 4, T), cam_vec (1, 128), sph_tab (S, 128)
    and attr_tab (24, S), float32 on one device; seed an int32.
    Returns out (n_tiles, 8 + n_iters, T) float32.

    Vectorised over the lanes of every tile still running, with a Python
    loop over bounce iterations, in the op order of the JAX kernel. A tile
    runs until its slowest lane has `spp` samples (overdraw: all its valid
    lanes trace on; exact mode: finished lanes idle); lanes of a finished
    tile freeze."""
    seed = _check_seed(seed)
    dev = pixf.device
    f32 = torch.float32
    n_tiles, _, T = pixf.shape
    S = plan.S
    spp = float(plan.spp)
    t_min = plan.t_min

    cam = [float(v) for v in cam_vec.reshape(-1)[:21].tolist()]
    c_ox, c_oy, c_oz = cam[CAM_OX], cam[CAM_OY], cam[CAM_OZ]
    c_llx, c_lly, c_llz = cam[CAM_LLX], cam[CAM_LLY], cam[CAM_LLZ]
    c_hx, c_hy, c_hz = cam[CAM_HX], cam[CAM_HY], cam[CAM_HZ]
    c_vx, c_vy, c_vz = cam[CAM_VX], cam[CAM_VY], cam[CAM_VZ]
    c_ux, c_uy, c_uz = cam[CAM_UX], cam[CAM_UY], cam[CAM_UZ]
    c_vvx, c_vvy, c_vvz = cam[CAM_WX], cam[CAM_WY], cam[CAM_WZ]
    c_lens, c_t0 = cam[CAM_LENS], cam[CAM_T0]
    c_dt = float(np.float32(cam[CAM_T1]) - np.float32(c_t0))  # f32 scalar op
    inv_nx = float(np.float32(1.0 / plan.nx))
    inv_ny = float(np.float32(1.0 / plan.ny))

    # sweep columns (S, 1) and the attribute table with a zero miss column
    col = {ln: sph_tab[:, ln:ln + 1] for ln in SWEEP_LANES}
    attr_ext = torch.cat([attr_tab, torch.zeros((A_ROWS, 1), dtype=f32,
                                                device=dev)], dim=1)
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
        inv = torch.rsqrt(_fma(dz, dz, _fma(dx, dx, dy * dy)))
        return ox, oy, oz, dx * inv, dy * inv, dz * inv, time

    # float64 copies of the sweep columns: with float32 operands,
    # addcmul(c, a, b) in float64 is a * b + c with one rounding, so
    # `addcmul(...).float()` is `_fma` without re-converting its operands
    col64 = {ln: c.double() for ln, c in col.items()}

    def sweep(ox, oy, oz, dx, dy, dz, time):
        """Closest hit over every slot: (best_t, winner slot; S on miss).
        The winner is the first slot with the strictly smallest t."""
        n = ox.numel()
        best = torch.full((n,), BIG, dtype=f32, device=dev)
        bidx = torch.full((n,), S, dtype=torch.int64, device=dev)
        eb = max(1, min(S, _SWEEP_ELEMS // max(n, 1)))
        orig = (ox[None], oy[None], oz[None])
        dy_ = dy[None]
        dx64, dz64 = dx.double()[None], dz.double()[None]
        tm_ = time[None]
        if plan.uniform_time:
            frac64 = ((tm_ - plan.ut_t0) * plan.ut_idt).double()
        for lo in range(0, S, eb):
            hi = min(S, lo + eb)
            if any(plan.moving_axes) and not plan.uniform_time:
                frac64 = ((tm_ - col[C_T0][lo:hi])
                          * col[C_IDT][lo:hi]).double()
            # sign-flipped half-b quadratic with a = 1 (unit directions)
            co, co64 = [], []
            for ax, (lc, ldc) in enumerate(((C_CX, C_DCX), (C_CY, C_DCY),
                                            (C_CZ, C_DCZ))):
                c = col[lc][lo:hi]
                if plan.moving_axes[ax]:
                    c = torch.addcmul(col64[lc][lo:hi], frac64,
                                      col64[ldc][lo:hi]).float()
                co.append(c - orig[ax])
                co64.append(co[-1].double())
            cox64, coy64, coz64 = co64
            nb = torch.addcmul((co[1] * dy_).double(), cox64, dx64).float()
            nb64 = torch.addcmul(nb.double(), coz64, dz64).float().double()
            cc = torch.addcmul(col64[C_NR2][lo:hi], coz64, coz64).float()
            cc = torch.addcmul(cc.double(), coy64, coy64).float()
            cc = torch.addcmul(cc.double(), cox64, cox64).float()
            disc = torch.addcmul(cc.double().neg_(), nb64, nb64).float()
            nb = nb64.float()
            # disc < 0 and disc == 0 both give NaN: a miss
            sq = disc * torch.rsqrt(disc)
            tf = (nb + sq).masked_fill_(~((nb + sq) > t_min), BIG)
            tn = nb - sq
            tcv = torch.where(tn > t_min, tn, tf)
            # min over dim 0 returns the first index of the smallest value
            blk_min, cand = tcv.min(dim=0)
            upd = blk_min < best
            bidx = torch.where(upd, cand + lo, bidx)
            best = torch.minimum(best, blk_min)
        return best, bidx

    def one_iter(state, it, tiles, pxi, pxj, valid):
        (ox, oy, oz, dx, dy, dz, time, tpx, tpy, tpz, rx, ry, rz,
         ax, ay, az, segs, depth, done, iters) = state.unbind(0)
        active = (valid & (done < spp)) if plan.exact else valid
        segs = segs + active.to(f32)

        best_t, bidx = sweep(ox, oy, oz, dx, dy, dz, time)
        hit = best_t < _HIT_CUT
        wcode = torch.where(active & hit, bidx.to(f32), -1.0)

        px_ = _fma(best_t, dx, ox)
        py_ = _fma(best_t, dy, oy)
        pz_ = _fma(best_t, dz, oz)
        attrs = attr_ext[:, bidx]

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
        mparam = attrs[A_MPARAM]   # metal fuzz or dielectric IOR

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

        # ---- mirror reflection (metal and dielectric) ----
        ddn = _fma(dz, nz_, _fma(dx, nx_, dy * ny_))
        rfx = _fma(-2.0 * ddn, nx_, dx)
        rfy = _fma(-2.0 * ddn, ny_, dy)
        rfz = _fma(-2.0 * ddn, nz_, dz)

        # ---- metal: reflect + fuzz * point in the unit ball ----
        zb = 1.0 - 2.0 * u[2]
        rb = torch.sqrt(torch.clamp_min(_fma(-zb, zb, 1.0), 0.0))
        cpb, spb = _cossin2pi(u[3])
        radb = torch.exp(torch.log(torch.clamp_min(u[4], 1e-30))
                         * (1.0 / 3.0))
        mex = _fma(mparam, rb * cpb * radb, rfx)
        mey = _fma(mparam, rb * spb * radb, rfy)
        mez = _fma(mparam, zb * radb, rfz)

        # ---- dielectric with the corrected exit cosine (material.h) ----
        ridx = mparam
        inside = ddn > 0.0
        sgn = torch.where(inside, -1.0, 1.0)
        onx = sgn * nx_
        ony = sgn * ny_
        onz = sgn * nz_
        nint = torch.where(inside, ridx, 1.0 / torch.clamp_min(ridx, 1e-6))
        cos_exit2 = _fma(-(ridx * ridx), _fma(-ddn, ddn, 1.0), 1.0)
        cos_exit = torch.sqrt(torch.clamp_min(cos_exit2, 0.0))
        cosine = torch.where(inside, cos_exit, -ddn)
        dt = _fma(dz, onz, _fma(dx, onx, dy * ony))
        disc_r = _fma(-(nint * nint), _fma(-dt, dt, 1.0), 1.0)
        canr = disc_r > 0.0
        sqr = torch.sqrt(torch.clamp_min(disc_r, 0.0))
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
        is_diel = mtype > 1.5
        ndx = torch.where(is_lam, lamx, torch.where(is_metal, mex, dex))
        ndy = torch.where(is_lam, lamy, torch.where(is_metal, mey, dey))
        ndz = torch.where(is_lam, lamz, torch.where(is_metal, mez, dez))
        ninv = torch.rsqrt(_fma(ndz, ndz, _fma(ndx, ndx, ndy * ndy)) + 1e-30)
        ndx = ndx * ninv
        ndy = ndy * ninv
        ndz = ndz * ninv
        wx = torch.where(is_diel, 1.0, albx)
        wy = torch.where(is_diel, 1.0, alby)
        wz = torch.where(is_diel, 1.0, albz)
        scatter_ok = ~is_lam | lam_ok

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
            ax, ay, az, segs, torch.where(alive, depth, 0.0), done, iters])
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
    running = valid_all.any(dim=1)
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

    for row, r in ((0, R_AX), (1, R_AY), (2, R_AZ), (3, R_SEGS),
                   (4, R_ITERS), (5, R_DONE), (6, R_ITERS)):
        out[:, row, :] = state[r]
    return out


# ---------------------------------------------------------------------------
# The CUDA kernel's wrapper
# ---------------------------------------------------------------------------

def mega_kernel(pixf: torch.Tensor, cam_vec: torch.Tensor,
                sph_tab: torch.Tensor, attr_tab: torch.Tensor,
                seed: int, plan: MegaPlan) -> torch.Tensor:
    """Launch csrc/megakernel.cu on the current CUDA stream. Same arguments
    and result as `trace_mega_reference`. Raises on a CPU tensor, a wrong
    shape or dtype, a failed build and a refused launch."""
    global KERNEL_LAUNCHES
    seed = _check_seed(seed)
    n_tiles, _, T = pixf.shape
    S = plan.S
    expect = {"pixf": (pixf, (n_tiles, 4, plan.T)),
              "cam_vec": (cam_vec, (1, 128)),
              "sph_tab": (sph_tab, (S, SPH_LANES)),
              "attr_tab": (attr_tab, (A_ROWS, S))}
    for name, (t, shape) in expect.items():
        if not t.is_cuda:
            raise ValueError(f"mega_kernel needs CUDA tensors; {name} is on "
                             f"{t.device}")
        if t.dtype != torch.float32 or tuple(t.shape) != shape:
            raise ValueError(f"{name}: expected float32 {shape}, got "
                             f"{t.dtype} {tuple(t.shape)}")
        if t.device != pixf.device:
            raise ValueError(f"{name} is on {t.device}, pixf on {pixf.device}")
    if not plan.exact and T > 1024:
        raise ValueError(f"overdraw mode runs one tile per CUDA block: "
                         f"T={T} > 1024")
    lib = _kernel_lib()
    pixf = pixf.contiguous()
    cam_vec = cam_vec.contiguous()
    attr_tab = attr_tab.contiguous()
    sph_soa = sph_tab[:, list(SWEEP_LANES)].t().contiguous()   # (9, S)
    out = torch.empty((n_tiles, OUT_ROWS + plan.n_iters, T),
                      dtype=torch.float32, device=pixf.device)
    with torch.cuda.device(pixf.device):
        stream = torch.cuda.current_stream().cuda_stream
        rc = lib.rtw_mega_launch(
            pixf.data_ptr(), cam_vec.data_ptr(), sph_soa.data_ptr(),
            attr_tab.data_ptr(), out.data_ptr(),
            n_tiles, T, S, plan.n_iters, seed, plan.spp, plan.max_depth,
            -1 if plan.rr_depth is None else plan.rr_depth,
            int(plan.exact), int(plan.lens), int(plan.bg_gradient),
            int(plan.moving or any(plan.moving_axes)), int(plan.uniform_time),
            float(np.float32(1.0 / plan.nx)), float(np.float32(1.0 / plan.ny)),
            plan.t_min, plan.ut_t0, plan.ut_idt, stream)
    if rc != 0:
        raise RuntimeError(f"megakernel launch failed: CUDA error {rc} "
                           f"({lib.rtw_error_string(rc).decode()})")
    KERNEL_LAUNCHES += 1
    return out


def _mega_call(pixf, cam_vec, sph_tab, attr_tab, seed, plan):
    """Dispatch one launch: the CUDA kernel for CUDA tensors, the plain
    version for CPU tensors."""
    if pixf.is_cuda:
        return mega_kernel(pixf, cam_vec, sph_tab, attr_tab, seed, plan)
    return trace_mega_reference(pixf, cam_vec, sph_tab, attr_tab, seed, plan)


class MegaResult(NamedTuple):
    """image: (ny, nx, 3) radiance sums renormalised to exactly spp samples
    per pixel (divide by spp for the mean); segments: path segments traced;
    lane_iters: lane-iterations spent; tape: exact mode's (n_tiles, n_iters,
    T) winner codes (-1 miss, else sphere slot), None in overdraw mode."""
    image: torch.Tensor
    segments: torch.Tensor
    lane_iters: torch.Tensor
    tape: Optional[torch.Tensor]


def trace_mega(seed: int, scene: st.Scene, nx: int, ny: int, spp: int,
               max_depth: int = 50, rr_depth: Optional[int] = 4,
               T: Optional[int] = None, exact: bool = False,
               device="cpu") -> MegaResult:
    """Render one launch of `spp` samples per pixel through the megakernel
    on `device`. `seed` is the launch's int32 RNG seed (the JAX package
    draws it from its key; pass that value to reproduce its streams)."""
    _, plan = make_plan(scene, nx, ny, spp, max_depth=max_depth,
                        rr_depth=rr_depth, T=T, exact=exact)
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
    return MegaResult(image=image, segments=out[:, 3, :].sum(),
                      lane_iters=out[:, 4, :].sum(), tape=tape)


@functools.lru_cache(maxsize=None)
def _kernel_lib() -> ctypes.CDLL:
    """The built kernel library (ops/_build.py) with the argtypes and
    restype of its C entry points."""
    lib = _build.load()
    p, i, f = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
    lib.rtw_mega_launch.argtypes = [p, p, p, p, p,          # tensors
                                    i, i, i, i, i, i, i, i,  # sizes, seed..
                                    i, i, i, i, i,           # mode flags
                                    f, f, f, f, f,           # floats
                                    p]                       # stream
    lib.rtw_mega_launch.restype = ctypes.c_int
    lib.rtw_error_string.argtypes = [ctypes.c_int]
    lib.rtw_error_string.restype = ctypes.c_char_p
    return lib
