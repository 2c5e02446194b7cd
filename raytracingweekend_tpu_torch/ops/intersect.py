"""Closest sphere hit of a wavefront of rays: kernel K7 and its plain version.

The port of raytracingweekend_tpu/ops/pallas_intersect.py. `pack_spheres`
packs the sphere table in the JAX kernel's lanes (12 float32 a slot: no
128-lane padding and no MXU lanes); `sphere_layout` stages it as the CUDA
kernel reads it (a (cx, cy, cz, r^2) quad a slot, r^2 = -inf where the
slot is inactive, then only the motion lanes of the table's form);
`hit_spheres_kernel` launches csrc/intersect.cu on CUDA tensors and
`hit_spheres_reference` is its plain PyTorch version over the same staged
slots (geometry.hit_spheres takes the kernel for CUDA tensors and the
plain version for CPU tensors).

Both compute the JAX kernel's arithmetic with the FMAs XLA's CPU backend
contracts written out (the plain version's rounded once, `_fma_rn`), and
agree with it bit for bit on the CPU (tests/test_torch_intersect.py).
"""
from __future__ import annotations

import ctypes
import dataclasses
import functools
import math

import numpy as np
import torch

from . import _build
from .rounding import _fma_rn

BIG = 3.0e37
# the table's lanes: q0 = (cx, cy, cz, r^2), q1 = (dcx, dcy, dcz, t0),
# q2 = (1/dt, active, 0, 0)
(K_CX, K_CY, K_CZ, K_R2, K_DCX, K_DCY, K_DCZ, K_T0, K_IDT, K_ACT) = range(10)
LANES = 12
# The staged slot forms K7 and the megakernel's dense sweep share
# (csrc/sweep.cuh kAxesStatic, kAxisY, kAxesAll): moving-axis masks (bit
# a: the centres move along axis a), static, y only under one shutter
# window, all axes
AXES_STATIC, AXIS_Y, AXES_ALL = 0, 2, 7
# (ray x slot) elements per step of the plain version
_STEP_ELEMS = 1 << 22
_SLOT_BLOCK = 256

KERNEL_LAUNCHES = {"K7": 0}


def pack_spheres(spheres) -> np.ndarray:
    """(S, 12) float32 table of a scene's Spheres, each lane computed in
    float32 as pallas_intersect.pack_spheres computes it."""
    f32 = np.float32
    c0 = np.asarray(spheres.center0, f32)
    dc = np.asarray(spheres.center1, f32) - c0
    t0 = np.asarray(spheres.time0, f32)
    dt = np.asarray(spheres.time1, f32) - t0
    nz = dt != 0
    inv_dt = np.where(nz, f32(1.0) / np.where(nz, dt, f32(1.0)), f32(0.0))
    r = np.asarray(spheres.radius, f32)
    tab = np.zeros((c0.shape[0], LANES), f32)
    tab[:, K_CX:K_CZ + 1] = c0
    tab[:, K_R2] = r * r
    tab[:, K_DCX:K_DCZ + 1] = dc
    tab[:, K_T0] = t0
    tab[:, K_IDT] = inv_dt
    tab[:, K_ACT] = np.asarray(spheres.active, bool).astype(f32)
    return tab


def slot_words(axes: int, uniform_time: bool) -> int:
    """4-byte words a slot of the staged layout takes (csrc/sweep.cuh
    slot_words): the (cx, cy, cz, r^2) quad (the dense sweep stages -r^2),
    then the motion lanes the slot loop reads: dcy alone (y only), or
    (dcx, dcy, dcz, t0) and, without a uniform shutter, 1 / dt (all
    axes)."""
    if axes == AXES_STATIC:
        return 4
    if axes == AXIS_Y:
        return 5
    return 8 if uniform_time else 9


@dataclasses.dataclass(frozen=True)
class SphereLayout:
    """K7's slots as the kernel stages them (`sphere_layout`): `staged`
    holds S quads (cx, cy, cz, r^2), r^2 = -inf on an inactive slot, then
    the form's motion lanes: dcy (AXIS_Y), or (dcx, dcy, dcz, t0) a slot
    and, without one window, 1 / dt (AXES_ALL). Under one window
    (`uniform`, a moving table) every active slot shares (t0, idt)."""
    staged: torch.Tensor
    S: int
    axes: int
    uniform: bool
    t0: float
    idt: float

    @property
    def words(self) -> int:
        return slot_words(self.axes, self.uniform)


def sphere_layout(table: torch.Tensor, moving: bool) -> SphereLayout:
    """Stage the (S, 12) table for K7 (on its device). A static table
    takes the static form. A moving one takes AXIS_Y where the active
    slots move along y alone, else AXES_ALL, and one window where every
    active slot holds the same (t0, 1/dt) bits, both finite (the rule of
    ops/megakernel.py make_plan and sweep_axes); its form is one host read
    of the table."""
    table = table.detach()
    S = table.shape[0]
    act = table[:, K_ACT] > 0
    r2 = torch.where(act, table[:, K_R2],
                     torch.full_like(table[:, K_R2], -math.inf))
    parts = [torch.stack([table[:, K_CX], table[:, K_CY], table[:, K_CZ],
                          r2], dim=1).reshape(-1)]
    axes, uniform, t0, idt = AXES_STATIC, True, 0.0, 0.0
    if moving and S:
        dc = table[:, K_DCX:K_DCZ + 1]
        t0s, idts = table[:, K_T0].contiguous(), table[:, K_IDT].contiguous()
        first = act.to(torch.int32).argmax()      # the first active slot
        b0, b1 = t0s.view(torch.int32), idts.view(torch.int32)
        one = (((b0 == b0[first]) & (b1 == b1[first])) | ~act).all() & \
            torch.isfinite(t0s[first]) & torch.isfinite(idts[first])
        info = torch.cat([((dc != 0) & act[:, None]).any(dim=0).float(),
                          one[None].float(), t0s[first, None],
                          idts[first, None]]).tolist()
        mask = sum(1 << k for k in range(3) if info[k])
        uniform = bool(info[3])
        axes = AXIS_Y if mask == AXIS_Y and uniform else AXES_ALL
        if uniform:
            t0, idt = info[4], info[5]
        if axes == AXIS_Y:
            parts.append(dc[:, 1])
        else:
            w = t0s if not uniform else torch.zeros_like(t0s)
            parts.append(torch.cat([dc, w[:, None]], dim=1).reshape(-1))
            if not uniform:
                parts.append(idts)
    return SphereLayout(staged=torch.cat(parts).contiguous(), S=S, axes=axes,
                        uniform=uniform, t0=t0, idt=idt)


def _slot_lanes(lay: SphereLayout, s0: int, s1: int) -> dict:
    """The staged lanes of slots [s0, s1) as (1, B) rows."""
    S, st = lay.S, lay.staged
    q = st[:4 * S].view(S, 4)[s0:s1].t()[:, None, :]
    out = dict(cx=q[0], cy=q[1], cz=q[2], r2=q[3])
    if lay.axes == AXIS_Y:
        out["dcy"] = st[4 * S:5 * S][None, s0:s1]
    elif lay.axes == AXES_ALL:
        m = st[4 * S:8 * S].view(S, 4)[s0:s1].t()[:, None, :]
        out.update(dcx=m[0], dcy=m[1], dcz=m[2], t0=m[3])
        if not lay.uniform:
            out["idt"] = st[8 * S:9 * S][None, s0:s1]
    return out


def hit_spheres_reference(o: torch.Tensor, d: torch.Tensor,
                          time: torch.Tensor, table: torch.Tensor,
                          moving: bool, t_min: float = 0.001,
                          layout: SphereLayout | None = None):
    """Closest hit of rays o, d (N, 3) at `time` (N,) over the (S, 12)
    table: (best_t (N,) float32, BIG on a miss; best_i (N,) int64, the first
    slot with the smallest t, 0 on a miss). The kernel's arithmetic over
    the staged slots (`layout`, else `sphere_layout(table, moving)`),
    blocked over rays and slots so no temporary exceeds ~4M elements."""
    lay = layout if layout is not None else sphere_layout(table, moving)
    n, S = o.shape[0], lay.S
    best_t = torch.full((n,), BIG, dtype=torch.float32, device=o.device)
    best_i = torch.zeros((n,), dtype=torch.int64, device=o.device)
    if S == 0 or n == 0:
        return best_t, best_i
    f32 = torch.float32
    t0 = torch.tensor(lay.t0, dtype=f32, device=o.device)
    idt = torch.tensor(lay.idt, dtype=f32, device=o.device)
    step = max(1, _STEP_ELEMS // _SLOT_BLOCK)
    for r0 in range(0, n, step):
        rs = slice(r0, min(n, r0 + step))
        ox, oy, oz = (o[rs, k:k + 1] for k in range(3))
        dx, dy, dz = (d[rs, k:k + 1] for k in range(3))
        tm = time[rs, None]
        a = _fma_rn(dz, dz, _fma_rn(dx, dx, dy * dy))
        inv_a = torch.ones_like(a) / a
        fr = (tm - t0) * idt      # one window: the ray's motion fraction
        bt, bi = best_t[rs], best_i[rs]
        for s0 in range(0, S, _SLOT_BLOCK):
            q = _slot_lanes(lay, s0, min(S, s0 + _SLOT_BLOCK))
            cx, cy, cz = q["cx"], q["cy"], q["cz"]
            if lay.axes == AXIS_Y:
                cy = _fma_rn(fr, q["dcy"], cy)
            elif lay.axes == AXES_ALL:
                f = fr if lay.uniform else (tm - q["t0"]) * q["idt"]
                cx = _fma_rn(f, q["dcx"], cx)
                cy = _fma_rn(f, q["dcy"], cy)
                cz = _fma_rn(f, q["dcz"], cz)
            ocx, ocy, ocz = ox - cx, oy - cy, oz - cz
            b = _fma_rn(ocz, dz, _fma_rn(ocx, dx, ocy * dy))
            cc = _fma_rn(ocz, ocz, _fma_rn(ocx, ocx, ocy * ocy)) - q["r2"]
            disc = _fma_rn(b, b, -(a * cc))
            pos = disc > 0
            sq = torch.sqrt(torch.where(pos, disc, 1.0).double()).float()
            tn = (-b - sq) * inv_a
            tf = (-b + sq) * inv_a
            t = torch.where(tn > t_min, tn, tf)
            t = torch.where(pos & (tf > t_min), t, torch.full_like(t, BIG))
            blk_t, blk_i = t.min(dim=1)
            better = blk_t < bt
            bt = torch.where(better, blk_t, bt)
            bi = torch.where(better, blk_i + s0, bi)
        best_t[rs], best_i[rs] = bt, bi
    return best_t, best_i


def hit_spheres_kernel(o: torch.Tensor, d: torch.Tensor, time: torch.Tensor,
                       table: torch.Tensor, moving: bool,
                       t_min: float = 0.001,
                       layout: SphereLayout | None = None, lib=None):
    """Launch csrc/intersect.cu on the current CUDA stream. Same arguments
    and result as `hit_spheres_reference`; the rays are read where they
    lie (any strides), best_i is written as int64. Pass the table's
    `layout` to skip staging it (a host read of its form); `lib` is
    another build of the kernel with the same C interface (a measurement
    build, tools/culled_ab.py). Raises on a CPU tensor, a wrong shape or
    dtype, a failed build and a refused launch."""
    n = o.shape[0]
    S = table.shape[0]
    for name, t, shape in (("o", o, (n, 3)), ("d", d, (n, 3)),
                           ("time", time, (n,)),
                           ("table", table, (S, LANES))):
        if not t.is_cuda:
            raise ValueError(f"hit_spheres_kernel needs CUDA tensors; {name} "
                             f"is on {t.device}")
        if t.dtype != torch.float32 or tuple(t.shape) != shape:
            raise ValueError(f"{name}: expected float32 {shape}, got "
                             f"{t.dtype} {tuple(t.shape)}")
        if t.device != o.device:
            raise ValueError(f"{name} is on {t.device}, o on {o.device}")
    lay = layout if layout is not None else sphere_layout(table, moving)
    if lay.S != S or lay.staged.device != o.device:
        raise ValueError(f"layout of {lay.S} slots on {lay.staged.device} "
                         f"for a table of {S} on {o.device}")
    best_t = torch.empty((n,), dtype=torch.float32, device=o.device)
    best_i = torch.empty((n,), dtype=torch.int64, device=o.device)
    lib = lib or _kernel_lib()
    with torch.cuda.device(o.device):
        stream = torch.cuda.current_stream().cuda_stream
        rc = lib.rtw_hit_spheres_launch(
            o.data_ptr(), *o.stride(), d.data_ptr(), *d.stride(),
            time.data_ptr(), time.stride(0), lay.staged.data_ptr(), lay.axes,
            int(lay.uniform), lay.t0, lay.idt, best_t.data_ptr(),
            best_i.data_ptr(), n, S, float(t_min), stream)
    if rc != 0:
        raise RuntimeError(f"K7 launch failed: CUDA error {rc} "
                           f"({lib.rtw_error_string(rc).decode()})")
    KERNEL_LAUNCHES["K7"] += 1
    return best_t, best_i


def bind(lib: ctypes.CDLL) -> ctypes.CDLL:
    """Set K7's argtypes on a kernel library (the shipped build or a
    measurement build)."""
    p, i, f, q = ctypes.c_void_p, ctypes.c_int, ctypes.c_float, \
        ctypes.c_longlong
    lib.rtw_hit_spheres_launch.argtypes = [p, q, q, p, q, q, p, q, p, i, i,
                                           f, f, p, p, i, i, f, p]
    lib.rtw_hit_spheres_launch.restype = ctypes.c_int
    lib.rtw_k7_consts.argtypes = [ctypes.POINTER(ctypes.c_int)]
    lib.rtw_k7_consts.restype = None
    lib.rtw_error_string.argtypes = [ctypes.c_int]
    lib.rtw_error_string.restype = ctypes.c_char_p
    return lib


def k7_consts(lib=None) -> dict:
    """The built kernel's staging constants: rays a thread, threads a
    block, slots a streamed chunk."""
    out = (ctypes.c_int * 3)()
    (lib or _kernel_lib()).rtw_k7_consts(out)
    return dict(rays=out[0], threads=out[1], chunk=out[2])


@functools.lru_cache(maxsize=None)
def _kernel_lib() -> ctypes.CDLL:
    """The built kernel library (ops/_build.py) with K7's argtypes."""
    return bind(_build.load())
