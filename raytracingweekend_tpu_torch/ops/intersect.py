"""Closest sphere hit of a wavefront of rays: kernel K7 and its plain version.

The port of raytracingweekend_tpu/ops/pallas_intersect.py. `pack_spheres`
packs the sphere table as the CUDA kernel reads it (12 float32 a slot:
three float4, no 128-lane padding and no MXU lanes);
`hit_spheres_kernel` launches csrc/intersect.cu on CUDA tensors and
`hit_spheres_reference` is its plain PyTorch version (geometry.hit_spheres
takes the kernel for CUDA tensors and the plain version for CPU tensors).

Both compute the JAX kernel's arithmetic with the FMAs XLA's CPU backend
contracts written out (ops/rounding.py), and agree with it bit for bit on
the CPU (tests/test_torch_intersect.py).
"""
from __future__ import annotations

import ctypes
import functools

import numpy as np
import torch

from . import _build
from .rounding import _fma

BIG = 3.0e37
# the table's lanes: q0 = (cx, cy, cz, r^2), q1 = (dcx, dcy, dcz, t0),
# q2 = (1/dt, active, 0, 0)
(K_CX, K_CY, K_CZ, K_R2, K_DCX, K_DCY, K_DCZ, K_T0, K_IDT, K_ACT) = range(10)
LANES = 12
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


def hit_spheres_reference(o: torch.Tensor, d: torch.Tensor,
                          time: torch.Tensor, table: torch.Tensor,
                          moving: bool, t_min: float = 0.001):
    """Closest hit of rays o, d (N, 3) at `time` (N,) over the (S, 12)
    table: (best_t (N,) float32, BIG on a miss; best_i (N,) int64, the first
    slot with the smallest t, 0 on a miss). Blocked over rays and slots so
    no temporary exceeds ~4M elements."""
    n = o.shape[0]
    best_t = torch.full((n,), BIG, dtype=torch.float32, device=o.device)
    best_i = torch.zeros((n,), dtype=torch.int64, device=o.device)
    S = table.shape[0]
    if S == 0 or n == 0:
        return best_t, best_i
    step = max(1, _STEP_ELEMS // _SLOT_BLOCK)
    for r0 in range(0, n, step):
        rs = slice(r0, min(n, r0 + step))
        ox, oy, oz = (o[rs, k:k + 1] for k in range(3))
        dx, dy, dz = (d[rs, k:k + 1] for k in range(3))
        tm = time[rs, None]
        a = _fma(dz, dz, _fma(dx, dx, dy * dy))
        inv_a = torch.ones_like(a) / a
        bt, bi = best_t[rs], best_i[rs]
        for s0 in range(0, S, _SLOT_BLOCK):
            q = table[s0:s0 + _SLOT_BLOCK].t()[:, None, :]    # (12, 1, B)
            cx, cy, cz = q[K_CX], q[K_CY], q[K_CZ]
            if moving:
                frac = (tm - q[K_T0]) * q[K_IDT]
                cx = _fma(frac, q[K_DCX], cx)
                cy = _fma(frac, q[K_DCY], cy)
                cz = _fma(frac, q[K_DCZ], cz)
            ocx, ocy, ocz = ox - cx, oy - cy, oz - cz
            b = _fma(ocz, dz, _fma(ocx, dx, ocy * dy))
            cc = _fma(ocz, ocz, _fma(ocx, ocx, ocy * ocy)) - q[K_R2]
            disc = _fma(b, b, -(a * cc))
            sq = torch.sqrt(torch.clamp_min(disc, 0.0).double()).float()
            tn = (-b - sq) * inv_a
            tf = (-b + sq) * inv_a
            t = torch.where(tn > t_min, tn, tf)
            valid = (disc > 0) & (t > t_min) & (q[K_ACT] > 0)
            t = torch.where(valid, t, torch.full_like(t, BIG))
            blk_t, blk_i = t.min(dim=1)
            better = blk_t < bt
            bt = torch.where(better, blk_t, bt)
            bi = torch.where(better, blk_i + s0, bi)
        best_t[rs], best_i[rs] = bt, bi
    return best_t, best_i


def hit_spheres_kernel(o: torch.Tensor, d: torch.Tensor, time: torch.Tensor,
                       table: torch.Tensor, moving: bool,
                       t_min: float = 0.001):
    """Launch csrc/intersect.cu on the current CUDA stream. Same arguments
    and result as `hit_spheres_reference` (best_i int64). Raises on a CPU
    tensor, a wrong shape or dtype, a failed build and a refused launch."""
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
    best_t = torch.empty((n,), dtype=torch.float32, device=o.device)
    best_i = torch.empty((n,), dtype=torch.int32, device=o.device)
    rays = torch.cat([o.t(), d.t(), time[None]]).contiguous()    # (7, N)
    table = table.contiguous()
    lib = _kernel_lib()
    with torch.cuda.device(o.device):
        stream = torch.cuda.current_stream().cuda_stream
        rc = lib.rtw_hit_spheres_launch(
            rays.data_ptr(), table.data_ptr(), best_t.data_ptr(),
            best_i.data_ptr(), n, S, int(moving), float(t_min), stream)
    if rc != 0:
        raise RuntimeError(f"K7 launch failed: CUDA error {rc} "
                           f"({lib.rtw_error_string(rc).decode()})")
    KERNEL_LAUNCHES["K7"] += 1
    return best_t, best_i.long()


@functools.lru_cache(maxsize=None)
def _kernel_lib() -> ctypes.CDLL:
    """The built kernel library (ops/_build.py) with K7's argtypes."""
    lib = _build.load()
    p, i, f = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
    lib.rtw_hit_spheres_launch.argtypes = [p, p, p, p, i, i, i, f, p]
    lib.rtw_hit_spheres_launch.restype = ctypes.c_int
    lib.rtw_error_string.argtypes = [ctypes.c_int]
    lib.rtw_error_string.restype = ctypes.c_char_p
    return lib
