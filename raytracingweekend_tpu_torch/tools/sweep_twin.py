"""Sweep twin: the book-1 dense sweep alone, kernel K8 and its plain version.

The port of tools/sweep_twin.py, a ceiling instrument for the book-1
megakernel. It runs only the sweep, with the port's book-1 plan (the (9, S)
sphere SoA that K1 stages in shared memory, S = 488 at T = 256 lanes a
tile), K1's slot loop, and the tool's serial bounce dependency: each
iteration's rays come from the last sweep's t (the tool's coupling
stand-in, :116-126), and the loop runs while it < K and any lane of the
block hit. So its time is a floor for K1's, and "K1 - twin" is what
shading, RNG, regeneration and tile tails really cost on the card.

    python -m raytracingweekend_tpu_torch.tools.sweep_twin [--iters 200]
        [--grid 3750] [--reps 3] [--variants quad,ext]
        [--device cuda|cpu] [--out rows.jsonl]

Variants: `quad` sweeps (moving centre, sign-flipped quadratic, rsqrt root,
near-else-far select, running best with the strict `<`); `ext` also keeps
the winner slot's 24 attribute rows. The JAX tool extracts them with a
one-hot MXU dot, which SUMS the columns of slots tied at a block's minimum;
the port reads the first tied slot's rows (csrc/sweep_twin.cu), so the two
agree where no tie occurs.

`csrc/sweep_twin.cu` runs the G grid steps at once, one block of T lanes
each (the TPU runs them one after another); every block computes the same
rays (the tool's depend only on the lane). The default G is the book-1
launch's tile count, 1200 * 800 / 256 = 3750, so the twin fills the card as
K1 does, and the default K = 200 iterations make one launch take tens of
milliseconds on an H100. One JSON row a variant goes to stdout (and to
--out when given): `us_per_iter` is the launch's time over K (the blocks
run at once; not the TPU tool's dt / (K G)), `implied_ceiling_seg_per_s`
is G T K / dt, comparable with K1's path segments/s.

The default device is `cuda` and raises without a card; `--device cpu`
runs the plain version (keep K and G tiny there).
"""
from __future__ import annotations

import argparse
import ctypes
import functools
import json
import sys

import numpy as np
import torch

from . import card_line, time_ms
from ..models.scenes import make_scene
from ..ops import _build
from ..ops import megakernel as mk
from ..ops.rounding import _fma

BIG = mk.BIG
T_MIN = 0.001
A_ROWS = mk.A_ROWS
# the book-1 launch the twin takes its plan from (bench.py's shape)
NX, NY, SPP, DEPTH = 1200, 800, 64, 50
DEFAULT_ITERS = 200
VARIANTS = ("quad", "ext")
# FP32 operations of the twin's work, counted as chip_smoke.py counts K1's
# (FMA = 2; compares, min / max and selects not counted): a slot's
# quadratic and root (co 3, nb 5, cc 6, disc 2, rsqrt, sq, tn / tf 2) and
# a motion FMA for each axis along which the plan's centres move (book-1:
# y only; K1's loop also runs the x and z ones, on zero deltas), and a
# lane-iteration's motion fraction 2 plus the coupling 16 (five FMAs and
# their five products, the time step)
OPS_SLOT_STATIC = 20
OPS_AXIS_MOTION = 2
OPS_LANE_ITER = 18
# (slot x lane) elements per step of the plain version's sweep
_STEP_ELEMS = 1 << 20

# CUDA kernel launches through `sweep_twin_kernel` in this process
KERNEL_LAUNCHES = {"K8": 0}


def book1_inputs(device) -> tuple:
    """The port's book-1 plan (random_balls, 1200x800, 64 spp, depth 50):
    (soa (9, S) float32, attr (24, S) float32, plan) on `device`; soa holds
    the sweep lanes (ops/megakernel.py SWEEP_LANES) as K1 stages them."""
    scene = make_scene("random_balls", NX / NY)
    tabs, plan = mk.make_plan(scene, NX, NY, SPP, max_depth=DEPTH)
    if not plan.uniform_time or plan.cull or plan.surfaces:
        raise ValueError("the twin needs the book-1 plan: one dense "
                         "cluster, one shutter window")
    sph, attr = tabs[0], tabs[1]
    soa = np.ascontiguousarray(sph[:, list(mk.SWEEP_LANES)].T)
    return (torch.from_numpy(soa).to(device),
            torch.from_numpy(np.ascontiguousarray(attr)).to(device), plan)


def default_grid(plan) -> int:
    """The book-1 launch's tile count."""
    return -(-plan.nx * plan.ny // plan.T)


def initial_rays(T: int, device) -> tuple:
    """The tool's closed-form rays of lanes 0..T-1 (:80-92), float32, with
    XLA:CPU's contractions: (ox, oy, oz, dx, dy, dz, time), each (T,). The
    directions are not unit length (|d|^2 ~ 0.7)."""
    lane = torch.arange(T, dtype=torch.float32, device=device)
    ox = _fma(lane, 1e-4, 13.0)
    oy = _fma(lane, 3e-5, 2.0)
    oz = _fma(lane, -2e-5, 3.0)
    inv = mk._rsqrt(_fma((lane * 1e-4) * lane, 1e-4, 3.0))
    dx = -inv
    dy = -inv * _fma(lane, 1e-5, 0.3)
    dz = -inv
    tm = lane * float(np.float32(1.0 / T))
    return ox, oy, oz, dx, dy, dz, tm


def slot_t(col: torch.Tensor, rays: tuple, fr: torch.Tensor) -> torch.Tensor:
    """K1's hit distance of each ray against each slot of col (9, B): (T, B)
    float32, BIG where the slot is missed. rays are (T, 1) columns and fr
    the rays' motion fraction; the quadratic takes |d| = 1, as K1's."""
    ox, oy, oz, dx, dy, dz = rays[:6]
    cx = _fma(fr, col[3], col[0])
    cy = _fma(fr, col[4], col[1])
    cz = _fma(fr, col[5], col[2])
    cox, coy, coz = cx - ox, cy - oy, cz - oz
    nb = _fma(coz, dz, _fma(cox, dx, coy * dy))
    cc = _fma(cox, cox, _fma(coy, coy, _fma(coz, coz, col[8])))
    disc = _fma(nb, nb, -cc)
    sq = disc * mk._rsqrt(disc)         # NaN where disc <= 0: a miss
    tn, tf = nb - sq, nb + sq
    big = torch.full_like(tn, BIG)
    return torch.where(tn > T_MIN, tn, torch.where(tf > T_MIN, tf, big))


def sweep(soa: torch.Tensor, rays: tuple, ut_t0: float, ut_idt: float):
    """K1's sweep of every slot of soa (9, S) for each ray: (best (T,)
    float32, BIG on a miss; slot (T,) int64, the first slot with the
    smallest t, S on a miss)."""
    rays = tuple(r[:, None] for r in rays)
    S, n = soa.shape[1], rays[0].shape[0]
    fr = (rays[6] - ut_t0) * ut_idt
    best = torch.full((n,), BIG, dtype=torch.float32, device=soa.device)
    bidx = torch.full_like(best, S, dtype=torch.int64)
    step = max(1, _STEP_ELEMS // max(1, n))
    for s0 in range(0, S, step):
        t = slot_t(soa[:, s0:s0 + step], rays, fr)
        blk = t.min(dim=1).values
        slots = torch.arange(s0, s0 + t.shape[1], device=t.device)
        first = torch.where(t == blk[:, None], slots, S).min(dim=1).values
        better = blk < best
        best = torch.where(better, blk, best)
        bidx = torch.where(better, first, bidx)
    return best, bidx


def _couple(rays: tuple, best: torch.Tensor) -> tuple:
    """The tool's next rays from this sweep's t (:116-126)."""
    ox, oy, oz, dx, dy, dz, tm = rays
    tcl = torch.clamp_max(best, 100.0)
    return (_fma(ox, 0.999, 0.001 * tcl), _fma(oy, 0.999, 0.0003 * tcl),
            _fma(oz, 0.999, -(0.0002 * tcl)), _fma(dx, 0.9999, 1e-5 * tcl),
            _fma(dy, 0.9999, -(1e-5 * tcl)), dz,
            torch.clamp_max(tm + 1e-4, 1.0))


def sweep_twin_reference(soa: torch.Tensor, attr: torch.Tensor, T: int,
                         G: int, K: int, ut_t0: float, ut_idt: float,
                         ext: bool):
    """The plain version: (out (G, 2, T) float32, rows ox and iterations;
    attrs (G, 24, T) float32 with ext, else None). Every grid step computes
    the same rays, so one block is traced and repeated G times."""
    rays = initial_rays(T, soa.device)
    af = torch.zeros((A_ROWS, T), dtype=torch.float32, device=soa.device)
    iters = 0
    for _ in range(K):
        best, bidx = sweep(soa, rays, ut_t0, ut_idt)
        if ext:
            hit = best < BIG
            rows = attr[:, torch.clamp_max(bidx, soa.shape[1] - 1)]
            af = torch.where(hit[None], rows, af)
        rays = _couple(rays, best)
        iters += 1
        if not bool((best < BIG).any()):
            break
    block = torch.stack([rays[0], torch.full_like(rays[0], float(iters))])
    out = block[None].expand(G, 2, T).contiguous()
    return out, (af[None].expand(G, A_ROWS, T).contiguous() if ext else None)


def sweep_twin_kernel(soa: torch.Tensor, attr: torch.Tensor, T: int, G: int,
                      K: int, ut_t0: float, ut_idt: float, ext: bool):
    """Launch csrc/sweep_twin.cu on the current CUDA stream. Same arguments
    and result as `sweep_twin_reference`. Raises on a CPU tensor, a wrong
    shape or dtype, a failed build and a refused launch."""
    S = soa.shape[-1]
    for name, t, shape in (("soa", soa, (len(mk.SWEEP_LANES), S)),
                           ("attr", attr, (A_ROWS, S))):
        if not t.is_cuda:
            raise ValueError(f"sweep_twin_kernel needs CUDA tensors; {name} "
                             f"is on {t.device}")
        if t.dtype != torch.float32 or tuple(t.shape) != shape:
            raise ValueError(f"{name}: expected float32 {shape}, got "
                             f"{t.dtype} {tuple(t.shape)}")
        if t.device != soa.device:
            raise ValueError(f"{name} is on {t.device}, soa on {soa.device}")
    if G < 1 or K < 0:
        raise ValueError(f"G={G} must be >= 1 and K={K} >= 0")
    soa, attr = soa.contiguous(), attr.contiguous()
    out = torch.empty((G, 2, T), dtype=torch.float32, device=soa.device)
    attrs = (torch.empty((G, A_ROWS, T), dtype=torch.float32,
                         device=soa.device) if ext else out)
    lib = _kernel_lib()
    with torch.cuda.device(soa.device):
        stream = torch.cuda.current_stream().cuda_stream
        rc = lib.rtw_sweep_twin_launch(
            soa.data_ptr(), attr.data_ptr(), out.data_ptr(),
            attrs.data_ptr(), S, T, G, K, int(ext), float(ut_t0),
            float(ut_idt), float(np.float32(1.0 / T)), stream)
    if rc != 0:
        raise RuntimeError(f"K8 launch failed: CUDA error {rc} "
                           f"({lib.rtw_error_string(rc).decode()})")
    KERNEL_LAUNCHES["K8"] += 1
    return out, (attrs if ext else None)


def sweep_twin(soa, attr, T, G, K, ut_t0, ut_idt, ext):
    """The kernel for CUDA tensors, the plain version for CPU tensors."""
    fn = sweep_twin_kernel if soa.is_cuda else sweep_twin_reference
    return fn(soa, attr, T, G, K, ut_t0, ut_idt, ext)


def _best_ms(fn, device, reps: int):
    """Best of `reps` calls of fn() after a warm-up, in ms, and the last
    result."""
    out = fn()
    best = None
    for _ in range(max(1, reps)):
        ms, out = time_ms(fn, device)
        best = ms if best is None else min(best, ms)
    return best, out


def run(variants=VARIANTS, K: int = DEFAULT_ITERS, G: int = 0,
        reps: int = 3, device="cuda", outputs: list | None = None) -> list:
    """Time each variant at the book-1 plan: one row a variant (see the
    module docstring). Raises if a launch stops before K iterations. With
    `outputs`, each variant's last timed (out, attrs) is appended to it."""
    device = torch.device(device)
    where = card_line(device.type)
    soa, attr, plan = book1_inputs(device)
    S, T = soa.shape[1], plan.T
    G = G or default_grid(plan)
    rows = []
    for variant in variants:
        if variant not in VARIANTS:
            raise ValueError(f"variant {variant!r} is not one of {VARIANTS}")
        ms, (out, attrs) = _best_ms(
            lambda: sweep_twin(soa, attr, T, G, K, plan.ut_t0, plan.ut_idt,
                               variant == "ext"), device, reps)
        if outputs is not None:
            outputs.append((out, attrs))
        iters_done = float(out[0, 1, 0])
        if iters_done != K:   # no early exit: every lane keeps hitting
            raise RuntimeError(f"{variant}: {iters_done} iterations of {K}")
        dt = ms * 1e-3
        rows.append({"variant": variant, "S": S, "EE": 1, "T": T,
                     "iters": K, "grid": G, "G": G, "K": K, "ms": ms,
                     "us_per_iter": dt / K * 1e6,
                     "implied_ceiling_seg_per_s": G * T * K / dt,
                     "iters_done": iters_done,
                     "checksum": float(out.sum(dtype=torch.float64)),
                     "device": where})
    return rows


def bound_ms(S: int, T: int, G: int, iters: float,
             moving_axes: tuple) -> float:
    """Least time of a twin launch: its FP32 operations (a slot's
    OPS_SLOT_STATIC plus OPS_AXIS_MOTION for each of the plan's
    `moving_axes`, and OPS_LANE_ITER a lane-iteration) over the H100's
    67 TFLOP/s. Bytes do not bound it: the launch reads 36 S + 96 S bytes
    and writes 8 (ext: 104) bytes a lane."""
    slot = OPS_SLOT_STATIC + OPS_AXIS_MOTION * sum(map(bool, moving_axes))
    return G * T * iters * (S * slot + OPS_LANE_ITER) / 67e12 * 1e3


@functools.lru_cache(maxsize=None)
def _kernel_lib() -> ctypes.CDLL:
    """The built kernel library (ops/_build.py) with K8's argtypes."""
    lib = _build.load()
    p, i, f = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
    lib.rtw_sweep_twin_launch.argtypes = [p, p, p, p, i, i, i, i, i, f, f, f,
                                          p]
    lib.rtw_sweep_twin_launch.restype = ctypes.c_int
    lib.rtw_error_string.argtypes = [ctypes.c_int]
    lib.rtw_error_string.restype = ctypes.c_char_p
    return lib


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--iters", type=int, default=DEFAULT_ITERS)
    ap.add_argument("--grid", type=int, default=0,
                    help="grid steps (0: the book-1 launch's tile count)")
    ap.add_argument("--reps", type=int, default=3)
    ap.add_argument("--variants", default=",".join(VARIANTS))
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--out", default="",
                    help="append the rows here as JSON lines")
    args = ap.parse_args(argv)
    rows = run(args.variants.split(","), args.iters, args.grid, args.reps,
               args.device)
    for row in rows:
        print(json.dumps(row), flush=True)
    if args.out:
        with open(args.out, "a") as f:
            for row in rows:
                f.write(json.dumps(row) + "\n")
    return 0


if __name__ == "__main__":
    sys.exit(main())
