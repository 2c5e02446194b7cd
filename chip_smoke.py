#!/usr/bin/env python3
"""Smoke test of the PyTorch/CUDA port on one NVIDIA GPU.

Run from the root of a checkout:

    python3 chip_smoke.py

It builds the port's CUDA kernels from the sources in the checkout,
prints their registers and the sphere sweeps' SASS a slot, and each
surfaces form's registers, spills (none allowed), rect and light loops,
MUFU and loads, checks the dense kernels' tile widths (every dense
instantiation takes blocks of DENSE_MAX_T lanes, a wider tile is refused
before any launch, the widest agrees with the plain version, on a scene
of every static surfaces form), holds each kernel against its plain
PyTorch version on the card (with the surfaces kernel's cycle split and
grid tail beside its bound for cornell_box, cornell_smoke, earth and
two_perlin_spheres), checks the renderer
against the reference oracle's golden images, and drives the port's four
paths through `render()`: book-1 `random_balls` at 1200x800, 64 spp per
launch, max_depth 50 (kernel K1); the Cornell path, `cornell_box` then
`cornell_smoke` at 400x400, 256 spp in launches of 64, max_depth 50
(kernels K2 and K3: rects, lights with one-sample MIS, emission, constant
media); the texture path, `earth` and `earth_rect` on the reference
oracle's texels (tools/reference_oracle/earth.rtwi), `two_perlin_spheres`,
`light_sample` and `checker_spheres` at 800x600, 64 spp, max_depth 50
(kernel K4: checker, Perlin-noise and image textures); and the large-S
path, `random_balls_large` (3604 spheres) at 1200x800, 32 spp per launch,
and `random_balls_huge` (14404) at 16, max_depth 50 (kernel K5: cluster
culling), where the culled kernel is also held to the dense one bit for
bit, with its warp and per-lane survivals (rows 6 and 7: the clusters a
warp swept, the clusters each lane's own ray needed) and the split of its
warps' cycles from a build instrumented with clock64 (RTW_SPLIT,
tools/culled_ab.py); and the mixed large-S path, the probe `large_mixed` of
models/probe_scenes.py (random_balls_large's grid with a checker ground, a
rect light with MIS, an emissive sphere and a medium) at n = 60 (3605
spheres) 1200x800x32 a launch and n = 120 (14405) x16, depth 50, through
render(loop_mode="auto") (kernel K5s: the culled sweep ahead of the rects,
media and textures), held to the dense surfaces kernel bit for bit at
n = 60. Each kernel is held to its plain version at its path's full launch
shape. Then the wavefront path (kernel K7, the closest sphere hit): K7's
registers, spills and slot loop SASS a ray-slot pair, and K7 against its
plain version bit for bit on the rays of the first regen iterations of
`random_balls`, `random_balls_large` and `random_balls_huge` (N = 524,288
rays), the path-regenerative wavefront on `random_balls` at 1200x800, 8
spp, max_depth 50 (timed, with K7's share), the other wavefront paths
(regen on the Cornell scenes, tiled, while, normal shading, a non-MIS
strategy, the BVH scene) and the goldens through regen. Then the gradient
path (grad.py, ops/mega_grad.py): K7's VJP (geometry.HitSpheres) with the
kernel forward against the plain forward on random_balls regen rays at
N = 524,288; one megakernel gradient step at tools/grad_bench.py's
workload (cornell_box 128x128, 32 spp, depth 8, T = 1024, w.r.t. the
texture colours: the tape launch, the replay, its value and gradient,
the replay image against the kernel's, central differences through the
kernel); an inverse-rendering fit of a perturbed wall colour; and the
wavefront gradient (`render_diff`) on cornell_box at the same workload and
on random_balls w.r.t. the radii, checked against the CPU's plain path.
Last, the two measurement instruments (raytracingweekend_tpu_torch/tools):
the sweep twin (kernel K8, the book-1 sweep alone on K1's plan, both
variants at the book-1 launch's width, held to its plain version bit for
bit, its implied ceiling beside K1's segments/s and its slot loop's SASS
beside K1's) and the dot-formulation microbenchmark (kernel K9, every row
of the tool at S = 512, T = 2048 with its torch.matmul yardstick, held to
its plain version, its registers and spills). Then the Mosaic repros
(raytracingweekend_tpu_torch/tools/mosaic_repros, kernels K10-K14 in
csrc/mosaic_repros.cu): every one of their ten formulations at its
repro's shapes, held to its plain version, each pair's forms to each
other and K13's probes to the repro's expected arrays, with K10's I2F
counts from the build, the launch floor (an empty kernel launched
through the repros' launcher: its CUDA-event mean and device time), the
spread of K11's two forms against torch.mul on the device clock over
several profiles, the host spread of K11's and K14's forms against their
yardsticks (torch.mul, TF32 torch.matmul) in rounds of CUDA-event means,
and where the host time of a K11 call goes; and the sixth
repro, the port's tiled integrator at the T = 32768 tile the TPU faults on
(random_balls 1200x800, 16 spp, depth 8), against T = 65536.
It prints one line per phase and each phase's seconds.
Any failure exits non-zero; without a CUDA device it exits non-zero
before printing any result. The last line is one JSON object naming the
device.
"""
from __future__ import annotations

import contextlib
import json
import os
import re
import struct
import subprocess
import sys
import tempfile
import time

import numpy as np
import torch

from raytracingweekend_tpu_torch import grad as tgrad
from raytracingweekend_tpu_torch.models import (builder, probe_scenes,
                                                scene_types)
from raytracingweekend_tpu_torch.models.scenes import make_scene
from raytracingweekend_tpu_torch.ops import _build
from raytracingweekend_tpu_torch.ops import geometry
from raytracingweekend_tpu_torch.ops import intersect as k7
from raytracingweekend_tpu_torch.ops import mega_grad as mg
from raytracingweekend_tpu_torch.ops import megakernel as mk
from raytracingweekend_tpu_torch.ops.syncs import CHECK_EVERY, SYNCS
from raytracingweekend_tpu_torch.render import (RenderStats, render,
                                                resolve_mode)
from raytracingweekend_tpu_torch.tools import culled_ab
from raytracingweekend_tpu_torch.tools import dot_microbench as k9
from raytracingweekend_tpu_torch.tools import mosaic_repros
from raytracingweekend_tpu_torch.tools import sass
from raytracingweekend_tpu_torch.tools import sweep_twin as k8
from raytracingweekend_tpu_torch.tools.mosaic_repros import (launch_floor,
                                                             tile_32768)
from raytracingweekend_tpu_torch.tools.mosaic_repros._common import launch_us
from raytracingweekend_tpu_torch.utils import image as image_mod
from raytracingweekend_tpu_torch.utils import prng
from raytracingweekend_tpu_torch.utils.config import RenderConfig

REPO = os.path.dirname(os.path.abspath(__file__))
GOLDEN_DIR = os.path.join(REPO, "tests", "goldens")
# kernel vs plain version: the replay gate of tests/test_mega_grad.py
RTOL, ATOL = 1e-3, 5e-5
MIN_SAME = 0.99       # fraction of lanes / pixels that must agree
NX, NY, SPP, DEPTH = 1200, 800, 64, 50   # the book-1 path (bench.py)
# the Cornell path: tools/bench_all.py:24-25 (400x400, 256 spp, depth 50)
CNX, CNY, CSPP, CLAUNCH, CDEPTH = 400, 400, 256, 64, 50
CORNELL_PATH = ("cornell_box", "cornell_smoke")
# the texture path: tools/bench_all.py:26-27 (earth, earth_rect at 800x600,
# 64 spp) and the other texture scenes at the same shape, 5 timed launches
TNX, TNY, TSPP, TLAUNCHES, TDEPTH = 800, 600, 64, 5, 50
# the plain version of the Perlin scenes takes seconds per 200x150x16
# launch; at the full launch shape it traces every 8th tile only
PLAIN_TILE_STRIDE = {"two_perlin_spheres": 8, "light_sample": 8}
# the large-S path: tools/bench_all.py:28-29 (1200x800 at 32 and 16 spp per
# launch), three timed launches a scene; the plain version of the culled
# sweep takes ~C tensor rounds a bounce, so at this shape it traces every
# LARGE_TILE_STRIDE-th tile only
LNX, LNY, LLAUNCHES, LDEPTH = 1200, 800, 3, 50
LARGE_PATH = (("random_balls_large", 32), ("random_balls_huge", 16))
LARGE_TILE_STRIDE = 4
# the mixed large-S path (K5s): the probe at random_balls_large's and
# random_balls_huge's launch shapes; its untextured moving variant (the
# kTex = false, moving instantiations) against its plain version at MSMALL
MIXED_PATH = ((60, 32), (120, 16))
MSMALL = (600, 400, 16)
RTWI = os.path.join(REPO, "tools", "reference_oracle", "earth.rtwi")
# a scene that plans each static surfaces form (ops/megakernel.py
# SURFACE_FORMS: image, rects + image, noise, rects + noise, checker,
# rects + lights, every untextured feature, every feature)
SURFACE_SCENES = (("earth", {"image_path": RTWI}),
                  ("earth_rect", {"image_path": RTWI}),
                  ("two_perlin_spheres", {}), ("light_sample", {}),
                  ("checker_spheres", {}), ("cornell_box", {}),
                  ("cornell_smoke", {}), ("texture_mix", {}))
# the cells of the surfaces split (phases 7, 9)
SPLIT_CELLS = ("cornell_box", "cornell_smoke", "earth", "two_perlin_spheres")
TEXTURE_PATH = (("earth", {"image_path": RTWI}),
                ("earth_rect", {"image_path": RTWI}),
                ("two_perlin_spheres", {}), ("light_sample", {}),
                ("checker_spheres", {}))
SEED = 20240601
# the wavefront path (K7): random_balls through the path-regenerative
# wavefront at 1200x800, 8 spp in one launch, depth 50 (n_slots = 2^19
# rays in flight); K7 is held to its plain version on the rays of the first
# K7_ITERS regen iterations of the three sphere scenes
WNX, WNY, WSPP, WDEPTH = 1200, 800, 8, 50
K7_SCENES = ("random_balls", "random_balls_large", "random_balls_huge")
K7_ITERS = 3
# K7's staged forms (kAxes, kUniform), one instantiation each
K7_FORMS = ((0, 1), (2, 1), (7, 1), (7, 0))
# FP32 operations per (ray, slot) pair of K7, counted from
# csrc/intersect.cu as below (they equal the JAX kernel's cost estimate,
# pallas_intersect.py:156-160): co 3, b 5, cc 6, disc 3, sqrt 1, tn / tf 4;
# moving centres add the fraction (OPS_SLOT_SHUTTER) and a motion FMA
# (OPS_AXIS_MOTION) for each axis the centres move along
OPS_K7_PAIR = 22
HBM_PEAK = 3.35e12            # H100 SXM bytes/s
# the goldens through regen, their spp cut to keep the script's time
# (the wavefront is host-bound: ~2,500 small kernels an iteration)
REGEN_GOLDEN_SPP = {"random_balls_128x128_2048spp.bin": 512,
                    "dielectric_32x32_4096spp.bin": 1024,
                    "cornell_box_128x128_8192spp.bin": 1024,
                    "cornell_box_32x32_8192spp.bin": 2048,
                    "cornell_smoke_32x32_8192spp.bin": 2048,
                    "light_sample_32x32_4096spp.bin": 1024}
# the other wavefront paths, at smaller shapes
WAVEFRONT_PATHS = (
    ("cornell_box", {}, 400, 400, 4, "regen", {}),
    ("cornell_smoke", {}, 400, 400, 4, "regen", {}),
    ("random_balls", {}, 300, 200, 4, "tiled", {}),
    ("random_balls", {}, 300, 200, 4, "while", {}),
    ("random_balls", {}, 1200, 800, 1, "regen", {"normals": True}),
    ("cornell_box", {}, 400, 400, 4, "regen",
     {"lambertian_strategy": "hemisphere"}),
    ("random_balls_large", {"use_bvh": True}, 1200, 800, 1, "auto", {}))

# the gradient path: tools/grad_bench.py's workload (cornell_box 128x128,
# 32 spp, max_depth 8, tape T = 1024, parameters textures.color); the fit
# of tests/test_mega_grad.py:431-457 (wall colour 1 set to 0.2, 12 Adam
# steps at lr 0.08, depth 4) at GFIT; K7's VJP on regen rays; the wavefront
# gradient on random_balls w.r.t. the radii (GRB), checked against the
# CPU's plain path at GCPU
GNX, GNY, GSPP, GDEPTH, GT = 128, 128, 32, 8, 1024
GFIT = (64, 64, 8, 4)           # nx, ny, spp, depth
GRB = (128, 128, 4, 8)
GCPU = (16, 16, 2, 8)
G_MAX_OUT = 0.005               # replay pixels allowed outside the gate
# texture colour entries of the FD check and their steps: two albedos at
# tests/test_mega_grad.py's eps 1e-3, and the light's emission (15.0) at
# 1e-2, the same step relative to its value: at 1e-3 its FD is float32
# noise (the emission-dominated pixels' 32-sample sums round by ~1e-5 of
# a 3e-2 change; 5e-3 off at this workload in the first run, 3.3e-4 /
# 7.5e-5 at eps 1e-3 / 1e-2 on the CPU at 32x32x8)
G_FD = (((1, 0), 1e-3), ((0, 0), 1e-3), ((3, 2), 1e-2))
K7_GRAD_RTOL = 1e-5

# FP32 operations of a path segment, counted from csrc/megakernel.cu (add,
# sub, mul, div, sqrt, rsqrt, log, exp = 1, FMA = 2; compares, min / max,
# selects and the integer RNG hash not counted). A segment pays the
# closest-hit search, the floor, and the shading of what it hit; the mix
# of what segments hit is measured in this run (`segment_mix`).
OPS_SLOT_STATIC = 20          # sweep slot: co 3, nb 5, cc 6, disc 2, rsqrt,
#                               sq, tn / tf 2
OPS_AXIS_MOTION = 2           # a motion FMA per axis the centres move along
OPS_SLOT_SHUTTER = 2          # per-slot motion fraction (no uniform shutter)
OPS_RECT = 6                  # (k - o_n) * 1/d_n, two plane-point FMAs
OPS_GROUP = {0: 0, 1: 17, 2: 3, 3: 17}   # object-space ray per transform
#                               group (rotated | translated << 1)
OPS_MEDIUM = {0: 38, 1: 32}   # sphere / box medium boundary, with log and
#                               FMA of the scatter distance (rotated form)
OPS_RECIPROCALS = 3           # 1/d of a surfaces segment
OPS_FLOOR = 32                # count 1, hit point 6, ddn + mirror 12,
#                               normalise 9, throughput 3, depth 1
OPS_SPHERE_NORMAL = 6         # (p - c) / r (+ the centre's motion)
OPS_SHADE = {"lambertian": 70,  # cosine sample 5, cossin2pi 31, ONB 19,
             #                    direction 15
             "metal": 50,       # ball 44 (cossin2pi, exp(log / 3)), fuzz 6
             "dielectric": 47,  # Schlick, exit cosine, refraction
             "light": 6,        # one-sided emission
             "medium": 44,      # isotropic: the ball sample
             "miss": 0}         # black sky (+ 6 for the gradient)
OPS_MIS = 24                  # pick 1, mixture direction 15, pdf_val 4,
#                               weight 4
OPS_LIGHT_DIR = {0: 9, 1: 89}     # rect / sphere light sample
OPS_LIGHT_PDF = {0: 10, 1: 27}    # rect / sphere light pdf, with the sum
OPS_REGEN = 34                # new camera ray, per path end
# cluster culling (K5), per segment: the ray's reciprocals, then C slab
# votes (6 sub + 6 mul; with near-to-far order these are the geometric
# votes, and each swept block adds a re-vote) and a re-vote's entry
# shrink (1 mul); the blocks the lane's own ray needed (row 7) pay SB
# slots each (the warp's swept blocks, row 6, in the warp-vote bound)
OPS_VOTE = 12
OPS_REVOTE = 13
# textures (K4), per textured hit. One Perlin evaluation: floor and
# fraction 6, smoothsteps 12, corner offsets and weights 6, 8 corners of
# dot 5, weight 2, accumulate 2 = 96
OPS_PERLIN = 96
OPS_TURB = 7 * (OPS_PERLIN + 7)   # 7 octaves: scaled point 3, weight and
#                                   sum 2, octave scale 2
OPS_TEXTURE = {"marble": OPS_TURB + 6,   # 10 t, FMA, sin, 0.5 (1 + .)
               "smooth": OPS_PERLIN + 5,  # scaled point 3, 0.5 (1 + .)
               "turb": OPS_TURB + 3,      # scaled point 3
               "checker": 8,              # 3 x sin(10 p), two products
               "image_sphere": 44,        # 2 polynomial atan2 32, asin 3,
               #                            u v 5, texel index 4
               "image_rect": 8,           # planar uv 4, texel index 4
               "image_medium": 4}         # texel index at uv (0, 0)
FP32_PEAK = 67e12             # H100 SXM, outside the tensor cores
# the instruments: K8 held to its plain version at K8_CHECK iterations,
# K9 at K9_CHECK steps, both at their paths' widths
K8_CHECK = 4
K9_S, K9_T, K9_N, K9_REPS, K9_CHECK = 512, 2048, 64, 5, 8
# K11's spread against torch.mul: device-clock profiles a form
K11_ROUNDS = 5
MATERIALS = ("lambertian", "metal", "dielectric", "light")
# what the culled kernels' (K5, K5s) sweep does, for the kernels line
REDESIGN = (f"a cluster swept only for the lanes whose rays need it, "
            f"compacted below {mk.K_BCAST} needing lanes, static spheres' "
            "centre quads staged in shared memory by cp.async")
# what the dense slot loop (K1, K8) does since its redesign
REDESIGN_DENSE = ("slots staged in shared memory as a 16-byte quad and only "
                  "the motion lanes the plan's moving axes need, the loop "
                  "specialised on that mask, a one-compare hit test, "
                  f"launch bounds of {mk.DENSE_MAX_T} lanes")

# what K7 and K9 do since their redesign
REDESIGN_K7 = ("slots staged in shared memory as a 16-byte quad (r^2 = -inf "
               "on inactive slots) and only the table's motion lanes, the "
               "motion fraction once a ray under one shutter window, the "
               "exact root without sqrt.rn's range check, rays "
               "register-blocked a thread, "
               "long tables streamed by cp.async, rays read in place")
# what the surfaces kernels (K2+K3, K4) do since their redesign
REDESIGN_SURFACES = ("one instantiation a feature set (rects, MIS lights, "
                     "media, image, checker, noise textures) picked by "
                     "make_plan, so a form compiles only what its scenes "
                     "use; rects staged in runs by transform group and "
                     "axis (two float4 a row, compile-time plane lanes, a "
                     "branchless test, ties to the lower row); the camera "
                     "vector in shared memory; the sweep up to the last "
                     "live slot; Perlin gradients as float4; overdraw "
                     "blocks longest tile first (learned from the last "
                     "launch); exact-mode blocks of 64 lanes")
REDESIGN_K9 = ("8 columns a block of 16 warps (every SM, 32 warps an SM), "
               "parity buffers for fewer block barriers a step, mma.sync "
               "tensor-core tiles with register-held A fragments, the FP32 "
               "extract's sums split over the warps in a fixed order, "
               "minmask's columns on two warps each, joined by a named "
               "barrier")

# nvidia-smi's name and power limit of the card, set by phase 1
DEVICE_LINE = ""


def fail(msg: str):
    raise SystemExit(f"chip_smoke: FAIL: {msg}")


def ops_per_segment(plan, mix: dict, blocks: float = 1.0,
                    needed: float | None = None) -> float:
    """The FP32 operations of an average path segment of `plan` whose
    hits are distributed as `mix` (fractions of segments: miss, medium,
    sphere, and the material of each surface hit; ends = paths ended per
    segment); a culled plan re-votes `blocks` clusters a segment and
    sweeps the slots of `needed` (default `blocks`)."""
    needed = blocks if needed is None else needed
    ops = float(OPS_FLOOR)
    if plan.has_spheres:
        slot = OPS_SLOT_STATIC
        axes = sum(map(bool, plan.moving_axes))
        if axes:
            slot += OPS_AXIS_MOTION * axes
            if not plan.uniform_time:
                slot += OPS_SLOT_SHUTTER
        if plan.cull:
            ops += (OPS_RECIPROCALS + needed * plan.SB * slot
                    + (plan.C * OPS_VOTE + blocks * OPS_REVOTE
                       if plan.dyn_order else plan.C * OPS_REVOTE))
        else:
            ops += plan.S * slot
        ops += mix["sphere"] * (OPS_SPHERE_NORMAL + (
            OPS_SLOT_SHUTTER + OPS_AXIS_MOTION * axes if axes else 0))
    if plan.surfaces:
        ops += OPS_RECIPROCALS + plan.R * OPS_RECT
        groups = {c >> 4: (c >> 2) & 3 for c in plan.rect_codes}
        ops += sum(OPS_GROUP[g] for g in groups.values())
        ops += sum(OPS_MEDIUM[c & 1] for c in plan.med_codes)
    for kind, n in OPS_SHADE.items():
        ops += mix[kind] * n
    ops += mix["miss"] * 6 * plan.bg_gradient
    for kind, n in OPS_TEXTURE.items():
        ops += mix.get("tex_" + kind, 0.0) * n
    if plan.L:
        kinds = [c & 1 for c in plan.light_codes]
        ops += mix["lambertian"] * (
            OPS_MIS + sum(OPS_LIGHT_DIR[k] for k in kinds) / plan.L
            + sum(OPS_LIGHT_PDF[k] for k in kinds))
    return ops + mix["ends"] * OPS_REGEN


def segment_mix(scene) -> dict:
    """What path segments hit, as fractions of all segments: one kernel
    launch in exact-spp mode (64x64, 8 spp, depth 50) and its winner tape,
    decoded with the scene's tables (materials, and the texture each hit
    evaluates)."""
    _, plan = mk.make_plan(scene, 64, 64, 8, max_depth=DEPTH, exact=True)
    args, _ = mk.device_inputs(scene, plan, "cuda")
    out = mk.mega_kernel(*args, SEED, plan)
    attr_tab, rect_tab, med_tab = args[3], args[5], args[7]
    tape = out[:, mk.OUT_ROWS:, :]                   # (tiles, iters, T)
    it = torch.arange(tape.shape[1], device=tape.device)[None, :, None]
    code = tape[it < out[:, 4:5, :]].long()          # each lane's own
    n = code.numel()
    S, R = plan.S, plan.R
    sph = (code >= 0) & (code < S)
    rec = (code >= S) & (code < S + R)
    med = code >= S + R
    mtype = torch.full_like(code, -1)
    mtype[sph] = attr_tab[mk.A_MTYPE, code[sph]].long()
    mtype[rec] = rect_tab[code[rec] - S, mk.RT_MTYPE].long()
    mix = {kind: (mtype == m).sum().item() / n
           for m, kind in enumerate(MATERIALS)}
    mix.update(miss=(code < 0).sum().item() / n,
               medium=med.sum().item() / n,
               sphere=sph.sum().item() / n,
               ends=out[:, 5, :].sum().item() / out[:, 3, :].sum().item())
    # the texture lanes of each hit: 1 + NOISE_* (0 marble, 1 smooth,
    # 2 turb), the checker flag, 1 + image id
    noi, chk, img = (torch.zeros_like(code, dtype=torch.float32)
                     for _ in range(3))
    for mask, tab, rows, idx in (
            (sph, attr_tab.t(), (mk.A_NOISE, mk.A_CHK, mk.A_IMG), code),
            (rec, rect_tab, (mk.RT_NOI, mk.RT_CHK, mk.RT_IMG), code - S),
            (med, med_tab, (mk.MD_NOI, None, mk.MD_IMG), code - S - R)):
        for dst, row in zip((noi, chk, img), rows):
            if row is not None and mask.any():
                dst[mask] = tab[idx[mask], row]
    for m, kind in enumerate(("marble", "smooth", "turb")):
        mix["tex_" + kind] = (noi == 1 + m).sum().item() / n
    mix["tex_checker"] = (chk > 0.5).sum().item() / n
    mix["tex_image_sphere"] = ((img > 0.5) & sph).sum().item() / n
    mix["tex_image_rect"] = ((img > 0.5) & rec).sum().item() / n
    mix["tex_image_medium"] = ((img > 0.5) & med).sum().item() / n
    return mix


def bound_ms(plan, segments: float, mix: dict, blocks: float = 0.0,
             needed: float | None = None) -> float:
    """Least time of a launch that traced `segments` path segments (and,
    culled, re-voted `blocks` cluster blocks, the warps' visits of row 6,
    and swept the `needed` ones its rays need, row 7; default `blocks`):
    their FP32 operations over the card's FP32 peak. Bytes do not bound it:
    the dense kernels' tables sit in shared memory, the culled kernel's
    slot quads in L2 (231 KB for random_balls_huge), and a launch reads 16
    B and writes 32 B per lane."""
    seg = max(segments, 1.0)
    return (ops_per_segment(plan, mix, blocks / seg,
                            None if needed is None else needed / seg)
            * segments / FP32_PEAK * 1e3)


def phase_device() -> None:
    if not torch.cuda.is_available():
        fail("torch.cuda.is_available() is False: this smoke test needs an "
             "NVIDIA GPU")
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60)
    global DEVICE_LINE
    DEVICE_LINE = smi.stdout.strip()
    print(DEVICE_LINE)
    print(f"phase 1 device: {torch.cuda.get_device_name(0)}, "
          f"count {torch.cuda.device_count()}, torch {torch.__version__}, "
          f"CUDA {torch.version.cuda}", flush=True)


def repro_i2f(lib: str) -> dict:
    """The integer-to-float conversions (I2F*, I2FP*) in the SASS of K10's
    two kernels: {'f32 iota': [opcodes], 'int iota + cast': [opcodes]}."""
    tool = os.path.join(os.path.dirname(_build._nvcc()), "cuobjdump")
    text = subprocess.run([tool, "-sass", lib], capture_output=True,
                          text=True, check=True, timeout=120).stdout
    out = {}
    for func in re.split(r"\n\s*Function : ", text)[1:]:
        name = sass.kernel_name(func.split(None, 1)[0])
        form = {"repro:iota_f32": "f32 iota",
                "repro:iota_int_cast": "int iota + cast"}.get(name)
        if form:
            out[form] = sorted(re.findall(r"\bI2FP?\b[.\w]*", func))
    return out


def phase_build() -> tuple:
    """Build the kernels, and beside them the culled kernels' warp-cycle
    split build (RTW_SPLIT, tools/culled_ab.py), all nvcc started
    together; print registers, spills, the sweep loops' SASS per slot and
    K10's I2F counts; returns (`sweep_sass`, `repro_i2f`)."""
    t0 = time.perf_counter()
    (lib, nvcc_secs), _ = _build.build_all([((), _build.CSRC),
                                            (culled_ab.SPLIT, _build.CSRC)])
    mk._kernel_lib()
    log = _build.build_log()
    # one entry per kernel instantiation: its registers, spill stores and
    # stack
    rows = [f"{name}: {r} regs, {'?' if sp is None else sp} B spill, "
            f"{'?' if st is None else st} B stack"
            for name, (r, sp, st) in sass.registers(log).items()]
    sweep = sass.sweep_sass(str(lib))
    per_slot = "; ".join(
        f"{k}: {n} / {s} = {n / s:.2f} (FFMA {fa / s:.2f}, FMUL {fm / s:.2f}"
        f", FADD {fd / s:.2f}, LDS {ld / s:.2f}"
        f"{f'; {lane[0]} a needing lane besides' if lane else ''})"
        if s else f"{k}: -"
        for k, (n, s, fa, fm, fd, ld, *lane) in sorted(sweep.items()))
    i2f = repro_i2f(str(lib))
    print(f"phase 2 build: {os.path.basename(lib)} nvcc {nvcc_secs:.3f} s, "
          f"build+load {time.perf_counter() - t0:.3f} s; "
          f"{len(rows)} instantiations {'; '.join(rows)}; sweep SASS "
          f"instructions per slot (loop / slots) {per_slot}; K10 I2F in "
          f"SASS {i2f}", flush=True)
    # the surfaces kernels (K2-K4, K5s): every form's registers, spills
    # and stack, its rect loops' and light loop's SASS (a rect row an
    # iteration, a light an iteration), its MUFU and its loads by space
    regs = sass.registers(log)
    surf = sass.surface_loops(sass.cuobjdump(str(lib)))
    for name, rep_ in sorted(surf.items()):
        r, sp, st = regs.get(name, (None, None, None))
        print(f"phase 2 surfaces {name}: {r} regs, {sp} B spill, {st} B "
              f"stack; {rep_['instructions']} SASS; rect loops "
              f"{rep_['rect_loops']} a row, light loops "
              f"{rep_['light_loops']} a light; MUFU {rep_['MUFU']}; LDS "
              f"{rep_['LDS']}, LD {rep_['LD']}, LDG {rep_['LDG']}, LDL "
              f"{rep_['LDL']}, STL {rep_['STL']}", flush=True)
    spills = {k: v[1] for k, v in regs.items()
              if "surfaces" in k and v[1]}
    forms = mk.surface_forms(mk._kernel_lib())
    print(f"phase 2 surfaces forms (axes, uniform shutter, features, block "
          f"limit, registers, local bytes): {forms}", flush=True)
    if spills or len(surf) != len(forms) + 6:
        fail(f"surfaces instantiations spill {spills} or are not all "
             f"listed ({len(surf)} of {len(forms)} + 6 culled)")
    return sweep, i2f


def phase_dense_widths() -> dict:
    """The dense kernels' tile widths (ROADMAP F3): the library's block
    limit of every dense instantiation equals DENSE_MAX_T; make_plan
    refuses an overdraw tile past it (T = 1024, and DENSE_MAX_T + 32)
    for K1 (random_balls) and K2-K4 (cornell_box, earth) before any
    launch, and at the widest accepted T each kernel renders on the card
    and agrees with its plain version (96x64, 4 spp, depth 8: rows 0-5
    within rtol / atol on >= MIN_SAME of the lanes). Returns the max abs
    radiance error."""
    limits = mk.dense_max_threads(mk._kernel_lib())
    limits["surfaces"] += [r[3] for r in mk.surface_forms(mk._kernel_lib())]
    err = 0.0
    for kind, name, kw in (("spheres", "random_balls", {}),
                           *(("surfaces", n, k) for n, k in SURFACE_SCENES)):
        scene = (texture_mix() if name == "texture_mix"
                 else make_scene(name, 1.5, **kw))
        top = mk.DENSE_MAX_T
        for T in (1024, top + 32):
            try:
                mk.make_plan(scene, 96, 64, 4, max_depth=8, T=T)
            except ValueError:
                continue
            fail(f"make_plan accepted T={T} past the dense {kind} "
                 f"kernel's {top} lanes ({name})")
        pixf, out_k, out_r = _launch_both(scene, 96, 64, 4, 8, False, T=top)
        _, plan = mk.make_plan(scene, 96, 64, 4, max_depth=8, T=top)
        valid = pixf[:, 2] > 0
        close = torch.isclose(out_k[:, :6], out_r[:, :6], rtol=RTOL,
                              atol=ATOL).all(dim=1)[valid]
        frac = close.float().mean().item()
        e = (out_k[:, :3] - out_r[:, :3]).abs().max().item()
        err = max(err, e)
        print(f"phase 2b dense {kind} kernel ({name}, form "
              f"{plan.feat:#04x}): block limits {limits[kind]}, make_plan "
              f"refuses T=1024 and T={top + 32}; at T={top} rows 0-5 within "
              f"rtol {RTOL}/atol {ATOL} on {frac:.6f} of "
              f"{valid.sum().item()} lanes, max abs err {e:.3e}",
              flush=True)
        if set(limits[kind]) != {top} or frac < MIN_SAME:
            fail(f"the dense {kind} kernel at its widest tile T={top}")
    return dict(max_abs_err=err)


def _launch_both(scene, nx, ny, spp, depth, exact, T=256):
    """The kernel and its plain version on the same card tensors."""
    _, plan = mk.make_plan(scene, nx, ny, spp, max_depth=depth, T=T,
                           exact=exact)
    args, _ = mk.device_inputs(scene, plan, "cuda")
    out_k = mk.mega_kernel(*args, SEED, plan)
    out_r = mk.trace_mega_reference(*args, SEED, plan)
    torch.cuda.synchronize()
    return args[0], out_k, out_r


def _exact_parity(label, scene) -> float:
    """Exact-spp mode at 64x64, 8 spp, depth 8: winner tapes lane by lane,
    radiance and swept blocks (row 6) on equal lanes. Returns the max abs
    radiance error."""
    pixf, out_k, out_r = _launch_both(scene, 64, 64, 8, 8, exact=True)
    valid = pixf[:, 2] > 0
    same = (out_k[:, 8:] == out_r[:, 8:]).all(dim=1) & valid
    frac = same.sum().item() / valid.sum().item()
    a = out_k[:, 0:3].transpose(1, 2)[same]
    b = out_r[:, 0:3].transpose(1, 2)[same]
    err = (a - b).abs().max().item()
    close = torch.allclose(a, b, rtol=RTOL, atol=ATOL)
    blocks = (out_k[:, 6:8] == out_r[:, 6:8]).all(dim=1)[same].float().mean(
    ).item()
    print(f"phase 3 exact-spp parity ({label} 64x64, 8 spp, depth 8, "
          f"T=256): tapes equal on {frac:.6f} of lanes (mismatch "
          f"{1 - frac:.6f}), max abs radiance err {err:.3e} "
          f"(rtol {RTOL}, atol {ATOL}), swept and needed blocks (rows 6, 7) "
          f"equal on {blocks:.6f} of them: "
          f"{'ok' if close and blocks == 1.0 else 'FAIL'}", flush=True)
    if frac < MIN_SAME or not close or blocks != 1.0:
        fail(f"kernel disagrees with its plain version in exact-spp mode "
             f"({label})")
    return err


def large_mixed(n, aspect, **kw):
    """The probe of the culled surfaces kernel (K5s): random_balls_large's
    n x n grid with a checker ground, a rect light in the MIS list, an
    emissive sphere and an isotropic medium."""
    return probe_scenes.large_mixed_scene(builder, scene_types, n=n,
                                          aspect=aspect, **kw)


def texture_mix():
    """The builder scene with every texture lane: checker sphere and rect,
    marble sphere, smooth and turb noise on rects, a marble medium, an
    image medium."""
    return probe_scenes.texture_mix_scene(builder, scene_types)


def phase_exact_parity() -> dict:
    errs = {"K1": _exact_parity("random_balls",
                                make_scene("random_balls", 1.0))}
    errs["K2+K3"] = max(
        _exact_parity("cornell_box", make_scene("cornell_box", 1.0)),
        _exact_parity("cornell_box glass_sphere=False aluminum_box=True",
                      make_scene("cornell_box", 1.0, glass_sphere=False,
                                 aluminum_box=True)),
        _exact_parity("cornell_smoke", make_scene("cornell_smoke", 1.0)))
    errs["K4"] = max(
        [_exact_parity(name + (" (earth.rtwi)" if kw else ""),
                       make_scene(name, 1.0, **kw))
         for name, kw in TEXTURE_PATH]
        + [_exact_parity("texture_mix (builder)", texture_mix())])
    errs["K5"] = max(_exact_parity(f"{name} (culled, SB 256)",
                                   make_scene(name, 1.0))
                     for name, _ in LARGE_PATH)
    errs["K5s"] = max(
        _exact_parity(f"large_mixed n=60{label} (culled surfaces, SB 256)",
                      large_mixed(60, 1.0, **kw))
        for label, kw in (("", {}), (" untextured moving",
                                     dict(textured=False, moving=True))))
    return errs


def _load_golden(name):
    with open(os.path.join(GOLDEN_DIR, name), "rb") as f:
        m = re.match(r"RTWO (\d+) (\d+)", f.readline().decode())
        nx, ny = int(m.group(1)), int(m.group(2))
        data = np.frombuffer(f.read(), dtype="<f8")
    return data.reshape(ny, nx, 3)


def phase_goldens() -> None:
    """The pixelwise criterion of tests/test_golden.py through render()."""
    _goldens("phase 4 golden", "mega", 64)


def _goldens(label: str, mode: str, launch_spp: int,
             max_spp: dict | None = None) -> None:
    """Every golden through render() in `mode`, launches of launch_spp, at
    the golden's spp or at most max_spp[golden] (the tolerance takes the
    spp rendered)."""
    rtwi = {"image_path": RTWI}
    for name, golden, spp, kw in (
            ("random_balls", "random_balls_128x128_2048spp.bin", 2048, {}),
            ("dielectric", "dielectric_32x32_4096spp.bin", 4096, {}),
            ("cornell_box", "cornell_box_128x128_8192spp.bin", 8192, {}),
            ("cornell_box", "cornell_box_32x32_8192spp.bin", 8192, {}),
            ("cornell_smoke", "cornell_smoke_32x32_8192spp.bin", 8192, {}),
            ("light_sample", "light_sample_32x32_4096spp.bin", 4096, {}),
            ("earth", "earth_32x32_4096spp.bin", 4096, rtwi),
            ("earth_rect", "earth_rect_32x32_4096spp.bin", 4096, rtwi)):
        g = _load_golden(golden)
        ny, nx, _ = g.shape
        spp = min(spp, (max_spp or {}).get(golden, spp))
        cfg = RenderConfig(nx=nx, ny=ny, spp=spp, max_depth=50,
                           samples_per_launch=launch_spp, seed=7,
                           loop_mode=mode, device="cuda")
        t0 = time.perf_counter()
        o = render(make_scene(name, nx / ny, **kw),
                   cfg).double().cpu().numpy()
        secs = time.perf_counter() - t0
        mean_rel = abs(o.mean() - g.mean()) / max(g.mean(), 1e-6)
        err = np.abs(o - g)
        tol = 0.05 + 4.0 * np.sqrt(np.maximum(g, 0.0) / spp)
        frac_ok = float((err <= tol).mean())
        ok = np.isfinite(o).all() and mean_rel < 0.02 and frac_ok > 0.995
        print(f"{label} {name} {nx}x{ny} {spp} spp: mean {o.mean():.6f}"
              f" vs {g.mean():.6f} (rel {mean_rel:.5f} < 0.02), pixels in "
              f"tolerance {frac_ok:.5f} > 0.995, {secs:.3f} s: "
              f"{'ok' if ok else 'FAIL'}", flush=True)
        if not ok:
            fail(f"golden parity failed for {golden}")


def _drive(name, nx, ny, spp, launch_spp, depth, kernel, label,
           scene=None, mode="mega", **kw) -> dict:
    """render() of one scene (make_scene keywords `kw`, or `scene`) in loop
    mode `mode`: one warm-up launch, then `spp` samples in launches of
    `launch_spp`, with the kernel's launch count set to 0 just before the
    path and read just after."""
    if scene is None:
        scene = make_scene(name, nx / ny, **kw)
    base = dict(nx=nx, ny=ny, max_depth=depth, samples_per_launch=launch_spp,
                loop_mode=mode, device="cuda")
    for k in mk.KERNEL_LAUNCHES:
        mk.KERNEL_LAUNCHES[k] = 0
    render(scene, RenderConfig(spp=launch_spp, seed=0, **base))   # warm-up
    stats = RenderStats()
    canvas = render(scene, RenderConfig(spp=spp, seed=1, **base),
                    stats=stats)
    launches = dict(mk.KERNEL_LAUNCHES)
    n_timed = spp // launch_spp
    img = canvas.cpu().numpy()
    mean = float(img.mean())
    with tempfile.TemporaryDirectory() as tmp:
        png = os.path.join(tmp, f"{name}.png")
        image_mod.write_png(image_mod.postprocess(img), png)
        png_bytes = os.path.getsize(png)
    print(f"{label} ({name} {nx}x{ny}, {launch_spp} spp/launch, depth "
          f"{depth}, 1 warm-up + {n_timed} timed launches): "
          f"{stats.rays_per_s:.6e} path segments/s, "
          f"{stats.trace_seconds / n_timed:.6f} s/launch, "
          f"{stats.segments:.6e} segments, kernel launches {launches}, "
          f"image mean {mean:.6f}, png {png_bytes} bytes", flush=True)
    if launches[kernel] < 1:
        fail(f"the {name} path launched no {kernel} kernel")
    if img.shape != (ny, nx, 3) or not np.isfinite(img).all():
        fail(f"{name} image is not finite or has the wrong shape")
    return dict(launches=launches[kernel], rate=stats.rays_per_s,
                all_launches=launches,
                s_per_launch=stats.trace_seconds / n_timed)


def phase_main_path() -> dict:
    """The book-1 path at full width, through render()."""
    return _drive("random_balls", NX, NY, 3 * SPP, SPP, DEPTH, "K1",
                  "phase 5 main path")


def phase_cornell_path() -> dict:
    """The Cornell path at full width: cornell_box, then cornell_smoke."""
    runs = [_drive(name, CNX, CNY, CSPP, CLAUNCH, CDEPTH, "K2+K3",
                   "phase 6 Cornell path") for name in CORNELL_PATH]
    return dict(launches=sum(r["launches"] for r in runs))


def phase_texture_path() -> dict:
    """The texture path at full width: each scene 800x600, five 64 spp
    launches after a warm-up."""
    runs = [_drive(name, TNX, TNY, TLAUNCHES * TSPP, TSPP, TDEPTH, "K4",
                   "phase 8 texture path", **kw) for name, kw in TEXTURE_PATH]
    return dict(launches=sum(r["launches"] for r in runs))


def _drive_culled(name, scene, spp, kernel, label, mode="mega") -> dict:
    """_drive of a culled scene at LNX x LNY, `spp` a launch, with each
    launch's MegaResult recorded: the warp survival (swept blocks, row 6)
    and the per-lane survival (needed blocks, row 7) of the timed
    launches, over their lane iterations x C."""
    _, plan = mk.make_plan(scene, LNX, LNY, spp, max_depth=LDEPTH)
    got = []
    orig = mk.trace_mega

    def recorded(*a, **kw):
        res = orig(*a, **kw)
        got.append((res.blocks, res.lane_need, res.lane_iters))
        return res

    mk.trace_mega = recorded
    try:
        run = _drive(name, LNX, LNY, LLAUNCHES * spp, spp, LDEPTH, kernel,
                     label, scene=scene, mode=mode)
    finally:
        mk.trace_mega = orig
    timed = got[1:]                              # after the warm-up
    iters = sum(i.item() for _, _, i in timed) * plan.C
    return dict(run, plan=plan,
                survival=sum(b.item() for b, _, _ in timed) / iters,
                lane_survival=sum(n.item() for _, n, _ in timed) / iters)


def _split(label, name, scene, spp) -> dict:
    """The culled kernel's warp-cycle split at a cell's launch (LNX x LNY
    x spp): one launch of the RTW_SPLIT build (tools/culled_ab.py), held
    to the kernels' own launch on rows 0-7; prints the shares of its
    warps' cycles."""
    _, plan = mk.make_plan(scene, LNX, LNY, spp, max_depth=LDEPTH)
    args, _ = mk.device_inputs(scene, plan, "cuda")
    s = culled_ab.split(args, plan)
    ref = mk.mega_kernel(*args, SEED, plan)
    same = torch.equal(s["out"][:, :mk.OUT_ROWS], ref[:, :mk.OUT_ROWS])
    sh, raw = s["share"], s["raw"]
    print(f"{label} split ({name} {LNX}x{LNY}x{spp}, RTW_SPLIT build, "
          f"instrumented launch {s['ms']:.3f} ms, rows 0-7 equal the "
          f"kernel's: {same}): of the warps' cycles, key pass and buckets "
          f"{sh['keys']:.4f}, votes {sh['votes']:.4f}, broadcast sweeps "
          f"{sh['broadcast']:.4f}, compacted sweeps {sh['compacted']:.4f}, "
          f"rest (shading, RNG, tile tails) {sh['rest']:.4f}; candidate "
          f"visits {raw['candidates']}, broadcast {raw['broadcast_visits']}"
          f", compacted {raw['compacted_visits']}", flush=True)
    if not same:
        fail(f"the split build of the culled kernel differs on {name}")
    return s


def _surface_split(label, name, nx, ny, spp, run, **kw) -> dict:
    """The dense surfaces kernel's cycle split at a path's launch: one
    overdraw launch of the RTW_SPLIT build (tools/culled_ab.py
    split_surfaces), held to the kernels' own launch on every output row;
    prints each part's share of the lanes' cycles, the grid tail and,
    beside them, the kernel's ms and bound from `run` (_kernel_vs_plain's
    result at the same shape)."""
    scene = make_scene(name, nx / ny, **kw)
    _, plan = mk.make_plan(scene, nx, ny, spp, max_depth=DEPTH)
    args, _ = mk.device_inputs(scene, plan, "cuda")
    s = culled_ab.split_surfaces(args, plan)
    ref = mk.mega_kernel(*args, SEED, plan)
    same = torch.equal(s["out"], ref)
    parts = ", ".join(f"{k} {v:.4f}" for k, v in s["share"].items() if v)
    g = s["grid"]
    print(f"{label} split ({name} {nx}x{ny}x{spp}, form {plan.feat:#04x}, "
          f"RTW_SPLIT build, instrumented launch {s['ms']:.3f} ms, rows "
          f"equal the kernel's: {same}): of the lanes' cycles {parts}; grid "
          f"tail {g['tail_share']:.4f} of {g['span_ms']:.3f} ms ({g['blocks']} "
          f"blocks, at most {g['most_blocks_an_sm']} an SM, the longest "
          f"{g['longest_block_ms']:.3f} ms, mean {g['mean_block_ms']:.3f}); "
          f"kernel "
          f"{run['ms']:.3f} ms, bound {run['bound_ms']:.3f} ms "
          f"({run['bound_ms'] / run['ms']:.3f})", flush=True)
    if not same:
        fail(f"the split build of the surfaces kernel differs on {name}")
    return s


def phase_large_path() -> dict:
    """The large-S path at full width: each stress scene 1200x800, three
    timed launches after a warm-up, with both survivals; then each
    cell's warp-cycle split."""
    runs = []
    for name, spp in LARGE_PATH:
        scene = make_scene(name, LNX / LNY)
        run = _drive_culled(name, scene, spp, "K5", "phase 10 large-S path")
        print(f"phase 10 {name}: warp survival {run['survival']:.6f}, "
              f"per-lane survival {run['lane_survival']:.6f} (C="
              f"{run['plan'].C}, SB={run['plan'].SB})", flush=True)
        runs.append(run)
    for name, spp in LARGE_PATH:
        _split("phase 10", name, make_scene(name, LNX / LNY), spp)
    return dict(launches=sum(r["launches"] for r in runs))


def phase_culled_vs_dense() -> dict:
    """random_balls_large at its path's launch (1200x800x32), whose dense
    sweep (S = 3712) still fits in shared memory: the culled kernel against
    the dense one on the same inputs."""
    name, spp = LARGE_PATH[0]
    return _culled_vs_dense("phase 11 culled vs dense kernel", name,
                            make_scene(name, LNX / LNY), spp)


def _culled_vs_dense(label, name, scene, spp) -> dict:
    """A culled plan's kernel against the dense plan's on the same inputs
    at LNX x LNY x spp: every output row but the block counts, timed in
    turns (dense, culled, culled, dense), with both survivals."""
    _, culled = mk.make_plan(scene, LNX, LNY, spp, max_depth=LDEPTH)
    _, dense = mk.make_plan(scene, LNX, LNY, spp, max_depth=LDEPTH,
                            cull=False)
    args, _ = mk.device_inputs(scene, culled, "cuda")
    runs = {"dense": [], "culled": []}
    outs = {}
    for kind in ("dense", "culled", "culled", "dense"):
        plan = culled if kind == "culled" else dense
        _event_ms(lambda: mk.mega_kernel(*args, SEED, plan), 1)   # warm-up
        ms, outs[kind] = _event_ms(lambda: mk.mega_kernel(*args, SEED, plan),
                                   2)
        runs[kind].append(ms)
    a, b = outs["culled"][:, :6], outs["dense"][:, :6]
    err = (a - b).abs().max().item()
    equal = torch.equal(a, b)
    ms_c, ms_d = (sum(runs[k]) / 2 for k in ("culled", "dense"))
    iters = outs["culled"][:, 4].sum().item() * culled.C
    surv = outs["culled"][:, 6].sum().item() / iters
    lane_surv = outs["culled"][:, 7].sum().item() / iters
    print(f"{label} ({name} {LNX}x{LNY}x{spp} spp, S={culled.S}, "
          f"C={culled.C}, SB={culled.SB}, near-to-far {culled.dyn_order} "
          f"buckets, R={culled.R}, L={culled.L}, V={culled.V}): culled "
          f"{ms_c:.3f} ms, dense {ms_d:.3f} ms per launch (dense, culled, "
          f"culled, dense: {runs['dense'][0]:.3f} {runs['culled'][0]:.3f} "
          f"{runs['culled'][1]:.3f} {runs['dense'][1]:.3f}); warp survival "
          f"{surv:.6f}, per-lane survival {lane_surv:.6f}; pixels, "
          f"segments, lane iterations and sample counts "
          f"equal: {equal} (max abs err {err:.3e}; segments "
          f"{b[:, 3].sum().item():.6e})", flush=True)
    if not equal:
        fail(f"the culled kernel differs from the dense kernel on {name}")
    return dict(max_abs_err=err, dense_ms=ms_d, culled_ms=ms_c)


def phase_mixed_path() -> dict:
    """The mixed large-S path (K5s): large_mixed at n = 60 (1200x800, 32
    spp a launch) and n = 120 (x16), depth 50, through render(loop_mode=
    "auto"), one warm-up and three timed launches each; auto must take the
    megakernel and launch the culled surfaces kernel and no other. Both
    survivals are read from the timed launches' own outputs (swept and
    needed blocks over lane iterations x C); then each cell's warp-cycle
    split."""
    runs = []
    for n, spp in MIXED_PATH:
        scene = large_mixed(n, LNX / LNY)
        if resolve_mode(scene, "auto") != "mega":
            fail(f"auto does not take the megakernel on large_mixed n={n}")
        _, plan = mk.make_plan(scene, LNX, LNY, spp, max_depth=LDEPTH)
        if not (plan.cull and plan.surfaces and plan.textures):
            fail(f"large_mixed n={n} does not plan the culled surfaces "
                 "kernel")
        run = _drive_culled(f"large_mixed n={n}", scene, spp, "K5s",
                            "phase 21 mixed large-S path", mode="auto")
        others = {k: v for k, v in run["all_launches"].items()
                  if k != "K5s" and v}
        print(f"phase 21 large_mixed n={n}: auto -> mega, launches "
              f"{run['all_launches']}; {run['rate']:.6e} segments/s, "
              f"{run['s_per_launch'] * 1e3:.3f} ms a launch, S={plan.S}, "
              f"C={plan.C}, SB={plan.SB}, dyn_order={plan.dyn_order}, "
              f"warp survival {run['survival']:.6f}, per-lane survival "
              f"{run['lane_survival']:.6f}; {DEVICE_LINE}", flush=True)
        if others or run["launches"] != 1 + LLAUNCHES:
            fail(f"large_mixed n={n} launched {run['all_launches']}, not "
                 "the culled surfaces kernel alone")
        runs.append(dict(run, C=plan.C))
    for n, spp in MIXED_PATH:
        _split("phase 21", f"large_mixed n={n}", large_mixed(n, LNX / LNY),
               spp)
    return dict(launches=sum(r["launches"] for r in runs), runs=runs)


def phase_mixed_vs_dense() -> dict:
    """large_mixed n = 60 at its path's launch, whose dense surfaces sweep
    (S = 3712) still fits in shared memory: the culled surfaces kernel
    against the dense surfaces kernel."""
    n, spp = MIXED_PATH[0]
    return _culled_vs_dense("phase 22 culled vs dense surfaces kernel",
                            f"large_mixed n={n}", large_mixed(n, LNX / LNY),
                            spp)


def _event_ms(fn, reps: int) -> tuple[float, object]:
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        out = fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps, out


def _lane_means(out: torch.Tensor) -> torch.Tensor:
    """(n_tiles, T, 3) mean radiance of each lane's pixel: its sums over
    the samples it traced (the epilogue's renormalisation, unpermuted)."""
    return (out[:, 0:3, :] / torch.clamp_min(out[:, 5:6, :], 1.0)).transpose(
        1, 2)


def _kernel_vs_plain(name, nx, ny, spp, label, tile_stride=1,
                     scene=None, **kw) -> dict:
    """One launch at a path's shape: the kernel and its plain version on
    the same inputs, timed with CUDA events and compared pixel by pixel;
    the bound from the launch's segments and the measured hit mix. With
    `tile_stride` > 1 the plain version traces every `tile_stride`-th tile
    of the launch only (the others are marked invalid in its copy of the
    pixel table; tiles are independent and keep their RNG streams), and
    the kernel's output is compared on those tiles. A culled plan also
    compares the swept- and needed-block counts (rows 6, 7) lane by lane,
    and its bound counts the slots its rays need (row 7), beside the
    warp-vote bound (row 6's slots), printed. `scene`, when given,
    replaces make_scene(name, keywords `kw`)."""
    if scene is None:
        scene = make_scene(name, nx / ny, **kw)
    _, plan = mk.make_plan(scene, nx, ny, spp, max_depth=DEPTH)
    args, _ = mk.device_inputs(scene, plan, "cuda")
    pixf = args[0]
    sel = torch.zeros(pixf.shape[0], dtype=torch.bool, device=pixf.device)
    sel[::tile_stride] = True
    pixf_plain = pixf.clone()
    pixf_plain[~sel, 2, :] = 0.0

    def kernel():
        return mk.mega_kernel(*args, SEED, plan)

    once, _ = _event_ms(kernel, 1)             # warm-up, and a first time
    reps = max(3, min(50, int(500.0 / max(once, 1e-3))))   # ~0.5 s
    _event_ms(kernel, reps)                    # clocks up
    ms, out_k = _event_ms(kernel, reps)
    segments = out_k[:, 3, :].sum().item()
    plain_ms, out_r = _event_ms(
        lambda: mk.trace_mega_reference(pixf_plain, *args[1:], SEED, plan), 1)
    lanes = (pixf[:, 2, :] > 0) & sel[:, None]
    a, b = _lane_means(out_k)[lanes], _lane_means(out_r)[lanes]
    max_err = (a - b).abs().max().item()
    frac = torch.isclose(a, b, rtol=RTOL, atol=ATOL).all(
        dim=-1).float().mean().item()
    blocks = out_k[:, 6, :].sum().item() if plan.cull else 0.0
    needed = out_k[:, 7, :].sum().item() if plan.cull else 0.0
    mix = segment_mix(scene)
    ops = ops_per_segment(plan, mix, blocks / segments, needed / segments)
    bound = bound_ms(plan, segments, mix, blocks, needed)
    warp_bound = bound_ms(plan, segments, mix, blocks)
    part = (f" on every {tile_stride}th tile ({sel.sum().item()} of "
            f"{sel.numel()})" if tile_stride > 1 else "")
    culled = ""
    frac_blk = 1.0
    if plan.cull:
        frac_blk = (out_k[:, 6:8, :] == out_r[:, 6:8, :]).all(dim=1)[
            lanes].float().mean().item()
        iters = out_k[:, 4, :].sum().item() * plan.C
        culled = (f"; C={plan.C}, SB={plan.SB}, warp survival "
                  f"{blocks / iters:.6f}, per-lane survival "
                  f"{needed / iters:.6f}, warp-vote bound {warp_bound:.3f} "
                  f"ms ({warp_bound / ms:.3f}); swept- and needed-block "
                  f"counts{part} equal on {frac_blk:.6f} of lanes")
    print(f"{label} kernel vs plain ({name} {nx}x{ny}x{spp} spp, "
          f"T={plan.T}, S={plan.S}, R={plan.R}, L={plan.L}, V={plan.V}): "
          f"kernel {ms:.3f} ms (mean of {reps}) per launch, plain PyTorch "
          f"{plain_ms:.3f} ms{part}; {segments:.6e} segments; hit mix "
          f"{json.dumps({k: round(v, 4) for k, v in mix.items()})}; "
          f"{ops:.1f} FP32 ops per segment, bound {bound:.3f} ms "
          f"({bound / ms:.3f} of the kernel time); pixels{part} equal "
          f"within rtol {RTOL}/atol {ATOL}: {frac:.6f} of {a.shape[0]}, "
          f"max abs err {max_err:.3e}{culled}", flush=True)
    if frac < MIN_SAME or frac_blk < MIN_SAME:
        fail(f"kernel disagrees with its plain version on {name}")
    return dict(ms=ms, plain_ms=plain_ms, max_abs_err=max_err,
                bound_ms=bound, segments=segments)


def k7_build_report() -> dict:
    """Registers and spills of K7's instantiations (ptxas), its slot
    loop's SASS a ray-slot pair (tools/sass.py k7_loops) and its staging
    constants."""
    regs = {k: v for k, v in sass.registers(_build.build_log()).items()
            if k.startswith("k7")}
    loops = sass.k7_loops(sass.cuobjdump(str(_build.library_path())))
    consts = k7.k7_consts()
    print(f"phase 13a K7 build: {consts['rays']} rays a thread, "
          f"{consts['threads']} threads a block, {consts['chunk']} slots a "
          f"streamed chunk; registers, spill and stack bytes "
          f"{json.dumps(regs)}; slot loop a ray-slot pair "
          f"{json.dumps(loops)}", flush=True)
    forms = {f"k7<{a},{u}>" for a, u in K7_FORMS}
    if set(regs) != forms or set(loops) != forms:
        fail("K7's four instantiations are not in the build log and SASS")
    if any(sp for _, sp, _ in regs.values()):
        fail("K7 spills")
    return dict(regs=regs, sass=loops, **consts)


def _capture_regen_rays(scene, n_iters: int) -> list:
    """The (o, d, time) K7 gets in the first n_iters iterations of a regen
    launch at the main path's shape (copies; the launch stops there)."""
    return culled_ab.capture_regen_rays(scene, n_iters, WNX, WNY, WSPP,
                                        WDEPTH)


def k7_bound_ms(n: int, S: int, axes: int,
                uniform: bool) -> tuple[float, str]:
    """Least time of one K7 call: every ray against every slot (no early
    exit), OPS_K7_PAIR operations a pair and the motion of centres moving
    along `axes` axes (a motion FMA an axis a pair; the motion fraction a
    pair, or once a ray when every slot shares one shutter window,
    `uniform`) over the FP32 peak, against its bytes (7 floats a ray and
    12 a slot read, 12 bytes a ray written: best_t and the int64 best_i)
    over the memory rate."""
    pair = OPS_K7_PAIR + OPS_AXIS_MOTION * axes
    ops = n * S * pair
    if axes:
        ops += OPS_SLOT_SHUTTER * (n if uniform else n * S)
    ops_ms = ops / FP32_PEAK * 1e3
    bytes_ms = ((7 * n + 12 * S) * 4 + 12 * n) / HBM_PEAK * 1e3
    return max(ops_ms, bytes_ms), ("operations" if ops_ms >= bytes_ms
                                   else "bytes")


def phase_k7_vs_plain() -> list:
    """K7 against its plain version on the rays of the first K7_ITERS
    regen iterations of each K7 scene at the main path's shape, bit for
    bit (best_t and best_i of every ray, every call); kernel, plain and
    bound ms per call (the kernel on the scene's staged layout, as the
    wavefront calls it)."""
    from raytracingweekend_tpu_torch.ops.packing import device_scene
    rows = []
    for name in K7_SCENES:
        scene = make_scene(name, WNX / WNY)
        t0 = time.perf_counter()
        rays = _capture_regen_rays(scene, K7_ITERS)
        ds = device_scene(scene, "cuda")
        table, lay = ds.sphere_table, ds.sphere_layout
        moving = scene.has_moving_spheres
        n, S = rays[0][0].shape[0], table.shape[0]
        errs, bit = [], []
        for o, d, tm in rays:
            kt, ki = k7.hit_spheres_kernel(o, d, tm, table, moving,
                                           layout=lay)
            rt, ri = k7.hit_spheres_reference(o, d, tm, table, moving,
                                              layout=lay)
            torch.cuda.synchronize()
            hit = rt < 1e30
            errs.append((kt[hit] - rt[hit]).abs().max().item()
                        if hit.any() else 0.0)
            bit.append(torch.equal(kt, rt) and torch.equal(ki, ri))
        o, d, tm = rays[0]

        def kernel():
            return k7.hit_spheres_kernel(o, d, tm, table, moving, layout=lay)

        once, _ = _event_ms(kernel, 1)
        reps = max(5, min(200, int(300.0 / max(once, 1e-3))))
        _event_ms(kernel, reps)
        ms, _ = _event_ms(kernel, reps)
        plain_ms, _ = _event_ms(
            lambda: k7.hit_spheres_reference(o, d, tm, table, moving,
                                             layout=lay), 1)
        axes = int((table[:, k7.K_DCX:k7.K_DCZ + 1] != 0).any(dim=0).sum()
                   ) if moving else 0
        bound, by = k7_bound_ms(n, S, axes, lay.uniform)
        hits = (rt < 1e30).float().mean().item()
        print(f"phase 13 K7 kernel vs plain ({name}, rays of the first "
              f"{K7_ITERS} regen iterations at {WNX}x{WNY}x{WSPP}: N={n}, "
              f"S={S}, {'moving' if moving else 'static'}, staged form "
              f"k7<{lay.axes},{int(lay.uniform)}>): bitwise equal calls "
              f"(best_t and best_i of every ray) {sum(bit)}/{len(bit)} "
              f"({hits:.4f} of rays hit), max abs err {max(errs):.3e}; "
              f"kernel {ms:.4f} ms (mean of {reps}), plain PyTorch "
              f"{plain_ms:.3f} ms, bound {bound:.4f} ms by {by} (share "
              f"{bound / ms:.3f}); {time.perf_counter() - t0:.3f} s",
              flush=True)
        if not all(bit):
            fail(f"K7 differs from its plain version on {name}")
        rows.append(dict(name=name, ms=ms, plain_ms=plain_ms, bound_ms=bound,
                         bound_by=by, max_abs_err=max(errs), S=S))
    return rows


class _K7Timer:
    """CUDA events around every K7 wrapper call while installed (the
    wrapper's ray packing, a ~15 MB copy, included)."""

    def __init__(self):
        self.pairs = []
        self.orig = k7.hit_spheres_kernel

    def __enter__(self):
        def timed(*args, **kw):
            a = torch.cuda.Event(enable_timing=True)
            b = torch.cuda.Event(enable_timing=True)
            a.record()
            out = self.orig(*args, **kw)
            b.record()
            self.pairs.append((a, b))
            return out
        k7.hit_spheres_kernel = timed
        return self

    def __exit__(self, *exc):
        k7.hit_spheres_kernel = self.orig

    def ms(self) -> float:
        torch.cuda.synchronize()
        return sum(a.elapsed_time(b) for a, b in self.pairs)


def _wavefront_run(scene, cfg, timer: bool = False):
    """One render(); returns (image, stats, seconds, K7 ms or None)."""
    stats = RenderStats()
    t0 = time.perf_counter()
    if timer:
        with _K7Timer() as tm:
            img = render(scene, cfg, stats=stats)
        k7_ms = tm.ms()
    else:
        img = render(scene, cfg, stats=stats)
        k7_ms = None
    return img, stats, time.perf_counter() - t0, k7_ms


def phase_wavefront_main() -> dict:
    """The wavefront main path: random_balls 1200x800, regen, depth 50, 8
    spp in one launch after a warm-up launch, with K7's launch count set
    to 0 just before and read just after; the image mean held to the
    megakernel's at the same shape."""
    scene = make_scene("random_balls", WNX / WNY)
    cfg = RenderConfig(nx=WNX, ny=WNY, spp=WSPP, samples_per_launch=WSPP,
                       max_depth=WDEPTH, seed=0, loop_mode="regen",
                       device="cuda")
    k7.KERNEL_LAUNCHES["K7"] = 0
    render(scene, cfg)                                   # warm-up
    launches_warm = k7.KERNEL_LAUNCHES["K7"]
    torch.cuda.synchronize()
    syncs0 = dict(SYNCS)
    img, stats, secs, k7_ms = _wavefront_run(
        scene, RenderConfig(**{**cfg.__dict__, "seed": 1}), timer=True)
    launches = k7.KERNEL_LAUNCHES["K7"]
    syncs = SYNCS["regen"] - syncs0["regen"]
    mega = render(scene, RenderConfig(nx=WNX, ny=WNY, spp=WSPP,
                                      samples_per_launch=WSPP,
                                      max_depth=WDEPTH, seed=1,
                                      loop_mode="mega", device="cuda"))
    mean, mean_mk = img.mean().item(), mega.mean().item()
    rel = abs(mean - mean_mk) / mean_mk
    print(f"phase 14 wavefront main path (random_balls {WNX}x{WNY}, regen, "
          f"{WSPP} spp in one launch, depth {WDEPTH}, 1 warm-up + 1 timed "
          f"launch): {stats.rays_per_s:.6e} path segments/s, {secs:.4f} s "
          f"per launch, {stats.segments:.6e} segments, {stats.iterations} "
          f"iterations, host syncs {syncs} (one every {CHECK_EVERY} "
          f"iterations), K7 launches {launches} "
          f"({launches - launches_warm} timed), K7 wrapper time "
          f"{k7_ms:.3f} ms = {k7_ms / (secs * 1e3):.4f} of the launch; "
          f"image mean {mean:.6f} vs megakernel {mean_mk:.6f} (rel "
          f"{rel:.5f} < 0.02)", flush=True)
    if launches < 1:
        fail("the wavefront main path launched no K7 kernel")
    if not torch.isfinite(img).all() or img.shape != (WNY, WNX, 3):
        fail("wavefront image is not finite or has the wrong shape")
    if rel >= 0.02:
        fail("wavefront image mean differs from the megakernel's")
    return dict(launches=launches, rate=stats.rays_per_s, secs=secs,
                k7_share=k7_ms / (secs * 1e3))


def phase_wavefront_paths() -> None:
    """The other wavefront paths through render(), one launch each, K7's
    launch count set to 0 just before each and read just after (the BVH
    scene traverses its tree in plain PyTorch and launches none)."""
    for name, kw, nx, ny, spp, mode, extra in WAVEFRONT_PATHS:
        scene = make_scene(name, nx / ny, **kw)
        import dataclasses
        if extra.get("normals"):
            scene = dataclasses.replace(scene,
                                        render_type=scene_types.RENDER_NORMAL)
        if "lambertian_strategy" in extra:
            scene = dataclasses.replace(
                scene, lambertian_strategy=extra["lambertian_strategy"])
        cfg = RenderConfig(nx=nx, ny=ny, spp=spp, samples_per_launch=spp,
                           max_depth=WDEPTH, seed=3, loop_mode=mode,
                           device="cuda")
        k7.KERNEL_LAUNCHES["K7"] = 0
        b0 = SYNCS["bvh"]
        img, stats, secs, _ = _wavefront_run(scene, cfg)
        launches = k7.KERNEL_LAUNCHES["K7"]
        label = f"{name}{kw or ''} {mode} {extra or ''}".strip()
        print(f"phase 15 wavefront path ({label}, {nx}x{ny}x{spp}, depth "
              f"{WDEPTH}): {stats.rays_per_s:.6e} path segments/s, "
              f"{secs:.4f} s, {stats.segments:.6e} segments, "
              f"{stats.iterations} iterations, K7 launches {launches}, BVH "
              f"syncs {SYNCS['bvh'] - b0}, image mean "
              f"{img.mean().item():.6f}", flush=True)
        if not torch.isfinite(img).all():
            fail(f"wavefront image of {label} is not finite")
        if scene.bvh is None and launches < 1:
            fail(f"the {label} path launched no K7 kernel")
        if scene.bvh is not None and SYNCS["bvh"] == b0:
            fail("the BVH scene did not traverse its BVH")


def phase_wavefront_goldens() -> None:
    """The pixelwise criterion of tests/test_golden.py through render()
    in regen mode (launches of 1024 spp), at REGEN_GOLDEN_SPP."""
    _goldens("phase 16 regen golden", "regen", 1024, REGEN_GOLDEN_SPP)



def _with(scene, table, **leaves):
    import dataclasses
    return dataclasses.replace(scene, **{table: dataclasses.replace(
        getattr(scene, table), **leaves)})


def _launch_counts() -> dict:
    return {**mk.KERNEL_LAUNCHES, **k7.KERNEL_LAUNCHES}


def _reset_counts() -> None:
    for counts in (mk.KERNEL_LAUNCHES, k7.KERNEL_LAUNCHES):
        for name in counts:
            counts[name] = 0


def _host_ms(fn):
    """fn() timed on the host clock between two synchronisations."""
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    out = fn()
    torch.cuda.synchronize()
    return (time.perf_counter() - t0) * 1e3, out


def _hit_grads(scene, o, d, tm, ds, plain: bool):
    """Gradients of sum(t over hits) w.r.t. (radius, center0, o, d)
    through geometry.HitSpheres, its forward the kernel or (plain) its
    plain version on the same card tensors; and the Function's ms."""
    rad = ds.spheres.radius.clone().requires_grad_()
    c0 = ds.spheres.center0.clone().requires_grad_()
    o, d = o.clone().requires_grad_(), d.clone().requires_grad_()
    orig = k7.hit_spheres_kernel
    if plain:
        k7.hit_spheres_kernel = k7.hit_spheres_reference

    def run():
        bt, bi = geometry.HitSpheres.apply(
            o, d, tm, c0, ds.spheres.center1, ds.spheres.time0,
            ds.spheres.time1, rad, ds.sphere_table,
            scene.has_moving_spheres, geometry.T_MIN)
        grads = torch.autograd.grad(torch.where(bt < 1e30, bt, 0.0).sum(),
                                    [rad, c0, o, d])
        return bi, grads
    try:
        ms, (bi, grads) = _host_ms(run)
    finally:
        k7.hit_spheres_kernel = orig
    return bi, grads, ms


def phase_k7_vjp() -> dict:
    """K7's VJP on the card: HitSpheres with the kernel forward against the
    same Function with the plain forward, on the rays of the first regen
    iteration of random_balls (N = 524,288): indices equal, gradients
    w.r.t. radius, center0, o and d to rtol K7_GRAD_RTOL."""
    scene = make_scene("random_balls", WNX / WNY)
    from raytracingweekend_tpu_torch.ops.packing import device_scene
    ds = device_scene(scene, "cuda")
    o, d, tm = _capture_regen_rays(scene, 1)[0]
    _hit_grads(scene, o, d, tm, ds, plain=False)             # warm-up
    bi_k, g_k, ms_k = _hit_grads(scene, o, d, tm, ds, plain=False)
    bi_p, g_p, ms_p = _hit_grads(scene, o, d, tm, ds, plain=True)
    rel = [((a - b).abs().max() / b.abs().max().clamp_min(1e-30)).item()
           for a, b in zip(g_k, g_p)]
    ok = (torch.equal(bi_k, bi_p)
          and all(torch.isfinite(a).all() for a in g_k)
          and all(torch.allclose(a, b, rtol=K7_GRAD_RTOL, atol=1e-6)
                  for a, b in zip(g_k, g_p)))
    err = max((a - b).abs().max().item() for a, b in zip(g_k, g_p))
    print(f"phase 17 K7 VJP (HitSpheres, random_balls regen rays N="
          f"{o.shape[0]}, S={ds.sphere_table.shape[0]} moving): indices "
          f"equal {torch.equal(bi_k, bi_p)}, gradients (radius, center0, o, "
          f"d) kernel-forward vs plain-forward max abs diff {err:.3e}, max "
          f"rel (to each gradient's largest entry) "
          f"{', '.join(f'{r:.3e}' for r in rel)} (rtol {K7_GRAD_RTOL}); "
          f"forward + backward {ms_k:.3f} ms with the kernel, {ms_p:.3f} ms "
          f"with the plain forward: {'ok' if ok else 'FAIL'}", flush=True)
    if not ok:
        fail("K7's VJP disagrees between the kernel and the plain forward")
    return dict(max_abs_err=err, ms=ms_k, plain_ms=ms_p)


def phase_mega_grad() -> dict:
    """One megakernel gradient step at the workload: the tape launch
    (CUDA events, mean of 5 after a warm-up), the replay forward and its
    value and gradient (host clock, one each), peak memory, the replay
    image against the kernel's tape image, and central differences of
    mean(img^2) through the kernel's tape forward at G_FD (eps 1e-3, rtol
    2e-3, as tests/test_mega_grad.py:98-108; the emission entry at a step
    of the same size relative to its value). Launch counts are set to 0
    before and read after."""
    scene = make_scene("cornell_box", GNX / GNY)
    key = prng.key(3)
    ctx = mg.plan_tape(scene, GNX, GNY, GSPP, max_depth=GDEPTH, T=GT,
                       device="cuda")
    _reset_counts()
    img, tape, seed = mg.tape_forward(key, ctx)              # warm-up
    tape_ms, (img, tape, seed) = _event_ms(
        lambda: mg.tape_forward(key, ctx), 5)
    replay = mg.make_replay(ctx)
    torch.cuda.reset_peak_memory_stats()
    with torch.no_grad():
        fwd_ms, img_r = _host_ms(lambda: replay(scene, tape, seed))
    fwd_mem = torch.cuda.max_memory_allocated()
    col0 = np.asarray(scene.textures.color, np.float32)
    col = torch.tensor(col0, device="cuda", requires_grad=True)

    def value_and_grad():
        loss = torch.mean(replay(_with(scene, "textures", color=col), tape,
                                 seed) ** 2)
        loss.backward()
        return loss

    torch.cuda.reset_peak_memory_stats()
    vg_ms, loss = _host_ms(value_and_grad)
    vg_mem = torch.cuda.max_memory_allocated()
    counts = _launch_counts()
    close = torch.isclose(img_r, img, rtol=RTOL, atol=ATOL).all(dim=-1)
    out_frac = 1.0 - close.float().mean().item()
    err = (img_r - img).abs().max().item()

    def kernel_loss(c):
        c2 = mg._retabbed(ctx, _with(scene, "textures", color=c))
        return torch.mean(mg.tape_forward(key, c2)[0].double() ** 2).item()

    fd_rows = []
    for idx, eps in G_FD:
        hi, lo = col0.copy(), col0.copy()
        hi[idx] += eps
        lo[idx] -= eps
        # the step the float32 entries really take
        fd = ((kernel_loss(hi) - kernel_loss(lo))
              / (float(hi[idx]) - float(lo[idx])))
        fd_rows.append((idx, eps, fd, col.grad[idx].item()))
    fd_ok = all(np.isclose(fd, g, rtol=2e-3, atol=1e-6)
                for _, _, fd, g in fd_rows)
    grad_ok = bool(torch.isfinite(col.grad).all()) and loss.isfinite()
    n_iters = ctx["plan"].n_iters
    print(f"phase 18 megakernel gradient step (cornell_box {GNX}x{GNY}, "
          f"{GSPP} spp, depth {GDEPTH}, T={GT}, {ctx['n_tiles']} tiles, "
          f"{n_iters} tape iterations; w.r.t. textures.color): tape forward "
          f"{tape_ms:.4f} ms (CUDA events, mean of 5), replay forward "
          f"{fwd_ms:.1f} ms (peak {fwd_mem / 2**30:.3f} GiB), replay value "
          f"and grad {vg_ms:.1f} ms (peak {vg_mem / 2**30:.3f} GiB), loss "
          f"{loss.item():.6e}; replay pixels outside rtol {RTOL} / atol "
          f"{ATOL} of the kernel's image {out_frac:.6f} (allowed "
          f"{G_MAX_OUT}), max abs diff {err:.3e}; central FD through the "
          f"kernel (rtol 2e-3): "
          + "; ".join(f"color{list(i)} eps {e} fd {fd:.6e} vs replay "
                      f"{g:.6e}" for i, e, fd, g in fd_rows)
          + f"; launches {counts}: "
          f"{'ok' if fd_ok and grad_ok and out_frac <= G_MAX_OUT else 'FAIL'}",
          flush=True)
    if counts["K2+K3"] < 1:
        fail("the megakernel gradient step launched no megakernel")
    if out_frac > G_MAX_OUT or not grad_ok:
        fail("the replay does not reproduce the kernel's tape image")
    if not fd_ok:
        fail("replay gradients disagree with finite differences through "
             "the kernel")
    _replay_profile()
    return dict(tape_ms=tape_ms, fwd_ms=fwd_ms, vg_ms=vg_ms, vg_mem=vg_mem,
                launches=counts["K2+K3"], max_abs_err=err)


def _replay_profile() -> None:
    """Where a replay iteration's time goes at the workload's width
    (cornell_box 128x128, 16,384 lanes) over a 4-iteration tape (1 spp,
    depth 4): one value and gradient unprofiled on the host clock, then
    one under torch.profiler (CUDA activity): device kernels an
    iteration, device ms an iteration, the device's busy share, the
    costliest kernels."""
    from torch.profiler import ProfilerActivity, profile

    from raytracingweekend_tpu_torch.wavefront_profile import (
        device_time_by_kernel)
    scene = make_scene("cornell_box", GNX / GNY)
    ctx = mg.plan_tape(scene, GNX, GNY, 1, max_depth=4, T=GT, device="cuda")
    _, tape, seed = mg.tape_forward(prng.key(5), ctx)
    replay = mg.make_replay(ctx)
    col = torch.tensor(np.asarray(scene.textures.color, np.float32),
                       device="cuda", requires_grad=True)

    def step():
        torch.mean(replay(_with(scene, "textures", color=col), tape,
                          seed) ** 2).backward()

    step()                                                   # warm-up
    wall_ms, _ = _host_ms(step)
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        step()
        torch.cuda.synchronize()
    by_name = device_time_by_kernel(prof)
    n_it = ctx["plan"].n_iters
    busy = sum(ms for ms, _, _ in by_name.values())
    n_k = sum(n for _, n, _ in by_name.values())
    top = sorted(((ms, n, k) for k, (ms, n, _) in by_name.items()),
                 reverse=True)[:6]
    print(f"phase 18b replay profile (cornell_box {GNX}x{GNY}, {n_it} "
          f"iterations, value and grad): unprofiled {wall_ms:.1f} ms = "
          f"{wall_ms / n_it:.2f} ms an iteration; device kernels "
          f"{n_k / max(n_it, 1):.0f} an iteration, device time "
          f"{busy / max(n_it, 1):.3f} ms an iteration, busy share "
          f"{busy / wall_ms:.3f}; top: "
          + "; ".join(f"{k} {ms:.2f} ms x{n}" for ms, n, k in top),
          flush=True)


def phase_mega_fit() -> dict:
    """fit_scene_params_mega on the card: cornell_box's wall colour 1 set
    to 0.2 is recovered from the kernel's target image under the criteria
    of tests/test_mega_grad.py:431-457 (final loss below half the first,
    colour within 0.25)."""
    nx, ny, spp, depth = GFIT
    scene = make_scene("cornell_box", nx / ny)
    key = prng.key(0)
    ctx = mg.plan_tape(scene, nx, ny, spp, max_depth=depth, device="cuda")
    target, _, _ = mg.tape_forward(key, ctx)
    color = np.asarray(scene.textures.color, np.float32)
    bad = color.copy()
    bad[1] = 0.2
    losses = []
    secs, (fitted, final) = _host_ms(lambda: mg.fit_scene_params_mega(
        _with(scene, "textures", color=bad), target,
        get_params=lambda sc: sc.textures.color,
        set_params=lambda sc, p: _with(sc, "textures", color=p),
        key=key, nx=nx, ny=ny, spp=spp, max_depth=depth, steps=12, lr=0.08,
        postprocess=lambda p: torch.clamp_min(p, 0.0),
        log_fn=lambda i, v: losses.append(v), device="cuda"))
    rec = np.asarray(fitted.textures.color[1])
    dist = float(np.abs(rec - color[1]).max())
    ok = final < losses[0] * 0.5 and dist < 0.25
    print(f"phase 19 megakernel fit (cornell_box {nx}x{ny}, {spp} spp, depth "
          f"{depth}, T=1024, 12 Adam steps, lr 0.08): losses "
          f"{', '.join(f'{v:.6e}' for v in losses)}; wall colour {rec} vs "
          f"{color[1]} (max abs {dist:.4f} < 0.25); {secs / 1e3:.3f} s, "
          f"{secs / 12:.1f} ms a step: {'ok' if ok else 'FAIL'}", flush=True)
    if not ok:
        fail("fit_scene_params_mega did not recover the wall colour")
    return dict(step_ms=secs / 12)


def _render_diff_vg(scene, table, field, key, nx, ny, spp, depth, device):
    """render_diff's value and gradient of mean(img) w.r.t. one leaf."""
    p = torch.tensor(np.asarray(getattr(getattr(scene, table), field),
                                np.float32), device=device,
                     requires_grad=True)
    img = tgrad.render_diff(_with(scene, table, **{field: p}), key, nx, ny,
                            spp, depth, device=device)
    img.mean().backward()
    return img.detach(), p.grad


def phase_wavefront_grad() -> dict:
    """render_diff's value and gradient on the card: cornell_box at the
    workload w.r.t. textures.color, random_balls at GRB w.r.t. the radii
    (K7 and its VJP every bounce), with times and peak memory, launch
    counts set to 0 before and read after; the random_balls gradient
    against the CPU's plain path on the same key at GCPU."""
    key = prng.key(0)
    scene = make_scene("cornell_box", GNX / GNY)
    _render_diff_vg(scene, "textures", "color", key, 16, 16, 2, GDEPTH,
                    "cuda")                                  # warm-up
    _reset_counts()
    torch.cuda.reset_peak_memory_stats()
    c_ms, (img, g) = _host_ms(lambda: _render_diff_vg(
        scene, "textures", "color", key, GNX, GNY, GSPP, GDEPTH, "cuda"))
    c_mem = torch.cuda.max_memory_allocated()
    c_k7 = k7.KERNEL_LAUNCHES["K7"]
    ok = bool(torch.isfinite(g).all()) and bool(torch.isfinite(img).all())
    rb = make_scene("random_balls", 1.0)
    nx, ny, spp, depth = GRB
    k7.KERNEL_LAUNCHES["K7"] = 0
    torch.cuda.reset_peak_memory_stats()
    r_ms, (img_b, g_b) = _host_ms(lambda: _render_diff_vg(
        rb, "spheres", "radius", key, nx, ny, spp, depth, "cuda"))
    r_mem = torch.cuda.max_memory_allocated()
    r_k7 = k7.KERNEL_LAUNCHES["K7"]
    ok = ok and bool(torch.isfinite(g_b).all()) and int((g_b != 0).sum()) > 0
    cnx, cny, cspp, cdepth = GCPU
    _, g_gpu = _render_diff_vg(rb, "spheres", "radius", key, cnx, cny, cspp,
                               cdepth, "cuda")
    _, g_cpu = _render_diff_vg(rb, "spheres", "radius", key, cnx, cny, cspp,
                               cdepth, "cpu")
    g_gpu = g_gpu.cpu()
    rel = ((g_gpu - g_cpu).norm() / g_cpu.norm().clamp_min(1e-30)).item()
    ok = ok and rel < 1e-2 and int((g_cpu != 0).sum()) > 0
    print(f"phase 20 wavefront gradient (render_diff, trace scan): "
          f"cornell_box {GNX}x{GNY}x{GSPP} depth {GDEPTH} w.r.t. "
          f"textures.color {c_ms:.1f} ms (peak {c_mem / 2**30:.3f} GiB, K7 "
          f"launches {c_k7}); random_balls {nx}x{ny}x{spp} depth {depth} "
          f"w.r.t. radii {r_ms:.1f} ms (peak {r_mem / 2**30:.3f} GiB, K7 "
          f"launches {r_k7}, {int((g_b != 0).sum())} non-zero radius "
          f"gradients); card vs CPU plain path at {cnx}x{cny}x{cspp} depth "
          f"{cdepth}: relative L2 difference of the radius gradients "
          f"{rel:.3e} (< 1e-2): {'ok' if ok else 'FAIL'}", flush=True)
    if c_k7 < 1 or r_k7 < 1:
        fail("the wavefront gradient launched no K7 kernel")
    if not ok:
        fail("the wavefront gradient is not finite or disagrees with the "
             "CPU's")
    return dict(launches=c_k7 + r_k7, c_ms=c_ms, r_ms=r_ms)


def _sm_clock_mhz(fn, n: int) -> tuple[int, int]:
    """The SM clock and its maximum (MHz) that nvidia-smi reads while n
    calls of fn() run on the card."""
    for _ in range(n):
        fn()
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=clocks.sm,clocks.max.sm",
         "--format=csv,noheader,nounits"],
        capture_output=True, text=True, check=True, timeout=60)
    torch.cuda.synchronize()
    sm, top = (int(v) for v in smi.stdout.split("\n")[0].split(","))
    return sm, top


def phase_sweep_twin(sweep: dict, k1_path: dict, k1: dict) -> dict:
    """The sweep twin (K8) on the book-1 plan: both variants held to the
    plain version bit for bit at K8_CHECK iterations and the book-1
    launch's width; then the tool's path (`sweep_twin.run`, both variants
    at the default K), with K8's count set to 0 just before and read just
    after, its timed launches held to the plain version bit for bit; its
    implied ceiling beside K1's segments/s (phase 5's path, phase 5b's
    kernel), its slot loop's SASS beside K1's, and its issue-rate share
    at the SM clock read under its load."""
    soa, attr, plan = k8.book1_inputs("cuda")
    S, T, G = soa.shape[1], plan.T, k8.default_grid(plan)
    err = 0.0

    def held(K, ext, out_k, attrs_k, label):
        out_r, attrs_r = k8.sweep_twin_reference(
            soa, attr, T, G, K, plan.ut_t0, plan.ut_idt, ext)
        torch.cuda.synchronize()
        same = torch.equal(out_k, out_r) and (
            not ext or torch.equal(attrs_k, attrs_r))
        done = out_k[:, 1].min().item()
        print(f"phase 24 K8 kernel vs plain ({'ext' if ext else 'quad'}, "
              f"S={S}, T={T}, G={G}, K={K}, {label}): bit-equal {same}"
              f"{' with the attribute rows' if ext else ''}, iterations "
              f"done {done}", flush=True)
        if not same or done != K:
            fail("the sweep twin disagrees with its plain version")
        return (out_k - out_r).abs().max().item()

    for ext in (False, True):
        out_k, attrs_k = k8.sweep_twin_kernel(
            soa, attr, T, G, K8_CHECK, plan.ut_t0, plan.ut_idt, ext)
        err = max(err, held(K8_CHECK, ext, out_k, attrs_k, "one launch"))
    timed = []
    k8.KERNEL_LAUNCHES["K8"] = 0
    rows = k8.run(k8.VARIANTS, k8.DEFAULT_ITERS, G, 3, "cuda", timed)
    launches = k8.KERNEL_LAUNCHES["K8"]
    for row in rows:
        print(f"phase 24 {json.dumps(row)}", flush=True)
    quad, ext_row = rows
    K = quad["K"]
    for (out_k, attrs_k), ext in zip(timed, (False, True)):
        err = max(err, held(K, ext, out_k, attrs_k, "the timed launch"))
    plain_ms, _ = _event_ms(lambda: k8.sweep_twin_reference(
        soa, attr, T, G, K, plan.ut_t0, plan.ut_idt, False), 1)
    bound = k8.bound_ms(S, T, G, quad["iters_done"], plan.moving_axes)
    k1_rate = k1["segments"] / (k1["ms"] * 1e-3)
    twin_rate = quad["implied_ceiling_seg_per_s"]
    # K1's instantiation for the book-1 plan: the y-only, uniform-shutter
    # slot loop, which the twin runs too
    k1_loop = f"<{mk.sweep_axes(plan)},{int(plan.uniform_time)}>"
    loops = {k: sweep.get(k) for k in ("twin<0>", "twin<1>", k1_loop)}
    per_slot = "; ".join(
        f"{k}: {n / s:.2f} (FFMA {fa / s:.2f}, FMUL {fm / s:.2f}, FADD "
        f"{fd / s:.2f}, LDS {ld / s:.2f})"
        for k, (n, s, fa, fm, fd, ld) in loops.items() if s)
    mix = {k: tuple(c / v[1] for c in v[2:]) for k, v in loops.items()
           if v and v[1]}
    same_mix = "twin<0>" in mix and mix["twin<0>"] == mix.get(k1_loop)
    # the slot loop's instructions at full issue (four warp-instructions a
    # cycle on each SM) and the SM clock read under the quad launch's load
    clock, top = _sm_clock_mhz(lambda: k8.sweep_twin_kernel(
        soa, attr, T, G, K, plan.ut_t0, plan.ut_idt, False), 12)
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    n, slots = loops["twin<0>"][:2] if "twin<0>" in mix else (0, 1)
    issue_ms = (G * T / 32 * K * S * n / slots / (4 * sms * clock * 1e6)
                * 1e3)
    print(f"phase 24 sweep twin (S={S}, T={T}, G={G}, K={K}, launches "
          f"{launches}): quad {quad['ms']:.3f} ms a launch, implied ceiling "
          f"{twin_rate:.6e} segments/s ({1e9 / twin_rate:.4f} ns a "
          f"segment); ext {ext_row['ms']:.3f} ms, "
          f"{ext_row['implied_ceiling_seg_per_s']:.6e}; plain PyTorch "
          f"{plain_ms:.3f} ms (one block traced); bound {bound:.3f} ms by "
          f"operations (moving axes {plan.moving_axes}; share "
          f"{bound / quad['ms']:.3f}). K1: path "
          f"{k1_path['rate']:.6e} segments/s (phase 5), kernel "
          f"{k1_rate:.6e} (phase 5b, {1e9 / k1_rate:.4f} ns a segment); "
          f"K1 / twin {k1_path['rate'] / twin_rate:.4f} (path), "
          f"{k1_rate / twin_rate:.4f} (kernel); full - twin "
          f"{1e9 / k1_rate - 1e9 / twin_rate:.4f} ns a segment; slot loop "
          f"SASS a slot {per_slot} (twin's FFMA / FMUL / FADD / LDS a "
          f"slot {'equal to' if same_mix else 'DIFFER from'} K1's "
          f"{k1_loop}); SM clock "
          f"{clock} MHz under the quad launch (max {top}, {sms} SMs): the "
          f"twin's slot loop at full issue {issue_ms:.3f} ms, issue share "
          f"{issue_ms / quad['ms']:.3f}", flush=True)
    if launches < len(rows):
        fail("the sweep twin's path launched no K8 kernel")
    if "twin<0>" not in mix:
        fail("the sweep twin's slot loop is missing from its SASS")
    return dict(ms=quad["ms"], ext_ms=ext_row["ms"], plain_ms=plain_ms,
                bound_ms=bound, launches=launches, max_abs_err=err, S=S,
                T=T, G=G, K=K)


def phase_microbench() -> dict:
    """The microbenchmark (K9): the tool's path (`dot_microbench.run`, every
    row at S = 512, T = 2048, with its torch.matmul yardstick), with K9's
    count set to 0 just before and read just after; then every row held to
    its plain version at K9_CHECK steps within `plain_tolerance`."""
    regs = {k: v for k, v in sass.registers(_build.build_log()).items()
            if k.startswith("k9")}
    print(f"phase 25 K9 build: {k9.COLS} columns a block of {k9.WARPS} "
          f"warps ({K9_T // k9.COLS} blocks at T={K9_T}); registers, spill "
          f"and stack bytes {json.dumps(regs)}", flush=True)
    if len(regs) != len(k9.ROWS) or any(sp for _, sp, _ in regs.values()):
        fail("K9's nine instantiations are not in the build log, or spill")
    k9.KERNEL_LAUNCHES["K9"] = 0
    rows = k9.run(K9_S, K9_T, K9_N, K9_REPS, "cuda")
    launches = k9.KERNEL_LAUNCHES["K9"]
    tables = k9.make_tables(K9_S)
    out = []
    for (name, body, unit), row in zip(k9.ROWS, rows):
        tab = k9.table_for(body, unit, tables, "cuda")
        got = k9.microbench_kernel(body, unit, tab, K9_S, K9_T, K9_CHECK)
        plain_ms, want = _event_ms(lambda: k9.microbench_reference(
            body, unit, tab, K9_S, K9_T, K9_CHECK), 1)
        err = (got - want).abs()
        tol = k9.plain_tolerance(body, tab)
        ok = bool((err <= tol).all()) and bool(torch.isfinite(got).all())
        # the FP32 rows (the extract's sums in the plain version's order)
        # bit for bit
        ok = ok and (unit != "fp32" or torch.equal(got, want))
        lib = row["library_us_per_iter"]
        print(f"phase 25 K9 {name} ({unit}, S={K9_S}, T={K9_T}, steps "
              f"{K9_N}/{4 * K9_N}): {row['us_per_iter']:.4f} us a step, "
              f"{row['ops_per_s']:.6e} ops/s, bound "
              f"{row['bound_us_per_iter']:.4f} us (share "
              f"{row['bound_us_per_iter'] / row['us_per_iter']:.4f}), "
              f"torch.matmul "
              f"{'-' if lib is None else f'{lib:.4f} us a step'}, plain "
              f"PyTorch {plain_ms * 1e3 / K9_CHECK:.3f} us a step; kernel "
              f"vs plain at {K9_CHECK} steps: max abs err "
              f"{err.max().item():.3e} (tolerance {tol.max().item():.3e}), "
              f"bit-equal {torch.equal(got, want)}", flush=True)
        if not ok:
            fail(f"K9 {name} disagrees with its plain version")
        out.append(dict(name=name, h100_unit=unit,
                        ms=row["us_per_iter"] * 1e-3,
                        plain_ms=plain_ms / K9_CHECK,
                        bound_ms=row["bound_us_per_iter"] * 1e-3,
                        library_ms=None if lib is None else lib * 1e-3,
                        max_abs_err=err.max().item()))
    print(f"phase 25 K9 launches on the tool path {launches}", flush=True)
    if launches < 2 * len(rows):
        fail("the microbenchmark's path launched too few K9 kernels")
    return dict(rows=out, launches=launches)


# the pallas_call each Mosaic repro formulation replaces
MOSAIC_REPLACES = {
    "K10": "tools/mosaic_repros/repro_f32_iota.py:47",
    "K11": "tools/mosaic_repros/repro_slice_broadcast_layout.py:56",
    "K12": "tools/mosaic_repros/repro_scalar_reduce.py:55",
    "K13 A dynamic-sublane-slice":
        "tools/mosaic_repros/repro_dynamic_cull.py:75",
    "K13 B dynamic-lane-slice": "tools/mosaic_repros/repro_dynamic_cull.py:92",
    "K13 C dynamic-trip-fori+smem":
        "tools/mosaic_repros/repro_dynamic_cull.py:120",
    "K13 D scalar-compaction-smem":
        "tools/mosaic_repros/repro_dynamic_cull.py:158",
    "K14 subslice": "tools/mosaic_repros/repro_dot_k3_subslice.py:56",
    "K14 dense": "tools/mosaic_repros/repro_dot_k3_subslice.py:64",
}
# the repro kernels' names in csrc/mosaic_repros.cu (and template
# argument) -> the formulation
MOSAIC_KERNELS = {
    ("iota_f32", None): "K10 f32 iota",
    ("iota_int_cast", None): "K10 int iota + cast",
    ("slice", "true"): "K11 register slice",
    ("slice", "false"): "K11 ref load",
    ("scalar_reduce", None): "K12 scalar reduce",
    ("cull_a", None): "K13 A dynamic-sublane-slice",
    ("cull_b", None): "K13 B dynamic-lane-slice",
    ("cull_c", None): "K13 C dynamic-trip-fori+smem",
    ("cull_d", None): "K13 D scalar-compaction-smem",
    ("dot_k3", "128"): "K14 subslice",
    ("dot_k3", "3"): "K14 dense",
    ("empty", None): "floor",
}
MOSAIC_PAIRS = {"K10": ("f32 iota", "int iota + cast"),
                "K11": ("register slice", "ref load"),
                "K14": ("subslice", "dense")}


def _device_us(ev) -> float:
    return getattr(ev, "self_device_time_total",
                   getattr(ev, "self_cuda_time_total", 0.0))


def _mosaic_device_us() -> dict:
    """Device µs a launch of each repro kernel and of the empty kernel
    ("floor"): one run of the tool at 20 launches a formulation, then 20
    timed launches of the empty kernel, under torch.profiler (CUDA
    activity); {} if the profiler saw no device time."""
    from torch.profiler import ProfilerActivity, profile
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        mosaic_repros.run("cuda", launches=20)
        launch_floor.run("cuda", 20)
        torch.cuda.synchronize()
    out = {}
    for ev in prof.key_averages():
        dev_us = _device_us(ev)
        m = re.search(r"repro_(\w+?)_kernel(?:<(\w+)>)?", ev.key)
        key = MOSAIC_KERNELS.get(m.groups()) if m else None
        if key and dev_us > 0 and ev.count:
            out[key] = dev_us / ev.count
    return out


def _library_device_us(launches: int = 20) -> dict:
    """Device µs a call of the library yardsticks of K11 and K14 on their
    repros' inputs, as `_mosaic_device_us` takes the kernels': each call
    alone under torch.profiler, `launches` times (K14's with TF32 allowed
    once around them all, `k14.tf32`), all its device time over the count
    ({kernel: µs}; a kernel missing if the profiler saw no device
    time)."""
    from torch.profiler import ProfilerActivity, profile
    from raytracingweekend_tpu_torch.tools.mosaic_repros import (
        repro_dot_k3_subslice as k14, repro_slice_broadcast_layout as k11)
    row, col = k11.inputs(0, "cuda")
    tab, rays = k14.inputs(0, "cuda")
    out = {}
    for key, fn, under in (("K11", lambda: torch.mul(row, col),
                            contextlib.nullcontext),
                           ("K14", k14.library(tab, rays), k14.tf32)):
        with under():
            fn()
            torch.cuda.synchronize()
            with profile(activities=[ProfilerActivity.CUDA]) as prof:
                for _ in range(launches):
                    fn()
                torch.cuda.synchronize()
        dev_us = sum(_device_us(ev) for ev in prof.key_averages())
        if dev_us > 0:
            out[key] = dev_us / launches
    return out


def _k11_spread(rounds: int = K11_ROUNDS, launches: int = 20) -> dict:
    """K11's two forms and its yardstick torch.mul on the repro's inputs,
    device µs a call, each in `rounds` profiles of `launches` calls (as
    `_mosaic_device_us` takes them), in turns; the ratios of each form to
    torch.mul a round. {} if the profiler saw no device time."""
    from torch.profiler import ProfilerActivity, profile
    from raytracingweekend_tpu_torch.tools.mosaic_repros import (
        repro_slice_broadcast_layout as k11)
    row, col = k11.inputs(0, "cuda")
    fns = {"register slice": lambda: k11.reg_slice_kernel(row, col),
           "ref load": lambda: k11.ref_load_kernel(row, col),
           "torch.mul": lambda: torch.mul(row, col)}
    us = {k: [] for k in fns}
    for _ in range(rounds):
        for key, fn in fns.items():
            fn()
            torch.cuda.synchronize()
            with profile(activities=[ProfilerActivity.CUDA]) as prof:
                for _ in range(launches):
                    fn()
                torch.cuda.synchronize()
            dev = sum(_device_us(ev) for ev in prof.key_averages())
            if dev <= 0:
                return {}
            us[key].append(dev / launches)
    ratio = {k: [a / b for a, b in zip(us[k], us["torch.mul"])]
             for k in ("register slice", "ref load")}
    return dict(us=us, ratio=ratio)


def _host_spread(rounds: int = K11_ROUNDS,
                 launches: int = launch_floor.LAUNCHES) -> dict:
    """K11's and K14's forms and their yardsticks (torch.mul; TF32
    torch.matmul, with TF32 allowed once around its timing) on the repros'
    inputs, µs a call as the tool's rows take them (the CUDA-event mean of
    `launches` calls in a row), `rounds` rounds in turns, each form then
    its yardstick; the ratio of each form to its yardstick a round."""
    from raytracingweekend_tpu_torch.tools.mosaic_repros import (
        repro_dot_k3_subslice as k14, repro_slice_broadcast_layout as k11)
    row, col = k11.inputs(0, "cuda")
    tab, rays = k14.inputs(0, "cuda")
    lhs = tab[:, 0:k14.K].contiguous()
    mul, matmul = (lambda: torch.mul(row, col)), k14.library(tab, rays)
    forms = {"K11 register slice": (lambda: k11.reg_slice(row, col), mul,
                                    contextlib.nullcontext),
             "K11 ref load": (lambda: k11.ref_load(row, col), mul,
                              contextlib.nullcontext),
             "K14 subslice": (lambda: k14.subslice(tab, rays), matmul,
                              k14.tf32),
             "K14 dense": (lambda: k14.dense(lhs, rays), matmul, k14.tf32)}
    us = {k: [] for k in forms}
    lib = {k: [] for k in forms}
    for _ in range(rounds):
        for key, (fn, yardstick, under) in forms.items():
            us[key].append(launch_us(fn, "cuda", launches))
            with under():
                lib[key].append(launch_us(yardstick, "cuda", launches))
    return dict(us=us, library_us=lib,
                ratio={k: [a / b for a, b in zip(us[k], lib[k])]
                       for k in forms})


def _host_split(n: int = 2000) -> dict:
    """Where the host time of a K11 register-slice call goes: µs a call on
    the host clock, the mean of n calls in a row (the device synchronised
    after). The wrapper's parts: the whole wrapper; its output's
    allocation (new_empty; torch.empty with dtype and device, as the
    first version made it); the launcher with the output made (argument
    block, stream handle, ctypes, the CUDA launch, the count); the entry
    alone on a packed block (ctypes and the CUDA launch); a ctypes call
    that launches nothing (rtw_error_string); the two stream-handle
    readers and the current-device read; the rest of the wrapper (checks,
    pointers, calls). Beside them: the empty kernel's launch, torch.mul,
    torch.mul into a given output, PyTorch's own launch of a kernel
    (torch._C._cuda_sleep(0)), an empty call (the loop's own cost)."""
    from raytracingweekend_tpu_torch.tools.mosaic_repros import (
        repro_slice_broadcast_layout as k11)
    row, col = k11.inputs(0, "cuda")
    dev, shape = row.get_device(), (k11.SB, k11.T)
    out = torch.empty(shape, device="cuda")
    args = (0, row.data_ptr(), col.data_ptr(), out.data_ptr(), *shape, k11.W)
    lib = _build.load()
    k11.reg_slice_kernel(row, col)          # binds the entry
    block = struct.pack("8q", *args, torch.cuda.current_stream().cuda_stream)
    parts = {
        "wrapper": lambda: k11.reg_slice_kernel(row, col),
        "new_empty": lambda: row.new_empty(shape),
        "torch.empty": lambda: torch.empty(shape, dtype=torch.float32,
                                           device=row.device),
        "launcher": lambda: k11._SLICE.launch("K11 register slice", dev,
                                              *args),
        "entry alone": lambda: lib.rtw_repro_slice_launch(block),
        "ctypes no-op": lambda: lib.rtw_error_string(0),
        "raw stream": lambda: torch._C._cuda_getCurrentRawStream(dev),
        "stream object": lambda: torch.cuda.current_stream(dev).cuda_stream,
        "device read": lambda: torch._C._cuda_getDevice(),
        "empty kernel": lambda: launch_floor.empty_kernel(dev),
        "torch.mul": lambda: torch.mul(row, col),
        "torch.mul out=": lambda: torch.mul(row, col, out=out),
        "PyTorch launch": lambda: torch._C._cuda_sleep(0),
        "empty call": lambda: None}
    us = {}
    for key, fn in parts.items():
        fn()
        fn()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(n):
            fn()
        us[key] = (time.perf_counter() - t0) * 1e6 / n
        torch.cuda.synchronize()
    us["rest of the wrapper"] = (us["wrapper"] - us["new_empty"]
                                 - us["launcher"])
    return us


def _spread_line(values: list) -> str:
    """The values in order taken, then their min, median and max."""
    v = sorted(values)
    return (f"{', '.join(f'{x:.4f}' for x in values)} (min {v[0]:.4f}, "
            f"median {v[len(v) // 2]:.4f}, max {v[-1]:.4f})")


def phase_mosaic_repros(i2f: dict) -> list:
    """The Mosaic repros (K10-K14): the tool's path
    (`mosaic_repros.run`, every formulation at its repro's shapes, 200
    timed launches each), with every count set to 0 just before and read
    just after; then every formulation held to its plain version (bit for
    bit, K14 within 2 ulp of sum |a||b|), each pair's forms to each other
    and K13's probes to the repro's expected arrays. Returns the kernels
    line's K10-K14 entries."""
    from raytracingweekend_tpu_torch.tools.mosaic_repros import (
        repro_dot_k3_subslice as k14, repro_dynamic_cull as k13)
    mosaic_repros.reset_launches()
    outputs = {}
    rows = mosaic_repros.run("cuda", outputs=outputs)
    launches = mosaic_repros.kernel_launches()
    torch.cuda.synchronize()
    device_us = _mosaic_device_us()
    lib_device_us = _library_device_us()
    launch_floor.KERNEL_LAUNCHES["empty"] = 0
    floor_us = launch_floor.run("cuda")
    floor_dev = device_us.get("floor")
    dev_text = "not measured" if floor_dev is None else f"{floor_dev:.4f} us"
    print(f"phase 26 floor (the empty kernel, one warp, through the repros' "
          f"launcher; launches {launch_floor.KERNEL_LAUNCHES['empty']}): "
          f"{floor_us:.4f} us a launch (mean of {launch_floor.LAUNCHES}; "
          f"device {dev_text})", flush=True)
    if launch_floor.KERNEL_LAUNCHES["empty"] < 1:
        fail("the launch floor launched no empty kernel")
    tab, rays = k14.inputs(0, "cuda")
    tol14 = k14.tolerance(tab, rays)
    expect13 = k13.expected()
    by_kernel = {}
    for row in rows:
        key = f"{row['kernel']} {row['name']}"
        got, want = outputs[key]
        err = (got.double() - want.double()).abs()
        if row["kernel"] == "K14":
            rule, held = "within 2 ulp of sum |a||b|", bool(
                torch.all(err <= tol14))
        else:
            rule, held = "bit-equal", torch.equal(got, want)
        pair = MOSAIC_PAIRS.get(row["kernel"])
        same = None if pair is None else torch.equal(
            *(outputs[f"{row['kernel']} {n}"][0] for n in pair))
        expected = (np.array_equal(got.cpu().numpy(), expect13[row["name"]])
                    if row["kernel"] == "K13" else row["as_expected"])
        lib = row["library_us"]
        dev = device_us.get(key)
        lib_dev = lib_device_us.get(row["kernel"]) if lib is not None else None
        print(f"phase 26 {key} ({row['shape']}; launches {launches[key]}): "
              f"{row['us']:.4f} us a launch (mean of 200; device "
              f"{'not measured' if dev is None else f'{dev:.4f} us'}; floor "
              f"{floor_us:.4f} / "
              f"{'-' if floor_dev is None else f'{floor_dev:.4f}'}), plain "
              f"{row['plain_us']:.4f} us, bound {row['bound_us']:.6f} us by "
              f"{row['bound_by']} (share {row['bound_us'] / row['us']:.6f}), "
              f"library {'-' if lib is None else f'{lib:.4f} us'} "
              f"({row['library']}; device "
              f"{'-' if lib_dev is None else f'{lib_dev:.4f} us'}); "
              f"kernel vs plain: {rule} {held}, max "
              f"abs err {err.max().item():.3e}"
              f"{'' if same is None else f'; forms equal {same}'}; the "
              f"repro's answer {expected}", flush=True)
        if not held:
            fail(f"{key} disagrees with its plain version")
        if same is False:
            fail(f"the two forms of {row['kernel']} differ")
        if not expected:
            fail(f"{key} does not give the repro's answer")
        if launches[key] < 1:
            fail(f"the repros' path launched no {key} kernel")
        by_kernel.setdefault(row["kernel"], []).append(dict(
            name=row["name"], ms=row["us"] * 1e-3,
            device_ms=None if dev is None else dev * 1e-3,
            plain_ms=row["plain_us"] * 1e-3,
            bound_ms=row["bound_us"] * 1e-3, bound_by=row["bound_by"],
            library_ms=None if lib is None else lib * 1e-3,
            library_device_ms=None if lib_dev is None else lib_dev * 1e-3,
            max_abs_err=err.max().item(), launches=launches[key],
            floor_ms=floor_us * 1e-3,
            floor_device_ms=None if floor_dev is None else floor_dev * 1e-3,
            replaces=(MOSAIC_REPLACES.get(key)
                      or MOSAIC_REPLACES[row["kernel"]])))
    print(f"phase 26 K10 I2F in SASS {i2f} (the f32 iota should convert "
          f"nothing, the int iota its row index)", flush=True)
    spread = _k11_spread()
    if spread:
        for k, r in spread["ratio"].items():
            us, mul = spread["us"][k], spread["us"]["torch.mul"]
            print(f"phase 26 K11 {k} / torch.mul on the device clock, "
                  f"{K11_ROUNDS} profiles of 20 calls in turns: "
                  f"{_spread_line(r)}; "
                  f"device us {', '.join(f'{x:.4f}' for x in us)}, "
                  f"torch.mul {', '.join(f'{x:.4f}' for x in mul)}",
                  flush=True)
    else:
        print("phase 26 K11 spread: not measured (the profiler saw no "
              "device time)", flush=True)
    host = _host_spread()
    for key, r in host["ratio"].items():
        yardstick = "torch.mul" if key.startswith("K11") else \
            "TF32 torch.matmul"
        print(f"phase 26 host {key} / {yardstick}, CUDA-event means of "
              f"{launch_floor.LAUNCHES} calls, {K11_ROUNDS} rounds in turns: "
              f"{_spread_line(r)}; us "
              f"{', '.join(f'{x:.4f}' for x in host['us'][key])}, yardstick "
              f"{', '.join(f'{x:.4f}' for x in host['library_us'][key])}",
              flush=True)
    split = _host_split()
    print("phase 26 host split of a K11 register-slice call (host clock, us "
          "a call, mean of 2000): " + ", ".join(
              f"{k} {v:.4f}" for k, v in split.items()), flush=True)
    for line in [v for key, m in mosaic_repros.REPROS.items()
                 for v in m.verdict([r for r in rows
                                     if r["kernel"] == f"K{key[1:]}"])]:
        print(f"phase 26 verdict: {line}", flush=True)
    names = {"K10": "K10 f32 iota vs int iota + cast (24, 256)",
             "K11": "K11 register slice vs ref load, (1, 512) x (64, 1), "
                    "W = 256; redesigned: its launch path",
             "K12": "K12 scalar min / max reduce driving a while loop, "
                    "(8, 128)",
             "K13": "K13 dynamic-cull probes A-D (every probe under rows)",
             "K14": "K14 (64, 3) x (3, 256) TF32 mma.sync, sub-slice vs "
                    "dense; redesigned: its launch path, fragments loaded "
                    "from global memory into registers"}
    entries = []
    for kernel, forms in by_kernel.items():
        first = forms[0]
        if kernel == "K11" and spread:
            first["device_ratio_to_library"] = spread["ratio"]
        if kernel in ("K11", "K14"):
            first["host_ratio_to_library"] = {
                f["name"]: host["ratio"][f"{kernel} {f['name']}"]
                for f in forms}
        entries.append(dict(
            name=f"{names[kernel]}; per launch, {first['name']} timings",
            route="cuda",
            source="raytracingweekend_tpu_torch/csrc/mosaic_repros.cu",
            replaces=first["replaces"],
            launches=sum(f["launches"] for f in forms),
            max_abs_err=max(f["max_abs_err"] for f in forms),
            ms=first["ms"], plain_ms=first["plain_ms"],
            bound_ms=first["bound_ms"], bound_by=first["bound_by"],
            library_ms=first["library_ms"], rows=forms,
            redesigned=kernel in ("K11", "K14")))
    return entries


def phase_tile_32768() -> dict:
    """The sixth repro: the port's trace_tiled at the T = 1 << 15 tile the
    TPU faults on (random_balls 1200x800, 16 spp, depth 8), against the
    same render at T = 1 << 16."""
    res = tile_32768.run("cuda")
    t, r = res["tile"], res["reference"]
    print(f"phase 26b tile T={t['T']} ({res['shape']}, 2^19 slots): "
          f"{t['seconds']:.3f} s, {t['iterations']} iterations, "
          f"{t['segments']} segments, K7 launches {res['k7_launches']}, "
          f"finite {t['finite']}, image mean {t['mean']:.6f}; T={r['T']}: "
          f"{r['seconds']:.3f} s, mean {r['mean']:.6f}; relative difference "
          f"{res['mean_rel_diff']:.3e} (limit {tile_32768.MEAN_RTOL})",
          flush=True)
    if not res["ok"]:
        fail("the T = 32768 tile did not finish with a finite image that "
             "agrees with T = 65536's")
    return res


def _timed(label: str, fn, *args, **kw):
    """fn(*args, **kw), then one line with the phase's seconds."""
    t0 = time.perf_counter()
    out = fn(*args, **kw)
    print(f"{label} took {time.perf_counter() - t0:.3f} s", flush=True)
    return out


def main() -> int:
    t_start = time.perf_counter()
    _timed("phase 1", phase_device)
    sweep, i2f = _timed("phase 2", phase_build)
    widths = _timed("phase 2b", phase_dense_widths)
    parity = _timed("phase 3", phase_exact_parity)
    _timed("phase 4", phase_goldens)
    main_run = _timed("phase 5", phase_main_path)
    cornell_run = _timed("phase 6", phase_cornell_path)
    texture_run = _timed("phase 8", phase_texture_path)
    large_run = _timed("phase 10", phase_large_path)
    vs_dense = _timed("phase 11", phase_culled_vs_dense)
    k1 = _timed("phase 5b", _kernel_vs_plain, "random_balls", NX, NY, SPP,
                "phase 5b")
    k23 = _timed("phase 7", lambda: [
        _kernel_vs_plain(name, CNX, CNY, CLAUNCH, "phase 7")
        for name in CORNELL_PATH])
    for name, run in zip(CORNELL_PATH, k23):
        _surface_split("phase 7", name, CNX, CNY, CLAUNCH, run)
    k4 = _timed("phase 9", lambda: [
        _kernel_vs_plain(name, TNX, TNY, TSPP, "phase 9",
                         tile_stride=PLAIN_TILE_STRIDE.get(name, 1), **kw)
        for name, kw in TEXTURE_PATH])
    for (name, kw), run in zip(TEXTURE_PATH, k4):
        if name in SPLIT_CELLS:
            _surface_split("phase 9", name, TNX, TNY, TSPP, run, **kw)
    print(f"phase 12 plain version of the culled kernel on every "
          f"{LARGE_TILE_STRIDE}th tile (N = {LARGE_TILE_STRIDE})", flush=True)
    k5 = _timed("phase 12", lambda: [
        _kernel_vs_plain(name, LNX, LNY, spp, "phase 12",
                         tile_stride=LARGE_TILE_STRIDE)
        for name, spp in LARGE_PATH])
    mixed_run = _timed("phase 21", phase_mixed_path)
    mixed_vs_dense = _timed("phase 22", phase_mixed_vs_dense)
    print(f"phase 23 plain version of the culled surfaces kernel on every "
          f"{LARGE_TILE_STRIDE}th tile (N = {LARGE_TILE_STRIDE})", flush=True)
    k5s = _timed("phase 23", lambda: [
        _kernel_vs_plain(f"large_mixed n={n}", LNX, LNY, spp, "phase 23",
                         tile_stride=LARGE_TILE_STRIDE,
                         scene=large_mixed(n, LNX / LNY))
        for n, spp in MIXED_PATH] + [
        _kernel_vs_plain("large_mixed n=60 untextured moving", MSMALL[0],
                         MSMALL[1], MSMALL[2], "phase 23",
                         tile_stride=LARGE_TILE_STRIDE,
                         scene=large_mixed(60, MSMALL[0] / MSMALL[1],
                                           textured=False, moving=True))])
    _timed("phase 13a", k7_build_report)
    k7_rows = _timed("phase 13", phase_k7_vs_plain)
    wave_run = _timed("phase 14", phase_wavefront_main)
    _timed("phase 15", phase_wavefront_paths)
    _timed("phase 16", phase_wavefront_goldens)
    k7_vjp = _timed("phase 17", phase_k7_vjp)
    mega_grad = _timed("phase 18", phase_mega_grad)
    _timed("phase 19", phase_mega_fit)
    wave_grad = _timed("phase 20", phase_wavefront_grad)
    twin = _timed("phase 24", phase_sweep_twin, sweep, main_run, k1)
    bench = _timed("phase 25", phase_microbench)
    repros = _timed("phase 26", phase_mosaic_repros, i2f)
    _timed("phase 26b", phase_tile_32768)
    entries = [
        dict(name="megakernel K1 (book-1 sphere path, random_balls; "
                  f"redesigned: {REDESIGN_DENSE})",
             source="raytracingweekend_tpu_torch/csrc/megakernel.cu",
             replaces="raytracingweekend_tpu/ops/megakernel.py:371",
             launches=main_run["launches"],
             max_abs_err=max(k1["max_abs_err"], parity["K1"],
                             widths["max_abs_err"]),
             ms=k1["ms"], plain_ms=k1["plain_ms"], bound_ms=k1["bound_ms"],
             redesigned=True),
        dict(name="megakernel K2+K3 (rects, lights + MIS, emission, media; "
                  f"cornell_box timings; redesigned: {REDESIGN_SURFACES})",
             source="raytracingweekend_tpu_torch/csrc/megakernel.cu",
             replaces="raytracingweekend_tpu/ops/megakernel.py:1022",
             launches=cornell_run["launches"],
             grad_path_launches=mega_grad["launches"],
             max_abs_err=max([parity["K2+K3"]]
                             + [r["max_abs_err"] for r in k23]),
             ms=k23[0]["ms"], plain_ms=k23[0]["plain_ms"],
             bound_ms=k23[0]["bound_ms"], redesigned=True),
        dict(name="megakernel K4 (checker, Perlin noise, image textures; "
                  "earth on earth.rtwi timings; redesigned: "
                  f"{REDESIGN_SURFACES})",
             source="raytracingweekend_tpu_torch/csrc/megakernel.cu",
             replaces="raytracingweekend_tpu/ops/megakernel.py:1410",
             launches=texture_run["launches"],
             max_abs_err=max([parity["K4"]]
                             + [r["max_abs_err"] for r in k4]),
             ms=k4[0]["ms"], plain_ms=k4[0]["plain_ms"],
             bound_ms=k4[0]["bound_ms"], redesigned=True),
        dict(name="megakernel K5 (cluster-culled sphere sweep, "
                  f"redesigned: {REDESIGN}; random_balls_large 1200x800x32 "
                  "timings, plain version on every "
                  f"{LARGE_TILE_STRIDE}th tile)",
             source="raytracingweekend_tpu_torch/csrc/megakernel.cu",
             replaces="raytracingweekend_tpu/ops/megakernel.py:753",
             launches=large_run["launches"],
             max_abs_err=max([parity["K5"], vs_dense["max_abs_err"]]
                             + [r["max_abs_err"] for r in k5]),
             ms=k5[0]["ms"], plain_ms=k5[0]["plain_ms"],
             bound_ms=k5[0]["bound_ms"], redesigned=True),
        dict(name="megakernel K5s (cluster-culled sweep ahead of rects, "
                  f"lights, media and textures, redesigned: {REDESIGN}; "
                  "large_mixed n=60 1200x800x32 timings, plain version on "
                  f"every {LARGE_TILE_STRIDE}th tile)",
             source="raytracingweekend_tpu_torch/csrc/megakernel.cu",
             replaces="raytracingweekend_tpu/ops/megakernel.py:2529",
             launches=mixed_run["launches"],
             max_abs_err=max([parity["K5s"], mixed_vs_dense["max_abs_err"]]
                             + [r["max_abs_err"] for r in k5s]),
             ms=k5s[0]["ms"], plain_ms=k5s[0]["plain_ms"],
             bound_ms=k5s[0]["bound_ms"], redesigned=True),
    ]
    for e in entries:
        e.update(route="cuda", bound_by="operations", library_ms=None)
    k7_main = k7_rows[0]
    entries.append(dict(
        name="K7 wavefront closest sphere hit (random_balls regen rays "
             f"N=524288, S={k7_main['S']} moving; per call; redesigned: "
             f"{REDESIGN_K7})",
        source="raytracingweekend_tpu_torch/csrc/intersect.cu",
        replaces="raytracingweekend_tpu/ops/pallas_intersect.py:139",
        launches=wave_run["launches"],
        grad_path_launches=wave_grad["launches"],
        max_abs_err=max([r["max_abs_err"] for r in k7_rows]
                        + [k7_vjp["max_abs_err"]]),
        ms=k7_main["ms"], plain_ms=k7_main["plain_ms"],
        bound_ms=k7_main["bound_ms"], route="cuda",
        bound_by=k7_main["bound_by"], library_ms=None, redesigned=True,
        rows=k7_rows))
    entries.append(dict(
        name=f"K8 sweep twin (the book-1 sweep alone, quad; S={twin['S']}, "
             f"T={twin['T']}, G={twin['G']}, K={twin['K']} a launch; ext "
             f"{twin['ext_ms']:.3f} ms; K1's redesigned slot loop)",
        source="raytracingweekend_tpu_torch/csrc/sweep_twin.cu",
        replaces="tools/sweep_twin.py:164",
        launches=twin["launches"], max_abs_err=twin["max_abs_err"],
        ms=twin["ms"], plain_ms=twin["plain_ms"], bound_ms=twin["bound_ms"],
        route="cuda", bound_by="operations", library_ms=None,
        redesigned=True))
    rep = next(r for r in bench["rows"] if r["name"] == "extract f32 default")
    entries.append(dict(
        name=f"K9 dot-formulation microbenchmark (extract f32 default on the "
             f"TF32 tensor cores, S={K9_S}, T={K9_T}, per step; every row "
             f"under rows; redesigned: {REDESIGN_K9})",
        source="raytracingweekend_tpu_torch/csrc/dot_microbench.cu",
        replaces="tools/dot_microbench.py:64",
        launches=bench["launches"],
        max_abs_err=max(r["max_abs_err"] for r in bench["rows"]),
        ms=rep["ms"], plain_ms=rep["plain_ms"], bound_ms=rep["bound_ms"],
        route="cuda", bound_by="operations", library_ms=rep["library_ms"],
        rows=bench["rows"], redesigned=True))
    entries += repros
    print(f"chip_smoke total {time.perf_counter() - t_start:.3f} s",
          flush=True)
    print(json.dumps({"kernels": entries}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
