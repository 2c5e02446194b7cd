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
yardsticks (torch.mul, TF32 torch.matmul) and of K10's, K12's and K13's
against the floor and K11's register slice in rounds of CUDA-event means,
where the host time of a K11, a K13 C and a K10 f32 iota call goes, K12
against its plain version on the NaN, infinity and signed-zero inputs and
on a grid-path input of 2^22 elements, and torch.aminmax's device time
beside K12's (the reduction alone); and
the sixth
repro, the port's tiled integrator at the T = 32768 tile the TPU faults on
(random_balls 1200x800, 16 spp, depth 8), against T = 65536. Last, the
checkpoint (book 1 through K1: 256 spp uninterrupted, then 128 with a
checkpoint resumed to 256 on the same file, equal bit for bit; the host
ms to write one 11,520,020-byte checkpoint), the texture input (earth at
800x600x64 through K4 with its texels read from a PNG that the port's
write_png made of earth.rtwi, equal to the .rtwi-fed render bit for bit)
and the utilities (denoise of the book-1 image, the nine Monte Carlo
studies, the float64 twin and render_f64, each on the card against the
same call on the CPU). Then the mesh path (raytracingweekend_tpu_torch/
parallel/, torch.distributed): at (1, 1) on NCCL in this process, book 1
through render_sharded_mega (K1) equal to trace_mega with the same seed
bit for bit and timed beside it, render_sharded (the lockstep wavefront,
K7) at 1200x800x8, the sharded value and gradient (K2+K3 and the replay)
at the gradient path's workload against render_diff_mega's, and the
single-card rate tools/scaling_report.py takes; four gloo ranks sharing
the card at (2, 2) (NCCL takes one card a rank), render_sharded_mega and
the sharded gradient held to their sequential emulations
(parallel/emulate.py) on the card, and dryrun_multichip(4); and the
gradient path's two timing tools (tools/grad_bench.py,
tools/inverse_render_bench.py) at their workloads, cut to one repeat and
four steps. The kernels line gives K1's, K2+K3's and K7's launches on
the mesh path (phase 30) beside their own paths'. Then the golden, A/B
and timing tools (raytracingweekend_tpu_torch/tools), each through its
run(): bench_all's seven scenes (2 warm-ups and 5 timed launches each);
mega_perf --stats on cornell_box 400x400x256 and random_balls_huge
1200x800x16; cull_sweep on random_balls_large 1200x800x32 over T in
{128, 256, 512} x near-to-far buckets {0, 16} at SB 128, on
random_balls_huge x16 and large_mixed n = 60 x32 over T in {128, 256} x
{0, 16}, and on book 1 1200x800x64 over T in {128, 256, 512} and SB 128
(C = 4), each list forward then backward, 5 timed launches a config;
dyn_ab_check on both stress scenes (every culled
variant equal to the dense sweep bit for bit); bvh_bench at 2^20 rays,
S = 512, 4096, 32768 (K7 and the BVH held to its agreement gate);
sampling_gallery at 200x200x64 into a temporary directory; and
mega_golden_check on the 32x32 and the 128x128 goldens. Phases 4 and 16
take tools/golden_report.py's check and gate. The kernels line gives
each kernel's launches on each tool's path (`tool_path_launches`).
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
import torch.distributed as tdist

from raytracingweekend_tpu_torch import grad as tgrad
from raytracingweekend_tpu_torch import montecarlo, native
from raytracingweekend_tpu_torch.models import (builder, probe_scenes,
                                                scene_types)
from raytracingweekend_tpu_torch.models.scenes import make_scene
from raytracingweekend_tpu_torch.ops import _build
from raytracingweekend_tpu_torch.ops import geometry
from raytracingweekend_tpu_torch.ops import intersect as k7
from raytracingweekend_tpu_torch.ops import mega_grad as mg
from raytracingweekend_tpu_torch.ops import megakernel as mk
from raytracingweekend_tpu_torch.ops.syncs import CHECK_EVERY, SYNCS
from raytracingweekend_tpu_torch.parallel import distributed as pdist
from raytracingweekend_tpu_torch.parallel import emulate as pemulate
from raytracingweekend_tpu_torch.parallel import mesh as pmesh
from raytracingweekend_tpu_torch.parallel.dryrun import dryrun_multichip
from raytracingweekend_tpu_torch.render import (RenderStats, render,
                                                resolve_mode)
from raytracingweekend_tpu_torch.tools import (bench_all, bvh_bench,
                                               coherence_sweep, cull_sweep,
                                               culled_ab, dyn_ab_check,
                                               export_texture_raw,
                                               golden_report,
                                               mega_golden_check, mega_perf,
                                               sampling_gallery)
from raytracingweekend_tpu_torch.tools import dot_microbench as k9
from raytracingweekend_tpu_torch.tools import (grad_bench,
                                               inverse_render_bench)
from raytracingweekend_tpu_torch.tools import mosaic_repros
from raytracingweekend_tpu_torch.tools import sass
from raytracingweekend_tpu_torch.tools import sweep_twin as k8
from raytracingweekend_tpu_torch.tools.mosaic_repros import (launch_floor,
                                                             tile_32768)
from raytracingweekend_tpu_torch.tools.mosaic_repros._common import launch_us
from raytracingweekend_tpu_torch.utils import denoise
from raytracingweekend_tpu_torch.utils import image as image_mod
from raytracingweekend_tpu_torch.utils import prng, validation
from raytracingweekend_tpu_torch.utils.config import RenderConfig

REPO = os.path.dirname(os.path.abspath(__file__))
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
# the goldens of phases 4 and 16, in tools/golden_report.py's tables:
# random_balls at 128x128 (several megakernel tiles), then the 32x32 set
# with cornell_box at both sizes
SMOKE_GOLDENS = (
    ("random_balls", golden_report.GOLDENS_MULTITILE["random_balls"]),
    ("dielectric", golden_report.GOLDENS["dielectric"]),
    ("cornell_box", golden_report.GOLDENS_MULTITILE["cornell_box"]),
    ("cornell_box", golden_report.GOLDENS["cornell_box"]),
    ("cornell_smoke", golden_report.GOLDENS["cornell_smoke"]),
    ("light_sample", golden_report.GOLDENS["light_sample"]),
    ("earth", golden_report.GOLDENS["earth"]),
    ("earth_rect", golden_report.GOLDENS["earth_rect"]))
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
    two kernels, over all their instantiations (float4 and single-float
    stores): {'f32 iota': [opcodes], 'int iota + cast': [opcodes]}."""
    tool = os.path.join(os.path.dirname(_build._nvcc()), "cuobjdump")
    text = subprocess.run([tool, "-sass", lib], capture_output=True,
                          text=True, check=True, timeout=120).stdout
    out = {}
    for func in re.split(r"\n\s*Function : ", text)[1:]:
        name = (sass.kernel_name(func.split(None, 1)[0]) or "").split("<")[0]
        form = {"repro:iota_f32": "f32 iota",
                "repro:iota_int_cast": "int iota + cast"}.get(name)
        if form:
            out[form] = sorted(out.get(form, []) + re.findall(
                r"\bI2FP?\b[.\w]*", func))
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
    # the dense forms, then the six culled surfaces forms and their six
    # plan-mode instantiations
    if spills or len(surf) != len(forms) + 12:
        fail(f"surfaces instantiations spill {spills} or are not all "
             f"listed ({len(surf)} of {len(forms)} + 12 culled)")
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


def phase_goldens() -> None:
    """The pixelwise criterion of tests/test_golden.py through render()."""
    _goldens("phase 4 golden", "mega", 64)


def _goldens(label: str, mode: str, launch_spp: int,
             max_spp: dict | None = None) -> None:
    """Every golden of SMOKE_GOLDENS through render() in `mode`, launches
    of launch_spp, at the golden's spp or at most max_spp[golden] (the
    tolerance takes the spp rendered): tools/golden_report.py's check."""
    for name, golden in SMOKE_GOLDENS:
        row = golden_report.check(name, golden, mode, launch_spp,
                                  (max_spp or {}).get(golden), device="cuda")
        print(golden_report.line(label, row), flush=True)
        if not row["passed"]:
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
                     scene=None, plan_kw=None, **kw) -> dict:
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
    replaces make_scene(name, keywords `kw`); `plan_kw`, when given, goes
    to make_plan (the plan modes)."""
    if scene is None:
        scene = make_scene(name, nx / ny, **kw)
    _, plan = mk.make_plan(scene, nx, ny, spp,
                           **{"max_depth": DEPTH, **(plan_kw or {})})
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
    # the public closure: the same tape (key) and replay; phase 30 holds
    # the sharded value and gradient to this one
    _, diff = mg.render_diff_mega(scene, key, GNX, GNY, GSPP,
                                  max_depth=GDEPTH, T=GT)

    def value_and_grad():
        loss = torch.mean(diff(_with(scene, "textures", color=col)) ** 2)
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
                launches=counts["K2+K3"], max_abs_err=err,
                loss=loss.detach(), grad=col.grad.detach().clone())


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
# argument, where it tells the formulation; K10's and K13's float4 and
# single-float instantiations go by the name) -> the formulation
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
    out, counts = {}, {}
    for ev in prof.key_averages():
        dev_us = _device_us(ev)
        m = re.search(r"repro_(\w+?)_kernel(?:<(\w+)>)?", ev.key)
        key = (MOSAIC_KERNELS.get(m.groups())
               or MOSAIC_KERNELS.get((m.group(1), None))) if m else None
        if key and dev_us > 0 and ev.count:
            out[key] = out.get(key, 0.0) + dev_us
            counts[key] = counts.get(key, 0) + ev.count
    return {k: v / counts[k] for k, v in out.items()}


def _library_device_us(launches: int = 20) -> dict:
    """Device µs a call of the library yardsticks of K11 and K14 on their
    repros' inputs, and of torch.aminmax on K12's (the reduction alone: no
    loop, no stores; not K12's function), as `_mosaic_device_us` takes the
    kernels': each call alone under torch.profiler, `launches` times
    (K14's with TF32 allowed once around them all, `k14.tf32`), all its
    device time over the count ({kernel: µs}; a session that recorded no
    device time is taken again, at most three times, and the kernel is
    missing if none did)."""
    from torch.profiler import ProfilerActivity, profile
    from raytracingweekend_tpu_torch.tools.mosaic_repros import (
        repro_dot_k3_subslice as k14, repro_scalar_reduce as k12,
        repro_slice_broadcast_layout as k11)
    row, col = k11.inputs(0, "cuda")
    tab, rays = k14.inputs(0, "cuda")
    x12 = k12.repro_input("cuda")
    out = {}
    for key, fn, under in (("K11", lambda: torch.mul(row, col),
                            contextlib.nullcontext),
                           ("K14", k14.library(tab, rays), k14.tf32),
                           ("K12 aminmax", lambda: torch.aminmax(x12),
                            contextlib.nullcontext)):
        for _ in range(3):
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
                break
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
    its yardstick; the ratio of each form to its yardstick a round. In the
    same rounds, K10's, K12's and K13's forms through their kernel
    wrappers (on the repros' inputs), the empty kernel (the floor) and
    K11's register slice through its kernel wrapper: `floor_ratio` and
    `k11_ratio`, a form's µs over the floor's and over K11's in its
    round."""
    from raytracingweekend_tpu_torch.tools.mosaic_repros import (
        repro_dot_k3_subslice as k14, repro_dynamic_cull as k13,
        repro_f32_iota as k10, repro_scalar_reduce as k12,
        repro_slice_broadcast_layout as k11)
    row, col = k11.inputs(0, "cuda")
    tab, rays = k14.inputs(0, "cuda")
    x12 = k12.repro_input("cuda")
    lhs = tab[:, 0:k14.K].contiguous()
    mul, matmul = (lambda: torch.mul(row, col)), k14.library(tab, rays)
    forms = {"K11 register slice": (lambda: k11.reg_slice(row, col), mul,
                                    contextlib.nullcontext),
             "K11 ref load": (lambda: k11.ref_load(row, col), mul,
                              contextlib.nullcontext),
             "K14 subslice": (lambda: k14.subslice(tab, rays), matmul,
                              k14.tf32),
             "K14 dense": (lambda: k14.dense(lhs, rays), matmul, k14.tf32)}
    a13 = k13.inputs(k13.SCALARS, "cuda")
    dev = row.get_device()
    others = {"floor": lambda: launch_floor.empty_kernel(dev),
              "K11 register slice kernel": lambda: k11.reg_slice_kernel(
                  row, col),
              "K10 f32 iota": lambda: k10.f32_iota_kernel(
                  k10.ROWS, k10.T, "cuda"),
              "K10 int iota + cast": lambda: k10.int_iota_cast_kernel(
                  k10.ROWS, k10.T, "cuda"),
              "K12 scalar reduce": lambda: k12.scalar_reduce_kernel(x12)}
    for k, name in enumerate(k13.FORMS):
        kern, _, table = k13.PROBES[k]
        others[f"K13 {name}"] = (
            (lambda kern=kern, t=a13[table]: kern(t)) if k == 3 else
            (lambda kern=kern, t=a13[table]: kern(a13["s"], t)))
    us = {k: [] for k in forms}
    lib = {k: [] for k in forms}
    other_us = {k: [] for k in others}
    for _ in range(rounds):
        for key, (fn, yardstick, under) in forms.items():
            us[key].append(launch_us(fn, "cuda", launches))
            with under():
                lib[key].append(launch_us(yardstick, "cuda", launches))
        for key, fn in others.items():
            other_us[key].append(launch_us(fn, "cuda", launches))
    floor, k11_us = other_us["floor"], other_us["K11 register slice kernel"]
    redesigned = [k for k in others if k.startswith(("K10", "K12", "K13"))]
    return dict(us=us, library_us=lib,
                ratio={k: [a / b for a, b in zip(us[k], lib[k])]
                       for k in forms},
                other_us=other_us,
                floor_ratio={k: [a / b for a, b in zip(other_us[k], floor)]
                             for k in redesigned},
                k11_ratio={k: [a / b for a, b in zip(other_us[k], k11_us)]
                           for k in redesigned})


def _k12_edge_inputs() -> dict:
    """K12 against its plain version on F6's and F8's edge inputs at the
    repro's shape (NaN, infinities, signed zeros:
    `repro_scalar_reduce.EDGE_CASES`) and on one grid-path input of 2^22
    elements (16 MB of normals around -3, numpy seed 0): rows 0..2, NaN by
    position, every other element bit for bit (`rows_equal`). These
    launches are not the path's. Prints the count that match and fails
    unless all do; returns {"matching": n, "of": inputs}."""
    from raytracingweekend_tpu_torch.tools.mosaic_repros import (
        repro_scalar_reduce as k12)
    inputs = {case: k12.edge_input(case, device="cuda")
              for case in k12.EDGE_CASES}
    rng = np.random.default_rng(0)
    inputs["grid (8, 2^19) normals"] = torch.from_numpy(
        (rng.standard_normal((8, 1 << 19)) * 40.0 - 3.0).astype(
            np.float32)).cuda()
    match = {name: k12.rows_equal(k12.scalar_reduce_kernel(x),
                                  k12.scalar_reduce_reference(x))
             for name, x in inputs.items()}
    n = sum(match.values())
    print(f"phase 26 K12 edge inputs (rows 0..2 against the plain version, "
          f"NaN by position, zeros by sign bit): {n} of {len(match)} match; "
          + ", ".join(f"{k} {v}" for k, v in match.items()), flush=True)
    if n != len(match):
        fail("K12 disagrees with its plain version on "
             f"{[k for k, v in match.items() if not v]}")
    return {"matching": n, "of": len(match)}


def _split_us(parts: dict, n: int) -> dict:
    """µs a call of each part on the host clock, the mean of n calls in a
    row after two warm-ups, the device synchronised after."""
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
    return us


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
    us = _split_us(parts, n)
    us["rest of the wrapper"] = (us["wrapper"] - us["new_empty"]
                                 - us["launcher"])
    return us


def _host_split_k10_k13(n: int = 2000) -> dict:
    """Where the host time of a K13 C call and of a K10 f32 iota call goes
    (as `_host_split` takes a K11 call's): the whole wrapper, its output's
    allocation (`new_empty`), the launcher with the output made, K10's
    device resolution (a hit in its cache), and the rest of the wrapper
    (the one combined check, pointers, calls)."""
    from raytracingweekend_tpu_torch.tools.mosaic_repros import (
        repro_dynamic_cull as k13, repro_f32_iota as k10)
    a = k13.inputs(k13.SCALARS, "cuda")
    s_, tab = a["s"], a["tab"]
    dev, shape = tab.get_device(), (8, tab.shape[1])
    out = tab.new_empty(shape)
    args13 = (2, s_.data_ptr(), tab.data_ptr(), out.data_ptr(), *tab.shape)
    key13 = "K13 " + k13.FORMS[2]
    empty, index = k10._target("cuda")
    shape10 = (k10.ROWS, k10.T)
    out10 = empty.new_empty(shape10)
    args10 = (0, out10.data_ptr(), *shape10)
    split = {}
    for name, parts in (
            (key13, {"wrapper": lambda: k13.fori_smem_kernel(s_, tab),
                     "new_empty": lambda: tab.new_empty(shape),
                     "launcher": lambda: k13._CULL.launch(key13, dev,
                                                          *args13)}),
            ("K10 f32 iota", {
                "wrapper": lambda: k10.f32_iota_kernel(*shape10, "cuda"),
                "new_empty": lambda: empty.new_empty(shape10),
                "device resolution": lambda: k10._target("cuda"),
                "launcher": lambda: k10._IOTA.launch("K10 f32 iota", index,
                                                     *args10)})):
        us = _split_us(parts, n)
        us["rest of the wrapper"] = (us["wrapper"] - us["new_empty"]
                                     - us["launcher"])
        split[name] = us
    return split


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
    and K13's probes to the repro's expected arrays, and K12 on its edge
    inputs (`_k12_edge_inputs`). Returns the kernels line's K10-K14
    entries."""
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
    edge = _k12_edge_inputs()
    amm = lib_device_us.get("K12 aminmax")
    print(f"phase 26 K12 torch.aminmax on the repro's x (the reduction "
          f"alone: no loop, no stores): device "
          f"{'not measured' if amm is None else f'{amm:.4f} us'}",
          flush=True)
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
    print(f"phase 26 host floor {_spread_line(host['other_us']['floor'])} "
          f"us, K11 register slice kernel "
          f"{_spread_line(host['other_us']['K11 register slice kernel'])} us "
          f"(CUDA-event means of {launch_floor.LAUNCHES} calls, the rounds "
          "of the lines above and below)", flush=True)
    for key, r in host["k11_ratio"].items():
        print(f"phase 26 host {key} (kernel wrapper) / K11 register slice "
              f"kernel, {K11_ROUNDS} rounds in turns: {_spread_line(r)}; / "
              f"floor {_spread_line(host['floor_ratio'][key])}; us "
              f"{', '.join(f'{x:.4f}' for x in host['other_us'][key])}",
              flush=True)
    split = _host_split()
    print("phase 26 host split of a K11 register-slice call (host clock, us "
          "a call, mean of 2000): " + ", ".join(
              f"{k} {v:.4f}" for k, v in split.items()), flush=True)
    for key, parts in _host_split_k10_k13().items():
        print(f"phase 26 host split of a {key} call (host clock, us a "
              "call, mean of 2000): " + ", ".join(
                  f"{k} {v:.4f}" for k, v in parts.items()), flush=True)
    for line in [v for key, m in mosaic_repros.REPROS.items()
                 for v in m.verdict([r for r in rows
                                     if r["kernel"] == f"K{key[1:]}"])]:
        print(f"phase 26 verdict: {line}", flush=True)
    names = {"K10": "K10 f32 iota vs int iota + cast (24, 256); "
                    "redesigned: its launch path, a grid of column blocks "
                    "and row runs storing float4s, 64-bit indices",
             "K11": "K11 register slice vs ref load, (1, 512) x (64, 1), "
                    "W = 256; redesigned: its launch path",
             "K12": "K12 scalar min / max reduce driving a while loop, "
                    "(8, 128); redesigned: one warp's wave of float4 "
                    "loads, NaN-propagating min / max, a butterfly, the "
                    "pair through a shared scratch, the trip count in "
                    "closed form, float4 stores; past 8192 elements a grid "
                    "whose last block (an atomic ticket) combines",
             "K13": "K13 dynamic-cull probes A-D (every probe under "
                    "rows); redesigned: its launch path, A-C a float4 of "
                    "the output a thread, one wave of loads, wrapped int32 "
                    "starts",
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
        if kernel == "K12":
            first["edge_inputs_matching"] = edge
            first["aminmax_device_ms"] = (
                None if "K12 aminmax" not in lib_device_us
                else lib_device_us["K12 aminmax"] * 1e-3)
        if kernel in ("K10", "K12", "K13"):
            for ratio in ("k11_ratio", "floor_ratio"):
                first[f"host_{ratio}"] = {
                    f["name"]: host[ratio][f"{kernel} {f['name']}"]
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
            redesigned=True))
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


# the checkpoint phase: book 1 (random_balls 1200x800, 64 spp a launch,
# depth 50, K1) rendered to CK_SPP uninterrupted, then to CK_SPP / 2 with
# a checkpoint and resumed to CK_SPP on the same file; CK_WRITES timed
# host writes of one checkpoint
CK_SPP, CK_WRITES = 256, 5
CK_BYTES = 20 + NX * NY * 3 * 4
# the utilities phase: the float64 twin's scene and shape (tests/test_f64.py)
F64_TWIN = ("dielectric", 16, 16, 4, 6, 256)
F64_WAVE = ("dielectric", 12, 12, 4, 6)
MC_N = 1_000_000
DENOISE_ATOL = 1e-5
MC_RTOL = 1e-6
TWIN_RTOL = 1e-9
F64_WAVE_RTOL = 1e-4


def _bits_equal(a: torch.Tensor, b: torch.Tensor) -> bool:
    return (a.shape == b.shape and a.dtype == b.dtype
            and torch.equal(a.contiguous().view(torch.int32),
                            b.contiguous().view(torch.int32)))


def _rel(a, b) -> float:
    a = np.asarray(a, np.float64)
    b = np.asarray(b, np.float64)
    return float((np.abs(a - b) / np.maximum(np.abs(a), 1e-3)).max())


def phase_checkpoint() -> dict:
    """Checkpoint and resume on the book-1 path: the resumed canvas and
    checkpoint equal the uninterrupted ones bit for bit, the header reads
    1200, 800, CK_SPP; the host time to write one checkpoint."""
    scene = make_scene("random_balls", NX / NY)
    base = dict(nx=NX, ny=NY, max_depth=DEPTH, samples_per_launch=SPP,
                loop_mode="mega", device="cuda", seed=SEED)
    _reset_counts()
    t0 = time.perf_counter()
    full = render(scene, RenderConfig(spp=CK_SPP, **base))
    torch.cuda.synchronize()
    s_full = time.perf_counter() - t0
    with tempfile.TemporaryDirectory() as tmp:
        whole = os.path.join(tmp, "whole.rtwf")
        t0 = time.perf_counter()
        render(scene, RenderConfig(spp=CK_SPP, checkpoint=whole, **base))
        s_ck = time.perf_counter() - t0
        part = os.path.join(tmp, "part.rtwf")
        render(scene, RenderConfig(spp=CK_SPP // 2, checkpoint=part, **base))
        _, half = native.load_checkpoint(part)
        resumed = render(scene, RenderConfig(spp=CK_SPP, checkpoint=part,
                                             **base))
        launches = _launch_counts()["K1"]
        with open(part, "rb") as f:
            magic, w, h, spp = native.FB_HEADER.unpack(f.read(20))
        size = os.path.getsize(part)
        with open(part, "rb") as f1, open(whole, "rb") as f2:
            same_file = f1.read() == f2.read()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        host = full.cpu().numpy() * CK_SPP
        copy_ms = (time.perf_counter() - t0) * 1e3
        write_ms = []
        for _ in range(CK_WRITES):
            t0 = time.perf_counter()
            native.save_checkpoint(os.path.join(tmp, "timed.rtwf"), host,
                                   CK_SPP)
            write_ms.append((time.perf_counter() - t0) * 1e3)
    same = _bits_equal(full, resumed)
    print(f"phase 27 checkpoint (random_balls {NX}x{NY}, {SPP} spp/launch, "
          f"depth {DEPTH}, K1): {CK_SPP} spp uninterrupted "
          f"{s_full:.6f} s, with a checkpoint each launch {s_ck:.6f} s; "
          f"{CK_SPP // 2} spp checkpointed (file spp {half}) then resumed "
          f"to {CK_SPP}: canvas equal bit for bit {same}, checkpoint file "
          f"equal to the uninterrupted render's {same_file}; header magic "
          f"{magic:#x} w {w} h {h} spp {spp}, {size} bytes; K1 launches "
          f"{launches}", flush=True)
    print(f"phase 27 checkpoint write ({size} bytes, host, warm page "
          f"cache): {' '.join(f'{m:.3f}' for m in write_ms)} ms, median "
          f"{sorted(write_ms)[len(write_ms) // 2]:.3f} ms; device-to-host "
          f"copy of the canvas {copy_ms:.3f} ms; {DEVICE_LINE}", flush=True)
    if not (same and same_file):
        fail("the resumed book-1 render differs from the uninterrupted one")
    if (magic, w, h, spp, size, half) != (native.FB_MAGIC, NX, NY, CK_SPP,
                                          CK_BYTES, CK_SPP // 2):
        fail("the checkpoint's header or size is wrong")
    if launches < 1:
        fail("the checkpoint phase launched no K1 kernel")
    img = full.cpu().numpy()
    if img.shape != (NY, NX, 3) or not np.isfinite(img).all():
        fail("the checkpointed book-1 image is not finite")
    return dict(canvas=full, write_ms=sorted(write_ms)[len(write_ms) // 2],
                launches=launches)


def phase_texture_input() -> dict:
    """The earth scene at 800x600x64 (K4) with its texels read from a PNG
    that the port's write_png made of earth.rtwi: the image equals the
    .rtwi-fed render bit for bit."""
    texels = image_mod.load_image(RTWI)
    cfg = RenderConfig(nx=TNX, ny=TNY, spp=TSPP, samples_per_launch=TSPP,
                       max_depth=TDEPTH, loop_mode="mega", device="cuda",
                       seed=SEED)
    with tempfile.TemporaryDirectory() as tmp:
        png = os.path.join(tmp, "earth.png")
        image_mod.write_png(texels, png)
        from_png = make_scene("earth", TNX / TNY, image_path=png)
    from_rtwi = make_scene("earth", TNX / TNY, image_path=RTWI)
    same_texels = np.array_equal(from_png.textures.images,
                                 from_rtwi.textures.images)
    _reset_counts()
    a = render(from_png, cfg)
    launches = _launch_counts()["K4"]
    b = render(from_rtwi, cfg)
    same = _bits_equal(a, b)
    reader = ("the native library" if native.available() else
              "Python; the native library did not build: "
              + (native.build_error.splitlines() or ["?"])[-1])
    print(f"phase 28 texture input (earth {TNX}x{TNY}, {TSPP} spp, depth "
          f"{TDEPTH}, K4; PNG read by "
          f"{reader}): "
          f"texels equal {same_texels}, image equal to the .rtwi-fed "
          f"render bit for bit {same}, K4 launches {launches}, mean "
          f"{float(a.mean()):.6f}", flush=True)
    if not (same_texels and same):
        fail("the PNG-fed earth render differs from the .rtwi-fed one")
    if launches < 1:
        fail("the texture-input phase launched no K4 kernel")
    return dict(launches=launches)


def phase_utilities(book1: torch.Tensor) -> dict:
    """Denoise of the book-1 image, the Monte Carlo studies and the float64
    modes, each on the card against the same call on the CPU."""
    disp = torch.from_numpy(image_mod.postprocess(
        book1.cpu().numpy()).astype(np.float32))

    def run(x):
        x = denoise.firefly_clamp(denoise.firefly_clamp(x, 1.5, 0.02),
                                  1.5, 0.02)
        return denoise.atrous_denoise(x, 4, 0.35)

    gpu = disp.cuda()
    run(gpu)
    card_ms, card = _event_ms(lambda: run(gpu), 3)
    t0 = time.perf_counter()
    cpu = run(disp)
    cpu_ms = (time.perf_counter() - t0) * 1e3
    d_err = float((card.cpu() - cpu).abs().max())
    print(f"phase 29 denoise (book 1 {NX}x{NY}, two firefly passes + 4 "
          f"a-trous iterations): card {card_ms:.3f} ms, CPU {cpu_ms:.3f} ms, "
          f"max abs card - CPU {d_err:.3e} (limit {DENOISE_ATOL})",
          flush=True)
    keys = prng.split(prng.key(0), 9)
    studies = (("estimate_pi", {"n": MC_N}),
               ("estimate_pi_stratified", {"sqrt_n": 1000}),
               ("integrate_x_squared_uniform", {"n": MC_N}),
               ("integrate_x_squared_linear_pdf", {"n": MC_N}),
               ("integrate_x_squared_quadratic_pdf", {"n": MC_N}),
               ("integrate_cos_squared_sphere", {"n": MC_N}),
               ("integrate_cos_cubed_uniform_hemisphere", {"n": MC_N}),
               ("integrate_cos_cubed_cosine_pdf", {"n": MC_N}),
               ("estimate_pi_forever", {"chunk": 100_000, "steps": 10}))
    mc_err = 0.0
    for (name, kw), key in zip(studies, keys):
        fn = getattr(montecarlo, name)
        on_card, on_cpu = fn(key, device="cuda", **kw), fn(key, device="cpu",
                                                          **kw)
        a = on_card[0] if name == "estimate_pi_forever" else on_card[:-1]
        b = on_cpu[0] if name == "estimate_pi_forever" else on_cpu[:-1]
        err = _rel(b, a)
        mc_err = max(mc_err, err)
        print(f"phase 29 montecarlo.{name}: card {np.round(a, 7).tolist()} "
              f"CPU {np.round(b, 7).tolist()} rel {err:.3e}", flush=True)
    name, nx, ny, spp, depth, T = F64_TWIN
    scene = make_scene(name, 1.0)
    ctx = mg.plan_tape(scene, nx, ny, spp, max_depth=depth, T=T)
    _, tape, seed = mg.tape_forward(prng.key(5), ctx)
    twin_card = mg.make_replay(dict(ctx, f64=True))(scene, tape, seed)
    f32_card = mg.make_replay(ctx)(scene, tape, seed)
    cctx = mg.plan_tape(scene, nx, ny, spp, max_depth=depth, T=T,
                        device="cpu")
    twin_cpu = mg.make_replay(dict(cctx, f64=True))(scene, tape.cpu(),
                                                   seed.cpu())
    twin_err = _rel(twin_cpu.numpy(), twin_card.cpu().numpy())
    twin_f32 = _rel(twin_card.cpu().numpy(), f32_card.cpu().numpy())
    wname, wnx, wny, wspp, wdepth = F64_WAVE
    wscene = make_scene(wname, 1.0)
    w_card = validation.render_f64(wscene, prng.key(3), wnx, wny, wspp,
                                   wdepth)
    w_cpu = validation.render_f64(wscene, prng.key(3), wnx, wny, wspp,
                                  wdepth, device="cpu")
    w_err = _rel(w_cpu.numpy(), w_card.cpu().numpy())
    print(f"phase 29 float64 twin ({name} {nx}x{ny}x{spp}, depth {depth}, "
          f"T = {T}, the card's tape): {twin_card.dtype}, card vs CPU rel "
          f"{twin_err:.3e} (limit {TWIN_RTOL}), vs the float32 replay "
          f"{twin_f32:.3e}; render_f64 ({wname} {wnx}x{wny}x{wspp}, depth "
          f"{wdepth}): {w_card.dtype}, card vs CPU rel {w_err:.3e} (limit "
          f"{F64_WAVE_RTOL})", flush=True)
    if d_err > DENOISE_ATOL or not torch.isfinite(card).all():
        fail("denoise on the card differs from the CPU's")
    if mc_err > MC_RTOL:
        fail("a Monte Carlo study on the card differs from the CPU's")
    if (twin_card.dtype != torch.float64 or twin_err > TWIN_RTOL
            or twin_f32 > 5e-4):
        fail("the float64 twin on the card differs from the CPU's")
    if w_card.dtype != torch.float64 or w_err > F64_WAVE_RTOL:
        fail("render_f64 on the card differs from the CPU's")
    return dict(denoise_ms=card_ms, denoise_cpu_ms=cpu_ms)


# the mesh path (raytracingweekend_tpu_torch/parallel/): phase 30 on NCCL
# at (1, 1): book 1 through render_sharded_mega against trace_mega,
# MESH_TURNS rounds of (trace_mega, sharded, sharded, trace_mega) on the
# host clock; render_sharded (the wavefront, K7) at 1200x800x8 against the
# megakernel's mean; the sharded value and gradient at the gradient path's
# workload against render_diff_mega's. Phase 31: four gloo ranks on the
# one card at (2, 2), at the CPU tests' sizes (tests/_torch_parallel_ranks.py)
MESH_TURNS = 2
MESH_KEY = 7
MESH_MEGA = ("dielectric", 16, 16, 8, 5, 128, 5)
MESH_GRAD = ("cornell_box", 12, 12, 4, 3, 128, 0)
MESH_WORLD = 4
MESH_TIMEOUT = 300.0
MESH_LOSS_RTOL = 1e-5    # phase 30: the same replay, sums in other orders
MESH_GRAD_RTOL, MESH_GRAD_ATOL = 1e-4, 1e-7


def _set_colors(scene, p):
    return _with(scene, "textures", color=p)


def phase_mesh_nccl(ref_grad: dict) -> dict:
    """The mesh path at (1, 1) on NCCL (one rank, this process): book 1
    through render_sharded_mega equal to trace_mega with the same seed bit
    for bit, both timed in turns; render_sharded at 1200x800x8, depth 50,
    its mean within 2% of the sharded megakernel's; the sharded value and
    gradient (make_sharded_value_and_grad) at the gradient path's workload
    against render_diff_mega's loss and gradient (phase 18's `ref_grad`,
    the same key, target 0, loss mean(img^2)). Each path's launch
    counts are set to 0 just before it and read just after; the single-
    card rate (samples/s of the sharded book-1 launch) is what
    tools/scaling_report.py takes as --rate."""
    tmp = tempfile.mkdtemp(prefix="rtw_nccl_")
    pdist.initialize("file://" + os.path.join(tmp, "store"), 1, 0,
                     device="cuda")
    try:
        mesh = pmesh.make_mesh(1, 1, device="cuda")
        backend = tdist.get_backend()
        scene = make_scene("random_balls", NX / NY)
        key = prng.key(MESH_KEY)
        seed = pmesh.shard_seed(key, 0, 0)

        def trace():
            return mk.trace_mega(seed, scene, NX, NY, SPP,
                                 max_depth=DEPTH).image / SPP

        def sharded():
            return pmesh.render_sharded_mega(scene, mesh, key, NX, NY, SPP,
                                             max_depth=DEPTH)

        ref = trace()
        _reset_counts()
        img = sharded()
        torch.cuda.synchronize()
        k1 = _launch_counts()["K1"]
        equal = _bits_equal(img, ref)
        t_trace, t_sharded = [], []
        for _ in range(MESH_TURNS):
            for fn, acc in ((trace, t_trace), (sharded, t_sharded),
                            (sharded, t_sharded), (trace, t_trace)):
                acc.append(_host_ms(fn)[0])
        ms_trace, ms_sharded = np.median(t_trace), np.median(t_sharded)
        rate = NX * NY * SPP / (ms_sharded / 1e3)
        print(f"phase 30 render_sharded_mega ({backend}, mesh (1, 1); "
              f"random_balls {NX}x{NY}, {SPP} spp, depth {DEPTH}; "
              f"one all-reduce of {NX * NY} lanes x 16 B): equal to trace_mega bit for bit: "
              f"{equal}; K1 launches {k1}; host ms a launch (median of "
              f"{len(t_sharded)}, in turns) sharded {ms_sharded:.4f} "
              f"[{', '.join(f'{v:.4f}' for v in t_sharded)}] vs trace_mega "
              f"{ms_trace:.4f} [{', '.join(f'{v:.4f}' for v in t_trace)}] "
              f"= {ms_sharded / ms_trace:.4f}x", flush=True)
        print(f"phase 30 single-card rate {rate:.6e} samples/s (the sharded "
              f"book-1 launch; tools/scaling_report.py --rate)", flush=True)
        if not equal:
            fail("render_sharded_mega at (1, 1) differs from trace_mega")
        if k1 < 1:
            fail("render_sharded_mega launched no K1 kernel")

        _reset_counts()
        torch.cuda.reset_peak_memory_stats()
        w_ms, wave = _host_ms(lambda: pmesh.render_sharded(
            scene, mesh, prng.key(MESH_KEY + 1), WNX, WNY, WSPP,
            max_depth=WDEPTH))
        k7_launches = _launch_counts()["K7"]
        w_mem = torch.cuda.max_memory_allocated()
        rel = abs(wave.mean().item() - img.mean().item()) / img.mean().item()
        print(f"phase 30 render_sharded (lockstep wavefront, while; "
              f"random_balls {WNX}x{WNY}, {WSPP} spp, depth {WDEPTH}): "
              f"{w_ms:.1f} ms, peak {w_mem / 2**30:.3f} GiB, K7 launches "
              f"{k7_launches}; mean {wave.mean().item():.6f} vs the sharded "
              f"megakernel's {img.mean().item():.6f} (rel {rel:.5f} < 0.02)",
              flush=True)
        if k7_launches < 1:
            fail("render_sharded launched no K7 kernel")
        if (not torch.isfinite(wave).all() or wave.shape != (WNY, WNX, 3)
                or rel >= 0.02):
            fail("render_sharded's image is wrong")

        gscene = make_scene("cornell_box", GNX / GNY)
        gkey = prng.key(3)
        vg, _ = mg.make_sharded_value_and_grad(
            gscene, mesh, np.zeros((GNY, GNX, 3), np.float32), nx=GNX,
            ny=GNY, spp=GSPP, max_depth=GDEPTH, T=GT, set_params=_set_colors)
        _reset_counts()
        vg_ms, (loss, g) = _host_ms(lambda: vg(gscene.textures.color,
                                               mg.tape_seed(gkey, "cpu")))
        k23 = _launch_counts()["K2+K3"]
        ref_ms, ref_loss, ref_g = (ref_grad["vg_ms"], ref_grad["loss"],
                                   ref_grad["grad"])
        l_err = abs(loss.item() - ref_loss.item()) / abs(ref_loss.item())
        g_ok = torch.allclose(g, ref_g, rtol=MESH_GRAD_RTOL,
                              atol=MESH_GRAD_ATOL)
        g_err = (g - ref_g).abs().max().item()
        print(f"phase 30 sharded value and gradient (cornell_box {GNX}x{GNY}"
              f", {GSPP} spp, depth {GDEPTH}, T={GT}, w.r.t. textures.color; "
              f"target 0): {vg_ms:.1f} ms (render_diff_mega's value and "
              f"gradient, phase 18: {ref_ms:.1f} ms), K2+K3 launches {k23}; "
              f"loss "
              f"{loss.item():.8e} vs {ref_loss.item():.8e} (rel {l_err:.3e}"
              f" < {MESH_LOSS_RTOL}), gradient max abs diff {g_err:.3e} "
              f"(rtol {MESH_GRAD_RTOL}, atol {MESH_GRAD_ATOL}): "
              f"{'ok' if g_ok and l_err < MESH_LOSS_RTOL else 'FAIL'}",
              flush=True)
        if k23 < 1:
            fail("the sharded gradient launched no megakernel")
        if not g_ok or l_err >= MESH_LOSS_RTOL:
            fail("the sharded value and gradient differ from "
                 "render_diff_mega's")
    finally:
        tdist.destroy_process_group()
    return dict(k1=k1, k7=k7_launches, k23=k23, ms_sharded=ms_sharded,
                ms_trace=ms_trace, rate=rate)


def _mesh_rank() -> dict:
    """Phase 31's work in each spawned rank (gloo, this card) at (2, 2):
    MESH_MEGA through render_sharded_mega and MESH_GRAD's sharded value
    and gradient, with the rank's launch counts."""
    mesh = pmesh.make_mesh(2, 2, device="cuda")
    _reset_counts()
    name, nx, ny, spp, depth, T, k = MESH_MEGA
    tile = pmesh.render_sharded_mega(make_scene(name, 1.0), mesh,
                                     prng.key(k), nx, ny, spp,
                                     max_depth=depth, T=T)
    name, nx, ny, spp, depth, T, k = MESH_GRAD
    scene = make_scene(name, 1.0)
    vg, _ = mg.make_sharded_value_and_grad(
        scene, mesh, np.zeros((ny, nx, 3), np.float32), nx=nx, ny=ny,
        spp=spp, max_depth=depth, T=T, set_params=_set_colors)
    loss, g = vg(scene.textures.color, mg.tape_seed(prng.key(k), "cpu"))
    return dict(coord=tuple(int(c) for c in mesh.get_coordinate()),
                tile=tile.cpu().numpy(), loss=float(loss),
                g=g.cpu().numpy(), launches=_launch_counts())


def phase_mesh_gloo() -> dict:
    """Four gloo ranks on this card at (2, 2) (NCCL takes one card a
    rank): render_sharded_mega equal to its sequential emulation bit for
    bit, the sharded gradient to its emulation (loss rtol 1e-6, gradient
    rtol 1e-5 / atol 1e-8), both emulations on the card in this process;
    then dryrun_multichip(4) on gloo ranks of the card."""
    t0 = time.perf_counter()
    res = pdist.spawn(_mesh_rank, MESH_WORLD, device="cuda", backend="gloo",
                      timeout=MESH_TIMEOUT)
    spawn_s = time.perf_counter() - t0
    tiles = {r["coord"][0]: r["tile"] for r in res}
    canvas = np.concatenate([tiles[0], tiles[1]])
    mega_name, nx, ny, spp, depth, T, k = MESH_MEGA
    mega_cell = f"{mega_name} {nx}x{ny}x{spp}"
    emu = pemulate.render_sharded_mega(make_scene(mega_name, 1.0), 2, 2,
                                       prng.key(k), nx, ny, spp,
                                       max_depth=depth, T=T,
                                       device="cuda").cpu().numpy()
    mega_equal = (canvas.shape == emu.shape
                  and bool(np.array_equal(canvas.view(np.int32),
                                          emu.view(np.int32)))
                  and all(np.array_equal(r["tile"], tiles[r["coord"][0]])
                          for r in res))
    name, nx, ny, spp, depth, T, k = MESH_GRAD
    scene = make_scene(name, 1.0)
    e_loss, e_g, _ = pemulate.value_and_grad(
        scene, np.zeros((ny, nx, 3), np.float32), 2, 2, scene.textures.color,
        mg.tape_seed(prng.key(k), "cpu"), nx=nx, ny=ny, spp=spp,
        max_depth=depth, T=T, set_params=_set_colors, device="cuda")
    l_err = abs(res[0]["loss"] - e_loss.item()) / abs(e_loss.item())
    g_ok = all(np.allclose(r["g"], e_g.cpu().numpy(), rtol=1e-5, atol=1e-8)
               for r in res)
    launches = {n: sum(r["launches"][n] for r in res)
                for n in ("K1", "K2+K3")}
    print(f"phase 31 mesh (2, 2) on {MESH_WORLD} gloo ranks of this card "
          f"({spawn_s:.3f} s with the ranks' start): render_sharded_mega "
          f"({mega_cell}) equal to its emulation bit for bit: "
          f"{mega_equal}; sharded gradient loss {res[0]['loss']:.8e} vs "
          f"emulation {e_loss.item():.8e} (rel {l_err:.3e} < 1e-6), "
          f"gradient within rtol 1e-5 on every rank: {g_ok}; the ranks' "
          f"launches {launches}", flush=True)
    if not mega_equal:
        fail("render_sharded_mega on four ranks differs from its emulation")
    if l_err >= 1e-6 or not g_ok:
        fail("the sharded gradient on four ranks differs from its emulation")
    if launches["K1"] < MESH_WORLD or launches["K2+K3"] < MESH_WORLD:
        fail("a rank launched no megakernel")
    t0 = time.perf_counter()
    dry = dryrun_multichip(MESH_WORLD, device="cuda", backend="gloo",
                           timeout=MESH_TIMEOUT)
    k7_dry = sum(r["launches"]["K7"] for r in dry)
    print(f"phase 31 dryrun_multichip: {time.perf_counter() - t0:.3f} s, "
          f"the ranks' K7 launches {k7_dry}", flush=True)
    if k7_dry < MESH_WORLD:
        fail("the dry run's wavefront step launched no K7 kernel")
    return dict(launches=launches)


def phase_mesh_tools() -> dict:
    """The gradient path's two timing tools at their workloads, cut:
    grad_bench with one repeat, inverse_render_bench with 4 steps."""
    _reset_counts()
    row = grad_bench.run("cornell_box", GNX, GNY, GSPP, GDEPTH, 1, False,
                         "cuda")
    print(f"phase 32 grad_bench {json.dumps(row)}", flush=True)
    fit = inverse_render_bench.run("cornell_box", 64, 64, 16, 8, 1024, 4,
                                   0.08, "cuda")
    print(f"phase 32 inverse_render_bench {json.dumps(fit)}", flush=True)
    k23 = _launch_counts()["K2+K3"]
    print(f"phase 32 K2+K3 launches {k23}", flush=True)
    if not row["grad_finite"] or not np.isfinite(fit["loss_final"]):
        fail("a timing tool's gradient is not finite")
    if k23 < 1:
        fail("the timing tools launched no megakernel")
    return dict(row=row, fit=fit)


# the tools' phases (33-39), at their CLIs' defaults but where noted:
# cull_sweep over T x visit order at SB 128 on the large-S scenes (K5;
# large_mixed: K5s), and over T plus SB 128 (C = 4) on book 1, each list
# run forward then backward (turns), in CULL_LAUNCHES timed launches a
# config (the CLI's 2, raised: these rows answer which T and order the
# culled kernels prefer); mega_perf on the Cornell and huge cells;
# sampling_gallery at its default shape into a temporary directory
CULL_SWEEPS = (
    ("random_balls_large", LNX, LNY, 32,
     [f"128:{T}::{dord}" for T in (128, 256, 512) for dord in (0, 16)]),
    ("random_balls_huge", LNX, LNY, 16,
     [f"128:{T}::{dord}" for T in (128, 256) for dord in (0, 16)]),
    ("large_mixed", LNX, LNY, 32,
     [f"128:{T}::{dord}" for T in (128, 256) for dord in (0, 16)]),
    ("random_balls", NX, NY, SPP, [":128", ":256", ":512", "128"]))
CULL_LAUNCHES = 5
MEGA_PERF_CELLS = (("cornell_box", CNX, CNY, 256),
                   ("random_balls_huge", LNX, LNY, 16))
DYN_AB_SCENES = ("random_balls_large", "random_balls_huge")
BVH_SIZES = (512, 4096, 32768)


def _tool_counts(fn, *args) -> tuple:
    """fn(*args) with every kernel's count set to 0 just before and read
    just after: (its result, the counts)."""
    _reset_counts()
    out = fn(*args)
    return out, _launch_counts()


def _rows_line(label: str, rows: list) -> None:
    for row in rows:
        print(f"{label} {json.dumps(row)}", flush=True)


def phase_bench_all() -> dict:
    """tools/bench_all.py: the seven scenes, 2 warm-ups and 5 timed
    launches each."""
    rows, counts = _tool_counts(bench_all.run, bench_all.SCENES, 5, DEPTH,
                                "cuda")
    _rows_line("phase 33 bench_all", rows)
    print(f"phase 33 bench_all launches {counts}", flush=True)
    for row in rows:
        if not (min(row["segments_all"]) > 0
                and np.isfinite(row["rays_per_s_median"])):
            fail(f"bench_all traced nothing on {row['scene']}")
    for kernel in ("K1", "K2+K3", "K4", "K5"):
        if counts[kernel] < 1:
            fail(f"bench_all launched no {kernel} kernel")
    return counts


def phase_mega_perf() -> dict:
    """tools/mega_perf.py --stats on the Cornell and huge cells."""
    rows, counts = _tool_counts(lambda: [
        mega_perf.run(name, nx, ny, spp, DEPTH, 2, {}, True, "cuda")
        for name, nx, ny, spp in MEGA_PERF_CELLS])
    _rows_line("phase 34 mega_perf", rows)
    print(f"phase 34 mega_perf launches {counts}", flush=True)
    for row in rows:
        if not (0 < row["util"] <= 1 and 0 < row["lane_survival"]
                <= row["cull_survival"] <= 1):
            fail(f"mega_perf's counters are off on {row['scene']}")
    return counts


def phase_cull_sweep() -> dict:
    """tools/cull_sweep.py over CULL_SWEEPS in turns: each scene's mean
    rate a config and its fastest config."""
    rows, counts = _tool_counts(lambda: [
        cull_sweep.run(name, nx, ny, spp, DEPTH, CULL_LAUNCHES,
                       configs + configs[::-1], "cuda")
        for name, nx, ny, spp, configs in CULL_SWEEPS])
    for scene_rows in rows:
        _rows_line("phase 35 cull_sweep", scene_rows)
        rate = {}
        for r in scene_rows:
            rate.setdefault(r["spec"], []).append(r["m_seg_per_s"])
        mean = {spec: sum(v) / len(v) for spec, v in rate.items()}
        best = max(mean, key=mean.get)
        print(f"phase 35 cull_sweep {scene_rows[0]['scene']} M seg/s, mean "
              f"of the two turns: "
              + ", ".join(f"{spec} {m:.3f}" for spec, m in mean.items())
              + f"; fastest {best}", flush=True)
    print(f"phase 35 cull_sweep launches {counts}", flush=True)
    for kernel in ("K1", "K5", "K5s"):
        if counts[kernel] < 1:
            fail(f"cull_sweep launched no {kernel} kernel")
    return counts


def phase_dyn_ab() -> dict:
    """tools/dyn_ab_check.py on both stress scenes: every culled variant
    equal to the dense sweep bit for bit."""
    rows, counts = _tool_counts(dyn_ab_check.run, DYN_AB_SCENES, 64, 64, 8,
                                8, "cuda")
    _rows_line("phase 36 dyn_ab_check", rows)
    print(f"phase 36 dyn_ab_check launches {counts}", flush=True)
    bad = [f"{r['scene']} {r['variant']}" for r in rows if not r["passed"]]
    if bad:
        fail(f"dyn_ab_check: culled variants differ from dense: {bad}")
    return counts


def phase_bvh_bench() -> dict:
    """tools/bvh_bench.py at 2^20 rays, S in BVH_SIZES: k7 and
    bvh-skiplink held to its agreement gate."""
    rows, counts = _tool_counts(bvh_bench.run, 1 << 20, BVH_SIZES, 3,
                                "cuda")
    _rows_line("phase 37 bvh_bench", rows)
    for S in BVH_SIZES:
        r = {row["path"]: row for row in rows if row["S"] == S}
        k7_s, bvh_s = r["k7"]["seconds"], r["bvh-skiplink"]["seconds"]
        exact = r["k7"]["same_index"] == 1 and r["k7"]["max_abs_dt"] == 0
        print(f"phase 37 bvh_bench S={S}: k7 {k7_s * 1e3:.3f} ms, "
              f"bvh-skiplink {bvh_s * 1e3:.3f} ms: bvh / k7 "
              f"{bvh_s / k7_s:.3f}"
              + (f"; k7 bit-equal to plain-brute: {exact}"
                 if "plain-brute" in r else ""), flush=True)
    print(f"phase 37 bvh_bench launches {counts}", flush=True)
    bad = [f"S={r['S']} {r['path']}" for r in rows
           if not r.get("passed", True)]
    if bad:
        fail(f"bvh_bench: k7 and bvh-skiplink disagree past the gate: {bad}")
    if counts["K7"] < 1:
        fail("bvh_bench launched no K7 kernel")
    return counts


def phase_sampling_gallery() -> dict:
    """tools/sampling_gallery.py at 200x200x64 (regen), into a temporary
    directory: six finite frames, six PNGs."""
    with tempfile.TemporaryDirectory() as tmp:
        rows, counts = _tool_counts(sampling_gallery.run, tmp, "cornell_box",
                                    200, 64, DEPTH, "regen", "cuda")
        pngs = sorted(os.listdir(tmp))
    _rows_line("phase 38 sampling_gallery", rows)
    print(f"phase 38 sampling_gallery launches {counts}, pngs {pngs}",
          flush=True)
    if not all(r["finite"] for r in rows) or len(pngs) != 6:
        fail("sampling_gallery: a frame is not finite or was not written")
    if counts["K7"] < 1:
        fail("sampling_gallery launched no K7 kernel")
    return counts


def phase_mega_goldens() -> dict:
    """tools/mega_golden_check.py on the 32x32 and the 128x128 goldens
    (launches of 512 spp, each golden's spp)."""
    rows, counts = _tool_counts(lambda: mega_golden_check.run(
        sorted(golden_report.GOLDENS), False, 512, None, None, "cuda")
        + mega_golden_check.run(sorted(golden_report.GOLDENS_MULTITILE),
                                True, 512, None, None, "cuda"))
    _rows_line("phase 39 mega_golden_check", rows)
    print(f"phase 39 mega_golden_check launches {counts}", flush=True)
    bad = [r["golden"] for r in rows if not r["passed"]]
    if bad:
        fail(f"mega_golden_check failed the gate on {bad}")
    return counts


# the megakernel's plan modes (phases 40-43; make_plan's slots_per_pixel,
# coherent, super_group, batch_votes, unroll, every one off by default).
# Phase 40: each kernel in each mode it takes against its plain version on
# a cut (MODE_CUT: 64x64, 4 spp, depth 8, T = 256: the card tests'; K5 and
# K5s on the n = 30 probes, C = 8 clusters of 128, ascending order), and
# the culled modes against the dense kernel over the same slot table
MODE_CUT = (64, 64, 4, 8)
MODE_KERNELS = (("K1", "random_balls", {}), ("K2+K3", "cornell_box", {}),
                ("K4", "two_perlin_spheres", {}),
                ("K5", "random_balls_large", dict(SB=128, dyn_order=0)),
                ("K5s", "large_mixed", dict(SB=128, dyn_order=0)))
PLAN_MODES = (("k2", dict(slots_per_pixel=2)), ("unroll4", dict(unroll=4)),
              ("sg4", dict(super_group=4)), ("bv", dict(batch_votes=True)),
              ("sg4_bv", dict(super_group=4, batch_votes=True)))
CULL_ONLY = ("sg4", "bv", "sg4_bv")     # the modes of the culled kernels
# then the culling modes at the path's shapes against the plain version on
# every LARGE_TILE_STRIDE-th tile: K5 on random_balls_huge (C = 113, Cg 29
# union rows at sg 4, 113 vote slots a warp), K5s on large_mixed n = 120,
# and K5s's moving form on large_mixed's untextured moving variant: the
# path's frames, tables and shared-memory layouts, at 2 spp and depth
# MODE_DEPTH. The plain version of these modes votes every cluster for
# every lane a bounce, so its time goes with the iterations, not the tiles
# checked: 1200x800x16 at depth 50 took 62-94 s a launch, too long for the
# script's time limit
MODE_SPP, MODE_DEPTH = 2, 8
# (name, nx, ny, large_mixed's keywords or None for make_scene(name), mode)
MODE_PATH = (("random_balls_huge", LNX, LNY, None, "bv"),
             ("random_balls_huge", LNX, LNY, None, "sg4_bv"),
             ("large_mixed n=120", LNX, LNY, dict(n=120), "sg4_bv"),
             ("large_mixed n=60 untextured moving", *MSMALL[:2],
              dict(n=60, textured=False, moving=True), "sg4_bv"))
# phase 41, in turns (forward, then backward): k = 1, 2, 4 lanes a pixel
# on small frames (128x128: 64 blocks of 256 lanes for the 132 SMs at
# k = 1); super-groups of 4 and 8 clusters and batched votes against the
# ascending order on the large-S cells (1200x800, x32 / x16, SB 128; K5s
# on large_mixed n = 120), each mode's rows 0-5 held bit for bit to the
# others' over the same slot table (SAME_TABLE); the unroll U = 1, 4, 16
# on cornell_box 400x400x64 and book 1 1200x800x64
K_FRAMES = (("random_balls", 128, 128, 64), ("cornell_box", 128, 128, 64),
            ("random_balls_large", 128, 128, 32))
K_TURNS = (1, 2, 4)
CULL_MODES = (("ascending", {}), ("sg4", dict(super_group=4)),
              ("sg8", dict(super_group=8)),
              ("bv", dict(batch_votes=True)),
              ("sg4_bv", dict(super_group=4, batch_votes=True)))
CULL_CELLS = (("random_balls_large", 32, None), ("random_balls_huge", 16, None),
              ("large_mixed", 16, 120))
# the modes whose plans share a slot table: the kd table's (ascending,
# batched votes) and the Morton table's (the super-groups)
SAME_TABLE = (("ascending", "bv"), ("sg4", "sg8", "sg4_bv"))
UNROLL_CELLS = (("cornell_box", CNX, CNY, CLAUNCH, 20),
                ("random_balls", NX, NY, SPP, 3))
UNROLL_TURNS = (1, 4, 16)
MODE_REPS = 2      # timed launches a turn of the large-S cells


def _mode_scene(name, nx, ny, n=None):
    if name == "large_mixed":
        return large_mixed(60 if n is None else n, nx / ny)
    return make_scene(name, nx / ny, **({} if n is None else {"n": n}))


def phase_plan_modes() -> dict:
    """Each kernel in each plan mode it takes against its plain version on
    MODE_CUT (dense kernels: rows 0-5 within RTOL / ATOL; culled: rows
    0-7 equal, swept and needed blocks included, on >= MIN_SAME of the
    valid lanes), and each culled mode against the dense kernel over the
    same slot table (rows 0-5 equal bit for bit); then the culling modes
    of MODE_PATH at the path's shapes (_kernel_vs_plain). Returns each
    kernel's max abs error of its lanes' means and its launches here."""
    nx, ny, spp, depth = MODE_CUT
    err = {k: 0.0 for k, *_ in MODE_KERNELS}
    _reset_counts()
    for kernel, name, kw in MODE_KERNELS:
        culled = kernel in ("K5", "K5s")
        scene = _mode_scene(name, nx, ny, 30 if culled else None)
        for mode, mkw in PLAN_MODES:
            if mode in CULL_ONLY and not culled:
                continue
            _, plan = mk.make_plan(scene, nx, ny, spp, max_depth=depth,
                                   T=256, **kw, **mkw)
            args, _ = mk.device_inputs(scene, plan, "cuda")
            out_k = mk.mega_kernel(*args, SEED, plan)
            out_r = mk.trace_mega_reference(*args, SEED, plan)
            valid = args[0][:, 2] > 0
            rows = 8 if culled else 6
            same = (out_k[:, :rows] == out_r[:, :rows]).all(dim=1) & valid
            close = torch.isclose(out_k[:, :6], out_r[:, :6], rtol=RTOL,
                                  atol=ATOL).all(dim=1) & valid
            frac = ((same if culled else close).sum()
                    / valid.sum()).item()
            e = (_lane_means(out_k) - _lane_means(out_r)).abs()[
                valid].max().item()
            err[kernel] = max(err[kernel], e)
            line = (f"phase 40 {kernel} {mode} ({name} {nx}x{ny}x{spp}, "
                    f"depth {depth}, T={plan.T}, k={plan.k}, "
                    f"unroll={plan.unroll}, C={plan.C}, sg={plan.sg}, "
                    f"batch_votes={plan.batch_votes}): kernel vs plain "
                    f"{'equal' if culled else 'close'} on {frac:.6f} of "
                    f"lanes, max abs err {e:.3e}")
            if mode in CULL_ONLY:
                dense, dargs = mk.dense_over(plan, args)
                out_d = mk.mega_kernel(*dargs, SEED, dense)
                eq = torch.equal(out_k[:, :6], out_d[:, :6])
                blocks = out_k[:, 6].sum().item()
                iters = out_k[:, 4].sum().item() * plan.C
                line += (f"; equal to the dense kernel over the same slots "
                         f"bit for bit {eq}; warp survival "
                         f"{blocks / iters:.6f}, per-lane survival "
                         f"{out_k[:, 7].sum().item() / iters:.6f}")
                if not eq:
                    fail(f"{kernel} {mode} differs from the dense kernel")
            print(line, flush=True)
            if frac < MIN_SAME:
                fail(f"{kernel} in mode {mode} disagrees with its plain "
                     "version")
    print(f"phase 40 the culling modes at the path's shapes, {MODE_SPP} spp, "
          f"depth {MODE_DEPTH}, plain version on every {LARGE_TILE_STRIDE}th "
          f"tile", flush=True)
    for name, nx, ny, mixed, mode in MODE_PATH:
        scene = None if mixed is None else large_mixed(aspect=nx / ny,
                                                       **mixed)
        run = _kernel_vs_plain(name, nx, ny, MODE_SPP, f"phase 40 {mode}",
                               tile_stride=LARGE_TILE_STRIDE, scene=scene,
                               plan_kw=dict(SB=128, dyn_order=0,
                                            max_depth=MODE_DEPTH,
                                            **dict(PLAN_MODES)[mode]))
        kernel = "K5" if scene is None else "K5s"
        err[kernel] = max(err[kernel], run["max_abs_err"])
    counts = _launch_counts()
    print(f"phase 40 launches {counts}", flush=True)
    for kernel, *_ in MODE_KERNELS:
        if counts[kernel] < 1:
            fail(f"phase 40 launched no {kernel} kernel")
    return dict(max_abs_err=err, launches=counts)


def _turns(configs: list, run, reps: int) -> dict:
    """Each (label, launch) of `configs` timed by CUDA events in turns,
    forward then backward: one warm-up, then `reps` launches a turn.
    Returns label -> (the turns' ms a launch, the last output)."""
    got = {label: ([], None) for label, _ in configs}
    for label, launch in configs + configs[::-1]:
        run(launch)
        ms, out = _event_ms(lambda: run(launch), reps)
        got[label] = (got[label][0] + [ms], out)
    return got


def _rate_line(label: str, ms: list, out, plan) -> dict:
    segs = out[:, 3].sum().item()
    iters = out[:, 4].sum().item()
    row = dict(ms=ms, m_seg_per_s=segs / (sum(ms) / len(ms)) / 1e3,
               segments=segs, util=segs / iters)
    if plan.cull:
        row.update(warp_survival=out[:, 6].sum().item() / (iters * plan.C),
                   lane_survival=out[:, 7].sum().item() / (iters * plan.C))
    print(f"{label} {json.dumps(row)}", flush=True)
    return row


def phase_mode_timings() -> dict:
    """The plan modes timed in turns (see K_FRAMES, CULL_MODES,
    UNROLL_CELLS): ms a launch, M segments/s, util and, culled, the warp
    and per-lane survivals, a row a config."""
    _reset_counts()
    rows = {}

    def launch_of(scene, nx, ny, spp, **kw):
        _, plan = mk.make_plan(scene, nx, ny, spp, max_depth=DEPTH, **kw)
        args, _ = mk.device_inputs(scene, plan, "cuda")
        return plan, args

    def run(launch):
        plan, args = launch
        return mk.mega_kernel(*args, SEED, plan)

    for name, nx, ny, spp in K_FRAMES:
        scene = _mode_scene(name, nx, ny)
        cfgs = [(f"k={k}", launch_of(scene, nx, ny, spp, slots_per_pixel=k))
                for k in K_TURNS]
        for label, (ms, out) in _turns(cfgs, run, 5).items():
            plan = dict(cfgs)[label][0]
            rows[f"{name} {nx}x{ny}x{spp} {label}"] = _rate_line(
                f"phase 41 {name} {nx}x{ny}x{spp} {label} (blocks "
                f"{out.shape[0]})", ms, out, plan)
    for name, spp, n in CULL_CELLS:
        scene = _mode_scene(name, LNX, LNY, n)
        cell = name if n is None else f"{name} n={n}"
        cfgs = [(label, launch_of(scene, LNX, LNY, spp, SB=128,
                                  dyn_order=0, **kw))
                for label, kw in CULL_MODES]
        got = _turns(cfgs, run, MODE_REPS)
        for label, (ms, out) in got.items():
            plan = dict(cfgs)[label][0]
            rows[f"{cell} {label}"] = _rate_line(
                f"phase 41 {cell} {LNX}x{LNY}x{spp} SB 128 {label}", ms,
                out, plan)
        for group in SAME_TABLE:
            first = got[group[0]][1][:, :6]
            same = [torch.equal(first, got[m][1][:, :6]) for m in group[1:]]
            print(f"phase 41 {cell}: rows 0-5 of {', '.join(group[1:])} "
                  f"equal {group[0]}'s bit for bit: {same}", flush=True)
            if not all(same):
                fail(f"the culling modes {group} differ on {cell}")
    for name, nx, ny, spp, reps in UNROLL_CELLS:
        scene = _mode_scene(name, nx, ny)
        cfgs = [(f"U={u}", launch_of(scene, nx, ny, spp, unroll=u))
                for u in UNROLL_TURNS]
        for label, (ms, out) in _turns(cfgs, run, reps).items():
            plan = dict(cfgs)[label][0]
            rows[f"{name} {label}"] = _rate_line(
                f"phase 41 {name} {nx}x{ny}x{spp} {label}", ms, out, plan)
    counts = _launch_counts()
    print(f"phase 41 launches {counts}", flush=True)
    return dict(rows=rows, launches=counts)


def phase_coherence_sweep() -> dict:
    """tools/coherence_sweep.py at its defaults (random_balls_large x32,
    random_balls_huge x16, large_mixed n = 60 x32 at 1200x800, depth 50),
    MODE_REPS timed launches a turn."""
    rows, counts = _tool_counts(coherence_sweep.run, list(
        coherence_sweep.SCENES), LNX, LNY, 0, DEPTH, MODE_REPS, "cuda")
    _rows_line("phase 42 coherence_sweep", rows)
    print(f"phase 42 coherence_sweep launches {counts}", flush=True)
    for r in rows:
        if not (r["segments"] > 0 and 0 < r["lane_survival"]
                <= r["warp_survival"] <= 1):
            fail(f"coherence_sweep's counters are off on {r['scene']}")
    for kernel in ("K5", "K5s"):
        if counts[kernel] < 1:
            fail(f"coherence_sweep launched no {kernel} kernel")
    return counts


def phase_export_texture() -> None:
    """tools/export_texture_raw.py on a PNG that write_png made of
    earth.rtwi: the RTWI it writes is earth.rtwi byte for byte."""
    with tempfile.TemporaryDirectory() as tmp:
        png = os.path.join(tmp, "earth.png")
        image_mod.write_png(image_mod.load_image(RTWI), png)
        out = os.path.join(tmp, "earth.rtwi")
        nx, ny = export_texture_raw.export(out, png)
        with open(out, "rb") as f, open(RTWI, "rb") as g:
            same = f.read() == g.read()
    print(f"phase 43 export_texture_raw ({nx}x{ny} from a PNG of "
          f"earth.rtwi): the oracle's bytes {same}", flush=True)
    if not same:
        fail("export_texture_raw did not write the oracle's earth.rtwi")


def _tool_launches(tools: dict, kernel: str) -> dict:
    """A kernel's launches on each tool's path that launched it."""
    return {tool: c[kernel] for tool, c in tools.items() if c.get(kernel)}


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
    _, golden4 = _tool_counts(_timed, "phase 4", phase_goldens)
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
    _, golden16 = _tool_counts(_timed, "phase 16", phase_wavefront_goldens)
    k7_vjp = _timed("phase 17", phase_k7_vjp)
    mega_grad = _timed("phase 18", phase_mega_grad)
    _timed("phase 19", phase_mega_fit)
    wave_grad = _timed("phase 20", phase_wavefront_grad)
    twin = _timed("phase 24", phase_sweep_twin, sweep, main_run, k1)
    bench = _timed("phase 25", phase_microbench)
    repros = _timed("phase 26", phase_mosaic_repros, i2f)
    _timed("phase 26b", phase_tile_32768)
    ck = _timed("phase 27", phase_checkpoint)
    _timed("phase 28", phase_texture_input)
    _timed("phase 29", phase_utilities, ck["canvas"])
    mesh_run = _timed("phase 30", phase_mesh_nccl, mega_grad)
    _timed("phase 31", phase_mesh_gloo)
    _timed("phase 32", phase_mesh_tools)
    tools = {"golden_report": {k: golden4[k] + golden16[k] for k in golden4},
             "bench_all": _timed("phase 33", phase_bench_all),
             "mega_perf": _timed("phase 34", phase_mega_perf),
             "cull_sweep": _timed("phase 35", phase_cull_sweep),
             "dyn_ab_check": _timed("phase 36", phase_dyn_ab),
             "bvh_bench": _timed("phase 37", phase_bvh_bench),
             "sampling_gallery": _timed("phase 38", phase_sampling_gallery),
             "mega_golden_check": _timed("phase 39", phase_mega_goldens)}
    modes = _timed("phase 40", phase_plan_modes)
    mode_runs = {"phase 41 timings": _timed("phase 41",
                                            phase_mode_timings)["launches"]}
    tools["coherence_sweep"] = _timed("phase 42", phase_coherence_sweep)
    _timed("phase 43", phase_export_texture)
    entries = [
        dict(name="megakernel K1 (book-1 sphere path, random_balls; "
                  f"redesigned: {REDESIGN_DENSE})",
             source="raytracingweekend_tpu_torch/csrc/megakernel.cu",
             replaces="raytracingweekend_tpu/ops/megakernel.py:371",
             launches=main_run["launches"],
             mesh_path_launches=mesh_run["k1"],
             max_abs_err=max(k1["max_abs_err"], parity["K1"],
                             widths["max_abs_err"]),
             ms=k1["ms"], plain_ms=k1["plain_ms"], bound_ms=k1["bound_ms"],
             redesigned=True),
        dict(name="megakernel K2+K3 (rects, lights + MIS, emission, media; "
                  f"cornell_box timings; redesigned: {REDESIGN_SURFACES})",
             source="raytracingweekend_tpu_torch/csrc/megakernel.cu",
             replaces="raytracingweekend_tpu/ops/megakernel.py:1022",
             launches=cornell_run["launches"],
             mesh_path_launches=mesh_run["k23"],
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
    for e, kernel in zip(entries, ("K1", "K2+K3", "K4", "K5", "K5s")):
        e.update(route="cuda", bound_by="operations", library_ms=None,
                 tool_path_launches=_tool_launches(tools, kernel),
                 plan_mode_launches=dict(
                     vs_plain=modes["launches"][kernel],
                     **_tool_launches(mode_runs, kernel)),
                 max_abs_err=max(e["max_abs_err"],
                                 modes["max_abs_err"][kernel]))
    k7_main = k7_rows[0]
    entries.append(dict(
        name="K7 wavefront closest sphere hit (random_balls regen rays "
             f"N=524288, S={k7_main['S']} moving; per call; redesigned: "
             f"{REDESIGN_K7})",
        source="raytracingweekend_tpu_torch/csrc/intersect.cu",
        replaces="raytracingweekend_tpu/ops/pallas_intersect.py:139",
        launches=wave_run["launches"],
        mesh_path_launches=mesh_run["k7"],
        grad_path_launches=wave_grad["launches"],
        tool_path_launches=_tool_launches(tools, "K7"),
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
