#!/usr/bin/env python3
"""Smoke test of the PyTorch/CUDA port on one NVIDIA GPU.

Run from the root of a checkout:

    python3 chip_smoke.py

It builds the port's CUDA kernels from the sources in the checkout, holds
each against its plain PyTorch version on the card, checks the renderer
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
bit. Each kernel is held to its plain version at its path's full launch
shape. It prints one line per phase. Any failure exits non-zero; without a CUDA device it exits
non-zero before printing any result. The last line is one JSON object
naming the device.
"""
from __future__ import annotations

import json
import os
import re
import subprocess
import sys
import tempfile
import time

import numpy as np
import torch

from raytracingweekend_tpu_torch.models import (builder, probe_scenes,
                                                scene_types)
from raytracingweekend_tpu_torch.models.scenes import make_scene
from raytracingweekend_tpu_torch.ops import _build
from raytracingweekend_tpu_torch.ops import megakernel as mk
from raytracingweekend_tpu_torch.render import RenderStats, render
from raytracingweekend_tpu_torch.utils import image as image_mod
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
RTWI = os.path.join(REPO, "tools", "reference_oracle", "earth.rtwi")
TEXTURE_PATH = (("earth", {"image_path": RTWI}),
                ("earth_rect", {"image_path": RTWI}),
                ("two_perlin_spheres", {}), ("light_sample", {}),
                ("checker_spheres", {}))
SEED = 20240601

# FP32 operations of a path segment, counted from csrc/megakernel.cu (add,
# sub, mul, div, sqrt, rsqrt, log, exp = 1, FMA = 2; compares, min / max,
# selects and the integer RNG hash not counted). A segment pays the
# closest-hit search, the floor, and the shading of what it hit; the mix
# of what segments hit is measured in this run (`segment_mix`).
OPS_SLOT_STATIC = 20          # sweep slot: co 3, nb 5, cc 6, disc 2, rsqrt,
#                               sq, tn / tf 2
OPS_SLOT_MOVING = 6           # 3 motion FMAs
OPS_SLOT_SHUTTER = 2          # per-slot motion fraction (no uniform shutter)
OPS_RECT = 6                  # (k - o_n) * 1/d_n, two plane-point FMAs
OPS_GROUP = {0: 0, 1: 17, 2: 3, 3: 17}   # object-space ray per transform
#                               group (rotated | translated << 1)
OPS_MEDIUM = {0: 38, 1: 32}   # sphere / box medium boundary, with log and
#                               FMA of the scatter distance (rotated form)
OPS_RECIPROCALS = 3           # 1/d of a surfaces segment
OPS_FLOOR = 32                # count 1, hit point 6, ddn + mirror 12,
#                               normalise 9, throughput 3, depth 1
OPS_SPHERE_NORMAL = 6         # (p - c) / r (+ 8 with moving centres)
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
# shrink (1 mul); swept blocks pay SB slots each
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
MATERIALS = ("lambertian", "metal", "dielectric", "light")


def fail(msg: str):
    raise SystemExit(f"chip_smoke: FAIL: {msg}")


def ops_per_segment(plan, mix: dict, blocks: float = 1.0) -> float:
    """The FP32 operations of an average path segment of `plan` whose
    hits are distributed as `mix` (fractions of segments: miss, medium,
    sphere, and the material of each surface hit; ends = paths ended per
    segment); a culled plan sweeps `blocks` clusters a segment."""
    ops = float(OPS_FLOOR)
    if plan.has_spheres:
        slot = OPS_SLOT_STATIC
        if plan.moving or any(plan.moving_axes):
            slot += OPS_SLOT_MOVING
            if not plan.uniform_time:
                slot += OPS_SLOT_SHUTTER
        if plan.cull:
            ops += (OPS_RECIPROCALS + blocks * plan.SB * slot
                    + (plan.C * OPS_VOTE + blocks * OPS_REVOTE
                       if plan.dyn_order else plan.C * OPS_REVOTE))
        else:
            ops += plan.S * slot
        ops += mix["sphere"] * (OPS_SPHERE_NORMAL + 8 * plan.moving)
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


def bound_ms(plan, segments: float, mix: dict, blocks: float = 0.0) -> float:
    """Least time of a launch that traced `segments` path segments (and,
    culled, swept `blocks` cluster blocks): their FP32 operations over the
    card's FP32 peak. Bytes do not bound it: the dense kernels' tables sit
    in shared memory, the culled kernel's slot quads in L2 (231 KB for
    random_balls_huge), and a launch reads 16 B and writes 32 B per
    lane."""
    return (ops_per_segment(plan, mix, blocks / max(segments, 1.0))
            * segments / FP32_PEAK * 1e3)


def _kernel_name(mangled: str):
    """'<kMoving,kUniformTime>', 'surfaces<kMoving,kUniformTime,kTex>' or
    'culled<kMoving,kUniformTime>' of a mangled mega_kernel /
    mega_kernel_surfaces / mega_kernel_culled instantiation, else None."""
    m = re.search(
        r"mega_kernel(_surfaces|_culled)?ILb(\d)ELb(\d)E(?:Lb(\d)E)?",
        mangled)
    if not m:
        return None
    args = ",".join(g for g in m.groups()[1:] if g is not None)
    return f"{(m.group(1) or '_')[1:]}<{args}>"


def sweep_sass(lib: str) -> dict:
    """SASS instructions per sphere slot of each kernel instantiation's
    sweep loop (`cuobjdump -sass` of the built library): the innermost
    loop with the most MUFU.RSQ (one per slot; nvcc unrolls the sweep)
    and no warp vote (the culled kernel's cluster visits vote; its slot
    loop does not), from its branch target to its backward branch.
    Returns {name: (instructions, slots)}."""
    tool = os.path.join(os.path.dirname(_build._nvcc()), "cuobjdump")
    sass = subprocess.run([tool, "-sass", lib], capture_output=True,
                          text=True, check=True, timeout=120).stdout
    out = {}
    for func in re.split(r"\n\s*Function : ", sass)[1:]:
        name = _kernel_name(func.split(None, 1)[0])
        if name is None:
            continue
        ins = [(int(a, 16), op) for a, op in
               re.findall(r"/\*([0-9a-f]{4,})\*/\s+(.*?)\s*;", func)]
        addr = {a: k for k, (a, _) in enumerate(ins)}
        loops = []
        for k, (a, op) in enumerate(ins):
            br = re.search(r"\bBRA\s+(0x[0-9a-f]+)", op)
            if br and int(br.group(1), 16) <= a:
                loops.append((addr[int(br.group(1), 16)], k))
        inner = [(a, b) for a, b in loops
                 if not any(a <= c and d <= b and (c, d) != (a, b)
                            for c, d in loops)
                 and not any(re.match(r"(VOTE|REDUX)", op)
                             for _, op in ins[a:b + 1])]
        best = max(((sum("MUFU.RSQ" in op for _, op in ins[a:b + 1]),
                     b - a + 1) for a, b in inner), default=(0, 0))
        out[name] = (best[1], best[0])
    return out


def phase_device() -> None:
    if not torch.cuda.is_available():
        fail("torch.cuda.is_available() is False: this smoke test needs an "
             "NVIDIA GPU")
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60)
    print(smi.stdout.strip())
    print(f"phase 1 device: {torch.cuda.get_device_name(0)}, "
          f"count {torch.cuda.device_count()}, torch {torch.__version__}, "
          f"CUDA {torch.version.cuda}", flush=True)


def phase_build() -> None:
    t0 = time.perf_counter()
    lib, nvcc_secs = _build.build()
    mk._kernel_lib()
    log = _build.build_log()
    # one entry per kernel instantiation <kMoving, kUniformTime>: its
    # registers and spill stores
    rows = []
    for m in re.finditer(r"Compiling entry function '([^']*)'(.*?)Used "
                         r"(\d+) registers", log, re.S):
        spill = re.search(r"(\d+) bytes spill stores", m.group(2))
        stack = re.search(r"(\d+) bytes stack frame", m.group(2))
        rows.append(f"{_kernel_name(m.group(1))}: {m.group(3)} regs, "
                    f"{spill.group(1) if spill else '?'} B spill, "
                    f"{stack.group(1) if stack else '?'} B stack")
    sweep = sweep_sass(str(lib))
    per_slot = "; ".join(f"{k}: {n} / {s} = {n / s:.2f}" if s else f"{k}: -"
                         for k, (n, s) in sorted(sweep.items()))
    print(f"phase 2 build: {os.path.basename(lib)} nvcc {nvcc_secs:.3f} s, "
          f"build+load {time.perf_counter() - t0:.3f} s; "
          f"instantiations {'; '.join(rows)}; sweep SASS instructions per "
          f"slot (loop / slots) {per_slot}", flush=True)


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
    blocks = (out_k[:, 6] == out_r[:, 6])[same].float().mean().item()
    print(f"phase 3 exact-spp parity ({label} 64x64, 8 spp, depth 8, "
          f"T=256): tapes equal on {frac:.6f} of lanes (mismatch "
          f"{1 - frac:.6f}), max abs radiance err {err:.3e} "
          f"(rtol {RTOL}, atol {ATOL}), swept blocks equal on {blocks:.6f} "
          f"of them: {'ok' if close and blocks == 1.0 else 'FAIL'}",
          flush=True)
    if frac < MIN_SAME or not close or blocks != 1.0:
        fail(f"kernel disagrees with its plain version in exact-spp mode "
             f"({label})")
    return err


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
    return errs


def _load_golden(name):
    with open(os.path.join(GOLDEN_DIR, name), "rb") as f:
        m = re.match(r"RTWO (\d+) (\d+)", f.readline().decode())
        nx, ny = int(m.group(1)), int(m.group(2))
        data = np.frombuffer(f.read(), dtype="<f8")
    return data.reshape(ny, nx, 3)


def phase_goldens() -> None:
    """The pixelwise criterion of tests/test_golden.py through render()."""
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
        cfg = RenderConfig(nx=nx, ny=ny, spp=spp, max_depth=50,
                           samples_per_launch=64, seed=7, device="cuda")
        t0 = time.perf_counter()
        o = render(make_scene(name, nx / ny, **kw),
                   cfg).double().cpu().numpy()
        secs = time.perf_counter() - t0
        mean_rel = abs(o.mean() - g.mean()) / max(g.mean(), 1e-6)
        err = np.abs(o - g)
        tol = 0.05 + 4.0 * np.sqrt(np.maximum(g, 0.0) / spp)
        frac_ok = float((err <= tol).mean())
        ok = np.isfinite(o).all() and mean_rel < 0.02 and frac_ok > 0.995
        print(f"phase 4 golden {name} {nx}x{ny} {spp} spp: mean {o.mean():.6f}"
              f" vs {g.mean():.6f} (rel {mean_rel:.5f} < 0.02), pixels in "
              f"tolerance {frac_ok:.5f} > 0.995, {secs:.3f} s: "
              f"{'ok' if ok else 'FAIL'}", flush=True)
        if not ok:
            fail(f"golden parity failed for {golden}")


def _drive(name, nx, ny, spp, launch_spp, depth, kernel, label,
           **kw) -> dict:
    """render() of one scene (make_scene keywords `kw`): one warm-up
    launch, then `spp` samples in launches of `launch_spp`, with the
    kernel's launch count set to 0 just before the path and read just
    after."""
    scene = make_scene(name, nx / ny, **kw)
    base = dict(nx=nx, ny=ny, max_depth=depth, samples_per_launch=launch_spp,
                device="cuda")
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
    return dict(launches=launches[kernel], rate=stats.rays_per_s)


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


def phase_large_path() -> dict:
    """The large-S path at full width: each stress scene 1200x800, three
    timed launches after a warm-up."""
    runs = [_drive(name, LNX, LNY, LLAUNCHES * spp, spp, LDEPTH, "K5",
                   "phase 10 large-S path") for name, spp in LARGE_PATH]
    return dict(launches=sum(r["launches"] for r in runs))


def phase_culled_vs_dense() -> dict:
    """random_balls_large at its path's launch (1200x800x32), whose dense
    sweep (S = 3712) still fits in shared memory: the culled kernel against
    the dense one on the same inputs, every output row but the block
    count, timed in turns (dense, culled, culled, dense)."""
    name, spp = LARGE_PATH[0]
    scene = make_scene(name, LNX / LNY)
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
    surv = (outs["culled"][:, 6].sum() / (outs["culled"][:, 4].sum()
                                          * culled.C)).item()
    print(f"phase 11 culled vs dense kernel ({name} {LNX}x{LNY}x{spp} spp, "
          f"S={culled.S}, C={culled.C}, SB={culled.SB}, near-to-far "
          f"{culled.dyn_order} buckets): culled {ms_c:.3f} ms, dense "
          f"{ms_d:.3f} ms per launch (dense, culled, culled, dense: "
          f"{runs['dense'][0]:.3f} {runs['culled'][0]:.3f} "
          f"{runs['culled'][1]:.3f} {runs['dense'][1]:.3f}); survival "
          f"{surv:.6f}; pixels, segments, lane iterations and sample counts "
          f"equal: {equal} (max abs err {err:.3e}; segments "
          f"{b[:, 3].sum().item():.6e})", flush=True)
    if not equal:
        fail("the culled kernel differs from the dense kernel")
    return dict(max_abs_err=err, dense_ms=ms_d)


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
                     **kw) -> dict:
    """One launch at a path's shape: the kernel and its plain version on
    the same inputs, timed with CUDA events and compared pixel by pixel;
    the bound from the launch's segments and the measured hit mix. With
    `tile_stride` > 1 the plain version traces every `tile_stride`-th tile
    of the launch only (the others are marked invalid in its copy of the
    pixel table; tiles are independent and keep their RNG streams), and
    the kernel's output is compared on those tiles. A culled plan also
    compares the swept-block counts (row 6) lane by lane."""
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
    mix = segment_mix(scene)
    ops = ops_per_segment(plan, mix, blocks / segments)
    bound = bound_ms(plan, segments, mix, blocks)
    part = (f" on every {tile_stride}th tile ({sel.sum().item()} of "
            f"{sel.numel()})" if tile_stride > 1 else "")
    culled = ""
    frac_blk = 1.0
    if plan.cull:
        frac_blk = (out_k[:, 6, :] == out_r[:, 6, :])[lanes].float().mean(
        ).item()
        culled = (f"; C={plan.C}, SB={plan.SB}, survival "
                  f"{blocks / (out_k[:, 4, :].sum().item() * plan.C):.6f}, "
                  f"swept-block counts{part} equal on {frac_blk:.6f} of "
                  f"lanes")
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
                bound_ms=bound)


def main() -> int:
    phase_device()
    phase_build()
    parity = phase_exact_parity()
    phase_goldens()
    main_run = phase_main_path()
    cornell_run = phase_cornell_path()
    texture_run = phase_texture_path()
    large_run = phase_large_path()
    vs_dense = phase_culled_vs_dense()
    k1 = _kernel_vs_plain("random_balls", NX, NY, SPP, "phase 5b")
    k23 = [_kernel_vs_plain(name, CNX, CNY, CLAUNCH, "phase 7")
           for name in CORNELL_PATH]
    k4 = [_kernel_vs_plain(name, TNX, TNY, TSPP, "phase 9",
                           tile_stride=PLAIN_TILE_STRIDE.get(name, 1), **kw)
          for name, kw in TEXTURE_PATH]
    print(f"phase 12 plain version of the culled kernel on every "
          f"{LARGE_TILE_STRIDE}th tile (N = {LARGE_TILE_STRIDE})", flush=True)
    k5 = [_kernel_vs_plain(name, LNX, LNY, spp, "phase 12",
                           tile_stride=LARGE_TILE_STRIDE)
          for name, spp in LARGE_PATH]
    entries = [
        dict(name="megakernel K1 (book-1 sphere path, random_balls)",
             source="raytracingweekend_tpu_torch/csrc/megakernel.cu",
             replaces="raytracingweekend_tpu/ops/megakernel.py:371",
             launches=main_run["launches"],
             max_abs_err=max(k1["max_abs_err"], parity["K1"]),
             ms=k1["ms"], plain_ms=k1["plain_ms"], bound_ms=k1["bound_ms"]),
        dict(name="megakernel K2+K3 (rects, lights + MIS, emission, media; "
                  "cornell_box timings)",
             source="raytracingweekend_tpu_torch/csrc/megakernel.cu",
             replaces="raytracingweekend_tpu/ops/megakernel.py:1022",
             launches=cornell_run["launches"],
             max_abs_err=max([parity["K2+K3"]]
                             + [r["max_abs_err"] for r in k23]),
             ms=k23[0]["ms"], plain_ms=k23[0]["plain_ms"],
             bound_ms=k23[0]["bound_ms"]),
        dict(name="megakernel K4 (checker, Perlin noise, image textures; "
                  "earth on earth.rtwi timings)",
             source="raytracingweekend_tpu_torch/csrc/megakernel.cu",
             replaces="raytracingweekend_tpu/ops/megakernel.py:1410",
             launches=texture_run["launches"],
             max_abs_err=max([parity["K4"]]
                             + [r["max_abs_err"] for r in k4]),
             ms=k4[0]["ms"], plain_ms=k4[0]["plain_ms"],
             bound_ms=k4[0]["bound_ms"]),
        dict(name="megakernel K5 (cluster-culled sphere sweep; "
                  "random_balls_large 1200x800x32 timings, plain version "
                  f"on every {LARGE_TILE_STRIDE}th tile)",
             source="raytracingweekend_tpu_torch/csrc/megakernel.cu",
             replaces="raytracingweekend_tpu/ops/megakernel.py:753",
             launches=large_run["launches"],
             max_abs_err=max([parity["K5"], vs_dense["max_abs_err"]]
                             + [r["max_abs_err"] for r in k5]),
             ms=k5[0]["ms"], plain_ms=k5[0]["plain_ms"],
             bound_ms=k5[0]["bound_ms"]),
    ]
    for e in entries:
        e.update(route="cuda", bound_by="operations", library_ms=None)
    print(json.dumps({"kernels": entries}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
