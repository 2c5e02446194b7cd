"""The megakernel's sweeps (dense: K1-K4 and the twin K8; culled: K5, K5s),
the wavefront's closest sphere hit (K7) and the dot microbenchmark (K9)
on the card against other checkouts', the split of the culled kernels'
warps' cycles and of the dense surfaces kernel's lanes' cycles.

Times the shipped kernels with CUDA events on each cell at its path's
launch shape and, with `--parent DIR` (repeatable), other checkouts'
kernels (their whole `csrc/`, such as the parent commit unpacked by `git
archive`, built into a library of their own) in turns (shipped, parents,
parents in reverse, shipped), held to the shipped kernel bit for bit: a
dense cell on every output row and tape row, a culled cell on every row
but row 7 (an older kernel writes 0 there), the twin on its rows, K7 on
best_t and best_i. `--split` launches each culled cell once more on the
build instrumented with clock64 (-DRTW_SPLIT) and prints the shares of
its warps' cycles: the key pass and buckets, the votes, the broadcast
and the compacted sweeps, and the rest (shading, RNG, tile tails); and
each dense surfaces
cell in overdraw mode: the shares of its lanes' cycles in the sweep, the
rects, the media, each material's shading (the lambertian's light sample
and light pdf apart), each texture kind, regeneration and the overdraw
barrier, and the grid tail (the share of the launch during which fewer
than all SMs hold a block, from each block's start and end on the global
timer). Culled cells: the four large-S cells of chip_smoke.py,
random_balls_large in exact mode (the gradient path's mode: clusters
visited in ascending id), large_mixed with moving balls, and book 1's
random_balls cut into C = 4 clusters (moving, ascending id). Dense
cells: book 1 (random_balls 1200x800x64, K1's y-only slot loop), the
probe `shutter` (per-slot shutters, the all-axes loop), a static sphere
scene (random_balls_large swept densely, 1200x800x8), book 1 in exact
mode (1200x800x4), the surfaces cells (K2-K4): cornell_box and
cornell_smoke 400x400x64, cornell_box 128x128x32 in exact mode at
T = 1024, depth 8 (`cornell_exact`: the gradient path's tape forward),
earth 800x600x64 on earth.rtwi, two_perlin_spheres and checker_spheres
800x600x64; and the sweep twin at K = 200 (K8). K7 cells: the rays of the
first regen iteration of random_balls (S = 512), random_balls_large
(3840) and random_balls_huge (14592) at the wavefront's main shape
(1200x800x8: N = 524,288 rays), ms a call. The K9 cell: its nine rows at
the tool's S = 512, T = 2048, µs a step (the tool's slope between N and
4 N steps), rows 0-7 after 8 steps beside the shipped build's (bit-equal
where the sum order is the same). The Mosaic repro cells (`k10`-`k14`):
each repro's forms (K13: its four probes) on its repro's inputs, device
µs a launch read by torch.profiler (`--reps` launches a turn), beside the
launch floor (the shipped build's empty kernel, profiled in the same
turns), each build held to the plain version (bit for bit, K14 within
its tolerance, K12 on the rows it writes with NaN by position) and set
beside the shipped build's bits. All nvcc builds start together. Card
only:

    python -m raytracingweekend_tpu_torch.tools.culled_ab \\
        [--cells large,huge,...,cornell,earth,...,twin,k7_book1,k9,k10,...] \\
        [--reps 3] [--parent DIR]... [--split]

One JSON row a measurement on stdout, the card's name and power limit
first, then each build's registers and spills, its slot loops' SASS
(K7's a ray-slot pair) and its surfaces kernels' rect and light loops,
MUFU and loads (`sass.surface_loops`).
"""
from __future__ import annotations

import argparse
import ctypes
import functools
import json
from pathlib import Path

import torch

from raytracingweekend_tpu_torch.models import (builder, probe_scenes,
                                                scene_types)
from raytracingweekend_tpu_torch.models.scenes import make_scene
from raytracingweekend_tpu_torch.ops import _build, geometry
from raytracingweekend_tpu_torch.ops import intersect as k7
from raytracingweekend_tpu_torch.ops import megakernel as mk
from raytracingweekend_tpu_torch.ops.packing import device_scene
from raytracingweekend_tpu_torch.tools import card_line, sass
from raytracingweekend_tpu_torch.tools import dot_microbench as k9
from raytracingweekend_tpu_torch.tools import sweep_twin as k8
from raytracingweekend_tpu_torch.tools.mosaic_repros import (
    repro_dot_k3_subslice as k14, repro_dynamic_cull as k13,
    repro_f32_iota as k10, repro_scalar_reduce as k12,
    repro_slice_broadcast_layout as k11)
from raytracingweekend_tpu_torch.tools.mosaic_repros._common import Entry

NX, NY, DEPTH, SEED = 1200, 800, 50, 20240601
RTWI = str(Path(__file__).resolve().parents[2] / "tools" /
           "reference_oracle" / "earth.rtwi")
# the cells: (scene, its keywords, spp a launch, make_plan keywords)
CELLS = {"large": ("random_balls_large", {}, 32, {}),
         "huge": ("random_balls_huge", {}, 16, {}),
         "mixed60": ("large_mixed", dict(n=60), 32, {}),
         "mixed120": ("large_mixed", dict(n=120), 16, {}),
         "exact": ("random_balls_large", {}, 4, dict(exact=True)),
         "moving": ("large_mixed", dict(n=60, textured=False, moving=True),
                    32, {}),
         "book1": ("random_balls", {}, 32, dict(SB=128)),
         "dense_book1": ("random_balls", {}, 64, {}),
         "dense_shutter": ("shutter", {}, 64, {}),
         "dense_static": ("random_balls_large", {}, 8, dict(cull=False)),
         "dense_exact": ("random_balls", {}, 4, dict(exact=True)),
         "cornell": ("cornell_box", {}, 64, {}),
         "cornell_smoke": ("cornell_smoke", {}, 64, {}),
         "cornell_exact": ("cornell_box", {}, 32,
                           dict(exact=True, T=1024, rr_depth=None)),
         "earth": ("earth", dict(image_path=RTWI), 64, {}),
         "perlin": ("two_perlin_spheres", {}, 64, {}),
         "checker": ("checker_spheres", {}, 64, {}),
         "twin": ("sweep twin", {}, 0, {})}
# the cells' image shapes other than NX x NY, and depths other than DEPTH
# (cornell_exact: the gradient path's tape forward, mega_grad.plan_tape at
# tools/grad_bench.py's workload)
SHAPES = {"cornell": (400, 400), "cornell_smoke": (400, 400),
          "cornell_exact": (128, 128), "earth": (800, 600),
          "perlin": (800, 600), "checker": (800, 600)}
DEPTHS = {"cornell_exact": 8}
# the dense surfaces cells (K2-K4) that --split takes
SURFACE_CELLS = ("cornell", "cornell_smoke", "cornell_exact", "earth",
                 "perlin", "checker")
# K7's cells (their scene) at the wavefront's main shape NX x NY x K7_SPP,
# and the regen launch's seed
K7_CELLS = {"k7_book1": "random_balls", "k7_large": "random_balls_large",
            "k7_huge": "random_balls_huge"}
K7_SPP, K7_SEED, K7_REPS = 8, 2, 20
# K9's cell: the tool's S and T, the slope's N, rows compared after
# K9_CHECK steps
K9_S, K9_T, K9_N, K9_CHECK = 512, 2048, 64, 8
# the Mosaic repros' cells: (module, C entry, its arguments before the
# stream, their ctypes types in a build older than the argument block)
REPRO_CELLS = {"k10": (k10, "rtw_repro_iota_launch", 4, "ipii"),
               "k11": (k11, "rtw_repro_slice_launch", 7, "ipppiii"),
               "k12": (k12, "rtw_repro_scalar_reduce_launch", 4, "ppii"),
               "k13": (k13, "rtw_repro_cull_launch", 6, "ipppii"),
               "k14": (k14, "rtw_repro_dot_k3_launch", 6, "ipppii")}
ALL_CELLS = (*CELLS, *K7_CELLS, "k9", *REPRO_CELLS)
# the instrumented build's defines
SPLIT = ("RTW_SPLIT",)
SPLIT_KEYS = ("total", "keys", "visits", "broadcast", "compacted",
              "candidates", "broadcast_visits", "compacted_visits")
# the dense surfaces kernel's split parts (csrc/megakernel.cu SurfSplit)
SURF_KEYS = ("total", "sweep", "rects", "media", "lambertian", "light_dir",
             "light_pdf", "metal", "dielectric", "emission", "isotropic",
             "noise", "checker", "image", "regen", "barrier")


def cell_inputs(cell: str, nx: int | None = None, ny: int | None = None,
                depth: int | None = None, device: str = "cuda"):
    """(label, launch args, plan) of a megakernel cell at nx x ny (default:
    its shape) and depth (default: its own), its spp a launch."""
    name, kw, spp, plan_kw = CELLS[cell]
    nx = nx or SHAPES.get(cell, (NX, NY))[0]
    ny = ny or SHAPES.get(cell, (NX, NY))[1]
    depth = DEPTHS.get(cell, DEPTH) if depth is None else depth
    if name == "large_mixed":
        scene = probe_scenes.large_mixed_scene(builder, scene_types,
                                               aspect=nx / ny, **kw)
    elif name == "shutter":
        scene = probe_scenes.shutter_scene(builder, scene_types)
    else:
        scene = make_scene(name, nx / ny, **kw)
    _, plan = mk.make_plan(scene, nx, ny, spp, max_depth=depth, **plan_kw)
    label = " ".join([name] + [f"{k}={v}" for k, v in
                               {**kw, **plan_kw}.items()])
    args, _ = mk.device_inputs(scene, plan, device)
    return label, args, plan


def capture_regen_rays(scene, n_iters: int, nx: int = NX, ny: int = NY,
                       spp: int = K7_SPP, depth: int = DEPTH,
                       seed: int = K7_SEED) -> list:
    """The (o, d, time) K7 gets in the first n_iters iterations of a regen
    launch at nx x ny x spp on the card (copies; the launch stops
    there)."""
    from raytracingweekend_tpu_torch.render import render
    from raytracingweekend_tpu_torch.utils.config import RenderConfig
    got = []
    orig = geometry.hit_spheres

    class _Enough(Exception):
        pass

    def record(o, d, time, ds, t_min=geometry.T_MIN):
        got.append((o.clone(), d.clone(), time.clone()))
        if len(got) >= n_iters:
            raise _Enough
        return orig(o, d, time, ds, t_min)

    geometry.hit_spheres = record
    try:
        render(scene, RenderConfig(nx=nx, ny=ny, spp=spp,
                                   samples_per_launch=spp, max_depth=depth,
                                   seed=seed, loop_mode="regen",
                                   device="cuda"))
    except _Enough:
        pass
    finally:
        geometry.hit_spheres = orig
    return got


def bind(lib: ctypes.CDLL) -> ctypes.CDLL:
    """The argtypes of every kernel this tool times on a build: the
    megakernels', K8's, K9's and K7's."""
    return k7.bind(k9.bind(k8.bind(mk.bind(lib))))


def _k7_call(lib, o, d, tm, table, moving, lay):
    """One build's K7 on these rays: a callable returning (best_t,
    best_i)."""
    def call():
        return k7.hit_spheres_kernel(o, d, tm, table, moving, layout=lay,
                                     lib=lib)
    return call


def split_lib() -> ctypes.CDLL:
    """The instrumented build's library, bound (its rtw_split_read
    too)."""
    lib = mk.bind(_build.load(SPLIT))
    lib.rtw_split_read.argtypes = [ctypes.c_void_p]
    lib.rtw_split_read.restype = ctypes.c_int
    return lib


def split(args, plan) -> dict:
    """One launch of the instrumented build: its warp-cycle sums
    (SPLIT_KEYS), the shares of the lane loop's cycles (keys, votes =
    visits - sweeps, broadcast, compacted, rest), the instrumented
    launch's ms and its output."""
    lib = split_lib()
    a = torch.cuda.Event(enable_timing=True)
    b = torch.cuda.Event(enable_timing=True)
    mk.mega_kernel(*args, SEED, plan, lib=lib)        # warm-up
    torch.cuda.synchronize()
    sums = (ctypes.c_ulonglong * len(SPLIT_KEYS))()
    _check(lib.rtw_split_read(sums), lib)             # clear
    a.record()
    out = mk.mega_kernel(*args, SEED, plan, lib=lib)
    b.record()
    torch.cuda.synchronize()
    _check(lib.rtw_split_read(sums), lib)
    raw = dict(zip(SPLIT_KEYS, map(int, sums)))
    tot = max(raw["total"], 1)
    sweeps = raw["broadcast"] + raw["compacted"]
    share = dict(keys=raw["keys"] / tot,
                 votes=(raw["visits"] - sweeps) / tot,
                 broadcast=raw["broadcast"] / tot,
                 compacted=raw["compacted"] / tot,
                 rest=1.0 - (raw["keys"] + raw["visits"]) / tot)
    return dict(raw=raw, share=share, ms=a.elapsed_time(b), out=out)


def split_surfaces(args, plan) -> dict:
    """One overdraw launch of the instrumented build's dense surfaces
    kernel: its lanes' cycle sums (SURF_KEYS), each part's share of the
    lane loop's cycles (the rest: what no part holds), each block's start,
    end and SM (`grid_tail`), the instrumented launch's ms and its
    output."""
    lib = split_lib()
    lib.rtw_split_surfaces_read.argtypes = [ctypes.c_void_p]
    lib.rtw_split_surfaces_read.restype = ctypes.c_int
    lib.rtw_split_blocks.argtypes = [ctypes.c_void_p]
    lib.rtw_split_blocks.restype = ctypes.c_int
    a = torch.cuda.Event(enable_timing=True)
    b = torch.cuda.Event(enable_timing=True)
    blocks = torch.zeros((args[0].shape[0], 3), dtype=torch.int64,
                         device=args[0].device)
    mk.mega_kernel(*args, SEED, plan, lib=lib)        # warm-up
    torch.cuda.synchronize()
    sums = (ctypes.c_ulonglong * len(SURF_KEYS))()
    _check(lib.rtw_split_surfaces_read(sums), lib)    # clear
    _check(lib.rtw_split_blocks(blocks.data_ptr()), lib)
    try:
        a.record()
        out = mk.mega_kernel(*args, SEED, plan, lib=lib)
        b.record()
        torch.cuda.synchronize()
    finally:
        _check(lib.rtw_split_blocks(None), lib)
    _check(lib.rtw_split_surfaces_read(sums), lib)
    raw = dict(zip(SURF_KEYS, map(int, sums)))
    tot = max(raw["total"], 1)
    share = {k: raw[k] / tot for k in SURF_KEYS[1:]}
    share["rest"] = 1.0 - sum(share.values())
    n_sm = torch.cuda.get_device_properties(
        args[0].device).multi_processor_count
    return dict(raw=raw, share=share, ms=a.elapsed_time(b), out=out,
                grid=grid_tail(blocks.cpu().numpy(), n_sm))


def grid_tail(rec, n_sm: int) -> dict:
    """The grid's tail from each block's (start ns, end ns, SM id) `rec`:
    the share of the launch (first start to last end) during which fewer
    than n_sm SMs hold a block, the launch's span, the blocks a launch,
    the most blocks one SM held at once, and the blocks' longest and mean
    durations."""
    import numpy as np
    rec = np.asarray(rec, np.int64)
    t0, t1 = int(rec[:, 0].min()), int(rec[:, 1].max())
    events, most = [], 0
    for sm in np.unique(rec[:, 2]):
        iv = sorted(map(tuple, rec[rec[:, 2] == sm][:, :2].tolist()))
        edges = sorted([(a, 1) for a, _ in iv] + [(b, -1) for _, b in iv],
                       key=lambda e: (e[0], e[1]))
        held = 0
        for _, d in edges:
            held += d
            most = max(most, held)
        lo, hi = iv[0]
        for a, b in iv[1:]:                  # the SM's busy intervals
            if a > hi:
                events += [(lo, 1), (hi, -1)]
                lo = a
            hi = max(hi, b)
        events += [(lo, 1), (hi, -1)]
    events.sort(key=lambda e: (e[0], e[1]))
    busy, prev, under = 0, t0, 0
    for t, d in events:
        if busy < n_sm:
            under += t - prev
        busy += d
        prev = t
    under += t1 - prev
    span = max(t1 - t0, 1)
    dur = rec[:, 1] - rec[:, 0]
    return dict(tail_share=under / span, span_ms=span / 1e6,
                blocks=int(rec.shape[0]), sms=int(np.unique(rec[:, 2]).size),
                most_blocks_an_sm=most, longest_block_ms=int(dur.max()) / 1e6,
                mean_block_ms=float(dur.mean()) / 1e6)


def _check(rc: int, lib) -> None:
    if rc:
        raise RuntimeError(f"rtw_split_read failed: CUDA error {rc} "
                           f"({lib.rtw_error_string(rc).decode()})")


def _timed(fn, reps: int) -> tuple:
    a = torch.cuda.Event(enable_timing=True)
    b = torch.cuda.Event(enable_timing=True)
    fn()
    a.record()
    for _ in range(reps):
        out = fn()
    b.record()
    torch.cuda.synchronize()
    return a.elapsed_time(b) / reps, out


def _same(out, ref, dense: bool) -> bool:
    """Equal on every row (dense) or every row but row 7 (culled: lane
    need, 0 in older kernels)."""
    rows = mk.OUT_ROWS if dense else 7
    return (torch.equal(out[:, :rows], ref[:, :rows])
            and torch.equal(out[:, mk.OUT_ROWS:], ref[:, mk.OUT_ROWS:]))


def build_report(label: str, path: Path) -> dict:
    """One build's megakernel, sweep twin, K7, K9 and K12 instantiations:
    registers, spill and stack bytes (nvcc's ptxas report beside the
    library, when it was built here), their slot loops' SASS
    (sass.slot_loops; K7's a ray-slot pair, sass.k7_loops), the
    surfaces kernels' loops and loads (sass.surface_loops) and K12's
    opcode counts (sass.repro_ops)."""
    log = path.with_name(path.name + ".log")
    regs = sass.registers(log.read_text()) if log.exists() else {}
    mine = ("<", "surfaces<", "culled", "twin<", "k7", "k9",
            "repro:scalar_reduce")
    listing = sass.cuobjdump(str(path))
    return {"build": label,
            "registers": {k: v for k, v in regs.items()
                          if k.startswith(mine)},
            "sweep_sass": sass.slot_loops(listing),
            "k7_sass": sass.k7_loops(listing),
            "surfaces_sass": sass.surface_loops(listing),
            "k12_sass": sass.repro_ops(listing, "scalar_reduce")}


def _twin_rows(libs: dict, reps: int) -> list:
    """The sweep twin's quad variant (K8) at the book-1 launch's width and
    K = k8.DEFAULT_ITERS, each library's in turns, held to the shipped
    build's output bit for bit: one row a library."""
    soa, attr, plan = k8.book1_inputs("cuda")
    G, K = k8.default_grid(plan), k8.DEFAULT_ITERS

    def launch(lib):
        return k8.sweep_twin_kernel(soa, attr, plan.T, G, K, plan.ut_t0,
                                    plan.ut_idt, False, lib=lib)[0]

    ref = launch(libs["shipped"])
    times = {k: [] for k in libs}
    for k in [*libs, *reversed(libs)]:
        ms, out = _timed(lambda: launch(libs[k]), reps)
        times[k].append(ms)
        if not torch.equal(out, ref):
            raise RuntimeError(f"the {k} build's sweep twin differs from "
                               "the kernels'")
    return [dict(cell="twin", scene="sweep twin",
                 shape=f"S={soa.shape[1]}, T={plan.T}, G={G}, K={K}",
                 iters_done=ref[0, 1, 0].item(), build=k,
                 ms=sum(t) / len(t), turns=t) for k, t in times.items()]


def _k7_rows(cell: str, libs: dict) -> list:
    """K7 on the first regen iteration's rays of the cell's scene, every
    build in turns (K7_REPS calls a turn), held to the shipped build bit
    for bit: one row a build."""
    scene = make_scene(K7_CELLS[cell], NX / NY)
    o, d, tm = capture_regen_rays(scene, 1)[0]
    ds = device_scene(scene, "cuda")
    table, lay = ds.sphere_table, ds.sphere_layout
    moving = scene.has_moving_spheres
    calls = {k: _k7_call(lib, o, d, tm, table, moving, lay)
             for k, lib in libs.items()}
    ref_t, ref_i = calls["shipped"]()
    times = {k: [] for k in libs}
    for k in [*libs, *reversed(libs)]:
        times[k].append(_timed(calls[k], K7_REPS)[0])
        got_t, got_i = calls[k]()
        if not (torch.equal(got_t, ref_t) and torch.equal(got_i, ref_i)):
            raise RuntimeError(f"the {k} build's K7 differs from the "
                               f"shipped build's on {K7_CELLS[cell]}")
    return [dict(cell=cell, kernel="K7", scene=K7_CELLS[cell],
                 N=o.shape[0], S=table.shape[0],
                 form=f"k7<{lay.axes},{int(lay.uniform)}>", build=k,
                 ms=sum(t) / len(t), turns=t, bitwise_equal=True)
            for k, t in times.items()]


def _k9_rows(libs: dict, reps: int) -> list:
    """K9's nine rows, µs a step by the tool's slope (`reps` launches a
    point), every build in turns; rows 0-7 after K9_CHECK steps beside the
    shipped build's."""
    tables = k9.make_tables(K9_S)
    rows = []
    for name, body, unit in k9.ROWS:
        tab = k9.table_for(body, unit, tables, "cuda")
        calls = {k: functools.partial(k9.microbench_kernel, body, unit, tab,
                                      K9_S, K9_T, lib=lib)
                 for k, lib in libs.items()}
        ref = calls["shipped"](K9_CHECK)
        times = {k: [] for k in libs}
        for k in [*libs, *reversed(libs)]:
            times[k].append(k9._slope_us(calls[k], K9_N, reps, "cuda"))
        for k, t in times.items():
            got = calls[k](K9_CHECK)
            rows.append(dict(cell="k9", kernel="K9", name=name,
                             h100_unit=unit, S=K9_S, T=K9_T, build=k,
                             us_per_iter=sum(t) / len(t), turns=t,
                             bound_us_per_iter=k9.bound_us(body, unit, K9_S,
                                                           K9_T),
                             equal_to_shipped=torch.equal(got, ref),
                             max_abs_diff=(got - ref).abs().max().item()))
    return rows


def _repro_launcher(lib, name: str, slots: int, old: str):
    """A build's launch of a repro entry on the current stream: f(*args).
    A build older than the argument block (no `rtw_repro_empty_launch`)
    takes the arguments positionally, typed by `old` (i int, p pointer)."""
    if hasattr(lib, "rtw_repro_empty_launch"):
        entry = Entry(name, name, slots, {"a/b": 0}, lib=lambda: lib)
        return lambda *a: entry.launch("a/b", torch.cuda.current_device(), *a)
    fn = getattr(lib, name)
    fn.argtypes = [{"i": ctypes.c_int, "p": ctypes.c_void_p}[c]
                   for c in old] + [ctypes.c_void_p]
    fn.restype = ctypes.c_int

    def call(*a):
        _check(fn(*a, torch.cuda.current_stream().cuda_stream), lib)
    return call


def _profiled_us(fn, reps: int, kernel: str) -> float:
    """Device µs a launch of the kernels named `kernel` in `reps` calls of
    fn() under torch.profiler (CUDA activity)."""
    from torch.profiler import ProfilerActivity, profile
    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(reps):
            fn()
        torch.cuda.synchronize()
    evs = [e for e in prof.key_averages() if kernel in e.key]
    dev = sum(getattr(e, "self_device_time_total",
                      getattr(e, "self_cuda_time_total", 0.0)) for e in evs)
    n = sum(e.count for e in evs)
    if not n or dev <= 0:
        raise RuntimeError(f"the profiler saw no device time of {kernel}")
    return dev / n


def repro_forms(cell: str, device: str = "cuda") -> list:
    """The forms of a repro cell on its repro's inputs on `device` (K11,
    K14 seed 0; K13 the repro's scalars and tables): one (name, kernel
    name, output (shape, dtype), the entry's arguments before the output's
    address (tensors stand for their addresses), those after it, plain
    output, tolerance) a form. K12's plain output is rows 0..2, the rows
    its kernel writes."""
    mod = REPRO_CELLS[cell][0]
    f32 = torch.float32
    if cell == "k10":
        want = mod.iota_reference(mod.ROWS, mod.T, device)
        return [(name, f"repro_{k}_kernel", ((mod.ROWS, mod.T), f32),
                 (form,), (mod.ROWS, mod.T), want, 0.0)
                for form, (name, k) in enumerate(zip(
                    mod.FORMS, ("iota_f32", "iota_int_cast")))]
    if cell == "k11":
        row, col = mod.inputs(0, device)
        want = mod.slice_reference(row, col)
        return [(name, "repro_slice_kernel", ((mod.SB, mod.T), f32),
                 (form, row, col), (mod.SB, mod.T, mod.W), want, 0.0)
                for form, name in enumerate(mod.FORMS)]
    if cell == "k12":
        x = mod.repro_input(device)
        want = mod.scalar_reduce_reference(x)[:mod.OUT_ROWS]
        return [(mod.FORMS[0], "repro_scalar_reduce_kernel",
                 ((mod.R, mod.C), f32), (x,), (mod.R * mod.C, mod.C), want,
                 0.0)]
    if cell == "k13":
        a = mod.inputs(mod.SCALARS, device)
        forms = []
        for probe, (name, (_, _, table)) in enumerate(zip(mod.FORMS,
                                                          mod.PROBES)):
            t = a[table]
            out = (((8,), torch.int32) if probe == 3 else
                   ((t.shape[0], mod.LANES) if probe == 1 else
                    (8, t.shape[1]), f32))
            forms.append((name, f"repro_cull_{'abcd'[probe]}_kernel", out,
                          (probe, 0 if probe == 3 else a["s"], t),
                          tuple(t.shape), mod.reference(probe, a), 0))
        return forms
    tab, rays = mod.inputs(0, device)
    want, tol = mod.subslice_reference(tab, rays), mod.tolerance(tab, rays)
    return [(name, "repro_dot_k3_kernel", ((mod.S, mod.T), f32),
             (form, lhs, rays), (mod.S, mod.T), want, tol)
            for form, (name, lhs) in enumerate(zip(
                mod.FORMS, (tab, tab[:, 0:mod.K].contiguous())))]


def _repro_rows(cell: str, libs: dict, reps: int) -> list:
    """The repro's forms (K10-K14; `repro_forms`), every build in turns,
    device µs a launch by torch.profiler (`reps` launches a turn), the
    launch floor (the shipped build's empty kernel) profiled in the same
    turns; each build's output held to the plain version (bit for bit,
    K14 within its tolerance; K12 on rows 0..2, NaN by position) and set
    beside the shipped build's: one row a build and form. The k12 cell
    also profiles torch.aminmax on its x in the same turns (the reduction
    alone: no loop, no stores), `aminmax_device_us` on its rows (over the
    turns whose session recorded its kernel)."""
    _, name, slots, old = REPRO_CELLS[cell]
    forms = repro_forms(cell)
    calls = {k: _repro_launcher(lib, name, slots, old)
             for k, lib in libs.items()}
    floor = Entry("the empty kernel", "rtw_repro_empty_launch", 0,
                  {"floor": 0}, lib=lambda: libs["shipped"])
    floor_us, aminmax_us = [], []
    rows = []
    for form_name, kname, (shape, dtype), head, tail, want, tol in forms:
        outs = {k: torch.empty(shape, dtype=dtype, device="cuda")
                for k in libs}
        ptrs = [x.data_ptr() if torch.is_tensor(x) else x for x in head]
        args = {k: (*ptrs, outs[k].data_ptr(), *tail) for k in libs}
        times = {k: [] for k in libs}
        for k in [*libs, *reversed(libs)]:
            times[k].append(_profiled_us(lambda: calls[k](*args[k]), reps,
                                         kname))
            floor_us.append(_profiled_us(lambda: floor.launch("floor", 0),
                                         reps, "repro_empty_kernel"))
            if cell == "k12":
                try:
                    aminmax_us.append(_profiled_us(
                        lambda: torch.aminmax(head[0]), reps,
                        "reduce_kernel"))
                except RuntimeError:        # the profiler saw no kernel
                    pass
        torch.cuda.synchronize()
        outs = {k: out[:want.shape[0]] for k, out in outs.items()}
        ref = outs["shipped"]
        same = k12.rows_equal if cell == "k12" else torch.equal
        for k, out in outs.items():
            agree = (same(out, want) if cell == "k12"
                     else bool(torch.all((out - want).abs() <= tol)))
            if not agree:
                raise RuntimeError(f"the {k} build's {cell} {form_name} "
                                   "disagrees with its plain version")
        for k, t in times.items():
            rows.append(dict(cell=cell, kernel=cell.upper(), form=form_name,
                             build=k, device_us=sum(t) / len(t), turns=t,
                             equal_to_shipped=same(outs[k], ref),
                             max_abs_diff=(outs[k] - ref).abs().max().item()))
    for r in rows:
        r["floor_device_us"] = sum(floor_us) / len(floor_us)
        r["floor_turns"] = floor_us
        if aminmax_us:
            r["aminmax_device_us"] = sum(aminmax_us) / len(aminmax_us)
            r["aminmax_turns"] = aminmax_us
    return rows


def run(cells=ALL_CELLS, reps: int = 3, parents=(),
        with_split: bool = False) -> list:
    """Build, then time the shipped kernels (and each parent's, labelled
    by its directory's name) on each cell in turns; returns the rows (also
    printed)."""
    if not torch.cuda.is_available():
        raise RuntimeError("culled_ab measures on the card: no CUDA device")
    pdirs = {Path(d).resolve().name:
             Path(d).resolve() / "raytracingweekend_tpu_torch" / "csrc"
             for d in parents}
    builds = [((), _build.CSRC), *(((), d) for d in pdirs.values())]
    if with_split:
        builds.append((SPLIT, _build.CSRC))
    done = _build.build_all(builds)
    print(json.dumps({"card": card_line("cuda"),
                      "build_s": max(s for _, s in done)}), flush=True)
    for k, (path, _) in zip(["shipped", *pdirs], done):
        print(json.dumps(build_report(k, path)), flush=True)
    libs = {"shipped": bind(mk._kernel_lib())}
    for k, d in pdirs.items():
        libs[k] = bind(_build.load((), d))
    rows = []
    for cell in cells:
        if cell in ("twin", "k9", *K7_CELLS, *REPRO_CELLS):
            got = (_twin_rows(libs, reps) if cell == "twin" else
                   _k9_rows(libs, reps) if cell == "k9" else
                   _repro_rows(cell, libs, reps) if cell in REPRO_CELLS
                   else _k7_rows(cell, libs))
            for row in got:
                rows.append(row)
                print(json.dumps(row), flush=True)
            continue
        name, args, plan = cell_inputs(cell)
        ref = mk.mega_kernel(*args, SEED, plan)
        times = {k: [] for k in libs}
        for k in [*libs, *reversed(libs)]:
            ms, out = _timed(lambda: mk.mega_kernel(*args, SEED, plan,
                                                    lib=libs[k]), reps)
            times[k].append(ms)
            if not _same(out, ref, not plan.cull):
                raise RuntimeError(f"the {k} build differs from the "
                                   f"kernels' on {name}")
        iters = ref[:, 4].sum().item() * plan.C
        base = dict(cell=cell, scene=name,
                    shape=f"{plan.nx}x{plan.ny}x{plan.spp}",
                    exact=plan.exact, cull=plan.cull,
                    axes=mk.sweep_axes(plan),
        moving=plan.moving, C=plan.C, SB=plan.SB,
                    dyn_order=plan.dyn_order,
                    segments=ref[:, 3].sum().item(),
                    warp_survival=ref[:, 6].sum().item() / iters,
                    lane_survival=ref[:, 7].sum().item() / iters)
        for k in libs:
            row = dict(base, build=k, ms=sum(times[k]) / len(times[k]),
                       turns=times[k])
            rows.append(row)
            print(json.dumps(row), flush=True)
        if with_split and cell in SURFACE_CELLS and not plan.exact:
            s = split_surfaces(args, plan)
            if not torch.equal(s["out"], ref):
                raise RuntimeError(f"the split build differs on {name}")
            row = dict(base, build="split", instrumented_ms=s["ms"],
                       share=s["share"], grid=s["grid"], raw=s["raw"])
            rows.append(row)
            print(json.dumps(row), flush=True)
        if with_split and plan.cull:
            s = split(args, plan)
            if not torch.equal(s["out"][:, :mk.OUT_ROWS],
                               ref[:, :mk.OUT_ROWS]):
                raise RuntimeError(f"the split build differs on {name}")
            row = dict(base, build="split", instrumented_ms=s["ms"],
                       share=s["share"], raw=s["raw"])
            rows.append(row)
            print(json.dumps(row), flush=True)
    return rows


def main(argv=None) -> None:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--cells", default=",".join(ALL_CELLS),
                   help=f"comma-separated of {', '.join(ALL_CELLS)}")
    p.add_argument("--reps", type=int, default=3,
                   help="timed launches a turn (K7: K7_REPS calls; K9: "
                        "launches a point of its slope)")
    p.add_argument("--parent", action="append", default=[],
                   help="another checkout whose kernels to time too "
                        "(repeatable)")
    p.add_argument("--split", action="store_true",
                   help="take each culled cell's warp-cycle split and each "
                        "dense surfaces cell's cycle split and grid tail")
    a = p.parse_args(argv)
    cells = tuple(c for c in a.cells.split(",") if c)
    bad = [c for c in cells if c not in ALL_CELLS]
    if bad:
        p.error(f"unknown cells {bad}")
    run(cells, a.reps, a.parent, a.split)


if __name__ == "__main__":
    main()
