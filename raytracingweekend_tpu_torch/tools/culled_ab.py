"""The megakernel's sweeps (dense: K1-K4 and the twin K8; culled: K5, K5s)
on the card against other checkouts', and the split of the culled
kernels' warps' cycles.

Times the shipped kernels with CUDA events on each cell at its path's
launch shape and, with `--parent DIR` (repeatable), other checkouts'
`csrc/megakernel.cu` and `csrc/sweep_twin.cu` (ones with the same C entry
points, such as the parent commit unpacked by `git archive`, built alone
into a library of their own) in turns (shipped, parents, parents in
reverse, shipped), held to the shipped kernel bit for bit: a dense cell
on every output row and tape row, a culled cell on every row but row 7
(an older kernel writes 0 there), the twin on its rows. `--split`
launches each culled cell once more on the build instrumented with
clock64 (-DRTW_SPLIT) and prints the shares of its warps' cycles: the
key pass and buckets, the votes, the broadcast and the compacted sweeps,
and the rest (shading, RNG, tile tails). Culled cells: the four large-S
cells of chip_smoke.py, random_balls_large in exact mode (the gradient
path's mode: clusters visited in ascending id), large_mixed with moving
balls, and book 1's random_balls cut into C = 4 clusters (moving,
ascending id). Dense cells: book 1 (random_balls 1200x800x64, K1's
y-only slot loop), the probe `shutter` (per-slot shutters, the all-axes
loop), a static sphere scene (random_balls_large swept densely,
1200x800x8), book 1 in exact mode (1200x800x4), cornell_box 400x400x64
(K2+K3), earth 800x600x64 on earth.rtwi (K4), and the sweep twin at
K = 200 (K8). All nvcc builds start together. Card only:

    python -m raytracingweekend_tpu_torch.tools.culled_ab \\
        [--cells large,huge,...,twin] [--reps 3] [--parent DIR]... \\
        [--split]

One JSON row a measurement on stdout, the card's name and power limit
first.
"""
from __future__ import annotations

import argparse
import ctypes
import json
from pathlib import Path

import torch

from raytracingweekend_tpu_torch.models import (builder, probe_scenes,
                                                scene_types)
from raytracingweekend_tpu_torch.models.scenes import make_scene
from raytracingweekend_tpu_torch.ops import _build
from raytracingweekend_tpu_torch.ops import megakernel as mk
from raytracingweekend_tpu_torch.tools import card_line, sass
from raytracingweekend_tpu_torch.tools import sweep_twin as k8

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
         "earth": ("earth", dict(image_path=RTWI), 64, {}),
         "twin": ("sweep twin", {}, 0, {})}
# the cells' image shapes other than NX x NY
SHAPES = {"cornell": (400, 400), "earth": (800, 600)}
# the instrumented build's defines
SPLIT = ("RTW_SPLIT",)
SPLIT_KEYS = ("total", "keys", "visits", "broadcast", "compacted",
              "candidates", "broadcast_visits", "compacted_visits")


def cell_inputs(cell: str, nx: int | None = None, ny: int | None = None,
                depth: int = DEPTH, device: str = "cuda"):
    """(label, launch args, plan) of a megakernel cell at nx x ny (default:
    its shape), its spp a launch."""
    name, kw, spp, plan_kw = CELLS[cell]
    nx = nx or SHAPES.get(cell, (NX, NY))[0]
    ny = ny or SHAPES.get(cell, (NX, NY))[1]
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
    """One build's megakernel and sweep twin instantiations: registers,
    spill and stack bytes (nvcc's ptxas report beside the library, when it
    was built here) and their slot loops' SASS (sass.sweep_sass)."""
    log = path.with_name(path.name + ".log")
    regs = sass.registers(log.read_text()) if log.exists() else {}
    mine = ("<", "surfaces<", "culled", "twin<")
    return {"build": label,
            "registers": {k: v for k, v in regs.items()
                          if k.startswith(mine)},
            "sweep_sass": sass.sweep_sass(str(path))}


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


def run(cells=tuple(CELLS), reps: int = 3, parents=(),
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
    libs = {"shipped": k8.bind(mk._kernel_lib())}
    for k, d in pdirs.items():
        libs[k] = k8.bind(mk.bind(_build.load((), d)))
    rows = []
    for cell in cells:
        if cell == "twin":
            for row in _twin_rows(libs, reps):
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
    p.add_argument("--cells", default=",".join(CELLS),
                   help=f"comma-separated of {', '.join(CELLS)}")
    p.add_argument("--reps", type=int, default=3,
                   help="timed launches a turn")
    p.add_argument("--parent", action="append", default=[],
                   help="another checkout whose kernels to time too "
                        "(repeatable)")
    p.add_argument("--split", action="store_true",
                   help="take each culled cell's warp-cycle split")
    a = p.parse_args(argv)
    cells = tuple(c for c in a.cells.split(",") if c)
    bad = [c for c in cells if c not in CELLS]
    if bad:
        p.error(f"unknown cells {bad}")
    run(cells, a.reps, a.parent, a.split)


if __name__ == "__main__":
    main()
