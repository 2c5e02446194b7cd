"""The culled sweep's kernels (K5, K5s) on the card against another
checkout's, and the split of their warps' cycles.

Times the shipped culled kernel with CUDA events on each cell at its
path's launch shape and, with `--parent DIR`, another checkout's
`csrc/megakernel.cu` (one with the same C entry point, such as the parent
commit unpacked by `git archive`, built alone into a library of its own)
in turns (shipped, parent, parent, shipped), held to the shipped kernel on
every output row but row 7 (an older kernel writes 0 there). `--split`
launches each cell once more on the build instrumented with clock64
(-DRTW_SPLIT) and prints the shares of its warps' cycles: the key pass
and buckets, the votes, the broadcast and the compacted sweeps, and the
rest (shading, RNG, tile tails). Cells: the four large-S cells of
chip_smoke.py, random_balls_large in exact mode (the gradient path's
mode: clusters visited in ascending id), large_mixed with moving balls,
and book 1's random_balls cut into C = 4 clusters (moving, ascending id).
All nvcc builds start together. Card only:

    python -m raytracingweekend_tpu_torch.tools.culled_ab \\
        [--cells large,huge,mixed60,mixed120,exact,moving,book1] \\
        [--reps 3] [--parent DIR] [--split]

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
from raytracingweekend_tpu_torch.tools import card_line

NX, NY, DEPTH, SEED = 1200, 800, 50, 20240601
# the cells: (scene, its keywords, spp a launch, make_plan keywords)
CELLS = {"large": ("random_balls_large", {}, 32, {}),
         "huge": ("random_balls_huge", {}, 16, {}),
         "mixed60": ("large_mixed", dict(n=60), 32, {}),
         "mixed120": ("large_mixed", dict(n=120), 16, {}),
         "exact": ("random_balls_large", {}, 4, dict(exact=True)),
         "moving": ("large_mixed", dict(n=60, textured=False, moving=True),
                    32, {}),
         "book1": ("random_balls", {}, 32, dict(SB=128))}
# the instrumented build's defines
SPLIT = ("RTW_SPLIT",)
SPLIT_KEYS = ("total", "keys", "visits", "broadcast", "compacted",
              "candidates", "broadcast_visits", "compacted_visits")


def cell_inputs(cell: str, nx: int = NX, ny: int = NY, depth: int = DEPTH,
                device: str = "cuda"):
    """(label, launch args, plan) of a cell at nx x ny, its spp a
    launch."""
    name, kw, spp, plan_kw = CELLS[cell]
    if name == "large_mixed":
        scene = probe_scenes.large_mixed_scene(builder, scene_types,
                                               aspect=nx / ny, **kw)
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


def _same(out, ref) -> bool:
    """Equal on every row but row 7 (lane need, 0 in older kernels)."""
    return (torch.equal(out[:, :7], ref[:, :7])
            and torch.equal(out[:, mk.OUT_ROWS:], ref[:, mk.OUT_ROWS:]))


def run(cells=tuple(CELLS), reps: int = 3, parent: str | None = None,
        with_split: bool = False) -> list:
    """Build, then time the shipped kernel (and the parent's) on each cell
    in turns; returns the rows (also printed)."""
    if not torch.cuda.is_available():
        raise RuntimeError("culled_ab measures on the card: no CUDA device")
    builds = [((), _build.CSRC)]
    if parent is not None:
        pdir = Path(parent).resolve() / "raytracingweekend_tpu_torch" / "csrc"
        builds.append(((), pdir))
    if with_split:
        builds.append((SPLIT, _build.CSRC))
    done = _build.build_all(builds)
    print(json.dumps({"card": card_line("cuda"),
                      "build_s": max(s for _, s in done)}), flush=True)
    libs = {"shipped": mk._kernel_lib()}
    if parent is not None:
        libs["parent"] = mk.bind(_build.load((), pdir))
    rows = []
    for cell in cells:
        name, args, plan = cell_inputs(cell)
        ref = mk.mega_kernel(*args, SEED, plan)
        times = {k: [] for k in libs}
        for k in [*libs, *reversed(libs)]:
            ms, out = _timed(lambda: mk.mega_kernel(*args, SEED, plan,
                                                    lib=libs[k]), reps)
            times[k].append(ms)
            if not _same(out, ref):
                raise RuntimeError(f"the {k} build differs from the "
                                   f"kernels' on {name}")
        iters = ref[:, 4].sum().item() * plan.C
        base = dict(cell=cell, scene=name,
                    shape=f"{NX}x{NY}x{plan.spp}", exact=plan.exact,
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
        if with_split:
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
    p.add_argument("--parent", default=None,
                   help="another checkout whose culled kernels to time too")
    p.add_argument("--split", action="store_true",
                   help="take each cell's warp-cycle split")
    a = p.parse_args(argv)
    cells = tuple(c for c in a.cells.split(",") if c)
    bad = [c for c in cells if c not in CELLS]
    if bad:
        p.error(f"unknown cells {bad}")
    run(cells, a.reps, a.parent, a.split)


if __name__ == "__main__":
    main()
