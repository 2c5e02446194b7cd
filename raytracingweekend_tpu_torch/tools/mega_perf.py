"""Megakernel throughput on one scene: path segments a second.

The port of tools/mega_perf.py. Two warm-up launches (seeds
`render.launch_seed(0, 900 + w)`, the JAX tool's `fold_in(key(0),
900 + w)` draws), then `--launches` timed ones (`launch_seed(0, i)`),
each ending in one host read of its segment count; the rate is the summed
segments over the summed host seconds.

    python -m raytracingweekend_tpu_torch.tools.mega_perf
        [--scene cornell_box --nx 400 --ny 400 --spp 256 --max-depth 50]
        [--launches 2] [--T 0] [--SB 0] [--cull -1] [--dord -1]
        [--bv -1] [--sg 0] [--unroll 0] [--k 1] [--coherent 0] [--stats]
        [--device cuda|cpu]

`--T`, `--SB`, `--cull` and `--dord` are make_plan's (0 / -1 = auto), and
so are the layout and culling modes: `--bv` batched votes (1 / 0, -1 =
auto: off), `--sg` clusters a super-group of the two-level vote (0 =
off), `--unroll` bounce iterations between a tile's checks (0 = auto:
1), `--k` lanes a pixel (slots_per_pixel) and `--coherent` 1 for the
cluster-binned pixel layout. `--stats` adds, from the launches' own
counters (read after the timed window): util = segments / lane
iterations, the warp survival blocks / (lane iterations x C) and the
per-lane survival lane_need / (lane iterations x C) (1 and 1 on a dense
plan). The JAX tool's `--chunks` (vote chunks of at least 128 lanes:
the port's votes are a warp's 32 lanes, finer than any chunk), `--idx`,
`--eb` and `--fe` (one-hot extraction on the TPU's matrix unit: the port
gathers the winner's attributes) and `--dyn` (the survivor-list sweep,
which differs from the interleaved votes only in the visit order that
`--dord` sets) are TPU plan knobs with no counterpart in the port's
kernels.

It prints one line and one JSON row (the last line: the JAX tool's fields,
the plan's T, SB, C, cull and dyn_order, the modes that are on (k,
coherent, sg, batch_votes, unroll), and the card's name and power limit
under "device"). On the CPU (`--device cpu`, the plain version) keep the
shape tiny.
"""
from __future__ import annotations

import argparse
import json
import sys
import time

from . import card_line, tool_scene
from ..ops import megakernel as mk
from ..render import launch_seed


def plan_kw(T: int = 0, SB: int = 0, cull: int = -1, dord: int = -1,
            bv: int = -1, sg: int = 0, unroll: int = 0, k: int = 1,
            coherent: int = 0) -> dict:
    """make_plan's keywords from the CLI's integers (0 / -1 = auto); the
    modes only where one is asked for."""
    kw = dict(T=T or None, SB=SB or None,
              cull=None if cull < 0 else bool(cull),
              dyn_order=None if dord < 0 else dord)
    for key, val, off in (("batch_votes", None if bv < 0 else bool(bv),
                           None), ("super_group", sg, 0),
                          ("unroll", unroll or None, None),
                          ("slots_per_pixel", k, 1),
                          ("coherent", bool(coherent), False)):
        if val != off:
            kw[key] = val
    return kw


# the plan's layout and culling modes and their defaults
MODES = (("k", 1), ("coherent", False), ("sg", 0), ("batch_votes", False),
         ("unroll", 1))


def plan_modes(plan) -> dict:
    """The plan's modes that are not at their default."""
    return {key: getattr(plan, key) for key, off in MODES
            if getattr(plan, key) != off}


def launch_series(scene, nx: int, ny: int, spp: int, max_depth: int,
                  launches: int, device, **kw) -> dict:
    """Two warm-up launches, then `launches` timed ones through
    trace_mega (plan keywords `kw`), each timed on the host clock up to
    the host read of its segment count. Returns the warm-up seconds, each
    timed launch's seconds and segments, the summed lane iterations,
    swept blocks and needed blocks (read after the timed window), and the
    plan."""
    def launch(seed):
        return mk.trace_mega(seed, scene, nx, ny, spp, max_depth=max_depth,
                             device=device, **kw)

    t0 = time.perf_counter()
    for w in range(2):
        float(launch(launch_seed(0, 900 + w)).segments)
    warm_s = time.perf_counter() - t0
    seconds, segments, counters = [], [], []
    for i in range(launches):
        t0 = time.perf_counter()
        res = launch(launch_seed(0, i))
        segments.append(float(res.segments))   # one host read: the sync
        seconds.append(time.perf_counter() - t0)
        counters.append((res.lane_iters, res.blocks, res.lane_need))
    _, plan = mk.make_plan(scene, nx, ny, spp, max_depth=max_depth, **kw)
    iters, blocks, need = (sum(float(c[k]) for c in counters)
                           for k in range(3))
    return dict(warm_s=warm_s, seconds=seconds, segments=segments,
                lane_iters=iters, blocks=blocks, lane_need=need, plan=plan)


def rates(series: dict) -> dict:
    """The series' M segments a second, util, warp and per-lane survival,
    and the plan's fields."""
    plan = series["plan"]
    total, dt = sum(series["segments"]), sum(series["seconds"])
    iters = max(series["lane_iters"], 1.0)
    return dict(T=plan.T, SB=plan.SB, C=plan.C, cull=plan.cull,
                dyn_order=plan.dyn_order, **plan_modes(plan), segments=total,
                m_seg_per_s=total / dt / 1e6, util=total / iters,
                cull_survival=series["blocks"] / (iters * plan.C),
                lane_survival=series["lane_need"] / (iters * plan.C))


def run(scene_name: str, nx: int, ny: int, spp: int, max_depth: int,
        launches: int, kw: dict, stats: bool, device) -> dict:
    """The tool's row (see the module docstring)."""
    card = card_line(device)
    scene = tool_scene(scene_name, nx / ny)
    series = launch_series(scene, nx, ny, spp, max_depth, launches, device,
                           **kw)
    r = rates(series)
    row = dict(scene=scene_name, nx=nx, ny=ny, spp=spp, max_depth=max_depth,
               launches=launches, seconds=sum(series["seconds"]), **r)
    if not stats:
        for k in ("util", "cull_survival", "lane_survival"):
            del row[k]
    row["device"] = card
    extra = (f" util={r['util']:.3f} cull_survival={r['cull_survival']:.3f}"
             f" lane_survival={r['lane_survival']:.3f}" if stats else "")
    modes = "".join(f" {key}={int(r[key])}" for key, _ in MODES if key in r)
    print(f"{scene_name} {nx}x{ny}@{spp}spp T={r['T']} SB={r['SB']} "
          f"C={r['C']} cull={int(r['cull'])} dord={r['dyn_order']}{modes}: "
          f"{r['segments'] / 1e6:.1f}M segments in {row['seconds']:.3f}s = "
          f"{r['m_seg_per_s']:.1f} M segments/s{extra}", flush=True)
    return row


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--scene", default="cornell_box")
    ap.add_argument("--nx", type=int, default=400)
    ap.add_argument("--ny", type=int, default=400)
    ap.add_argument("--spp", type=int, default=256)
    ap.add_argument("--max-depth", type=int, default=50)
    ap.add_argument("--launches", type=int, default=2)
    ap.add_argument("--T", type=int, default=0, help="tile width (0 = auto)")
    ap.add_argument("--SB", type=int, default=0,
                    help="sphere cluster size (0 = auto)")
    ap.add_argument("--cull", type=int, default=-1,
                    help="1 / 0: culled / dense sweep (-1 = auto)")
    ap.add_argument("--dord", type=int, default=-1,
                    help="near-to-far visit order buckets (0 = ascending "
                         "cluster id, -1 = auto)")
    ap.add_argument("--bv", type=int, default=-1,
                    help="1 / 0: batched cluster votes (-1 = auto: off)")
    ap.add_argument("--sg", type=int, default=0,
                    help="clusters a super-group of the two-level vote "
                         "(0 = off)")
    ap.add_argument("--unroll", type=int, default=0,
                    help="bounce iterations between a tile's checks "
                         "(0 = auto: 1)")
    ap.add_argument("--k", type=int, default=1,
                    help="lanes a pixel (slots_per_pixel)")
    ap.add_argument("--coherent", type=int, default=0,
                    help="1: the cluster-binned pixel layout")
    ap.add_argument("--stats", action="store_true",
                    help="also report utilisation and survival")
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    row = run(args.scene, args.nx, args.ny, args.spp, args.max_depth,
              args.launches, plan_kw(args.T, args.SB, args.cull, args.dord,
                                     args.bv, args.sg, args.unroll, args.k,
                                     args.coherent),
              args.stats, args.device)
    print(json.dumps(row), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
