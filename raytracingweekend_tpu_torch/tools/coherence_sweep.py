"""Block-linear against the cluster-binned pixel layout, in turns.

The port of tools/coherence_sweep.py. On each large-S scene the
megakernel renders with the block-linear pixel layout and with the
layout binned by the first cluster each pixel's central primary ray
enters (`make_plan(coherent=True)`, ops/megakernel.py
_coherent_pixel_layout), in turns (block-linear, binned, binned,
block-linear): each turn is mega_perf's series (two warm-ups, then
`--launches` timed launches, a host read of the segments each). A row a
turn gives M segments a second, the warp survival blocks / (lane
iterations x C), the per-lane survival lane_need / (lane iterations x C)
and the utilisation segments / lane iterations: whether binning moves
the survival the warp votes see, and whether it pays for a longer tile
tail. Scenes: random_balls_large (32 spp a launch) and random_balls_huge
(16), kernel K5, and large_mixed n = 60 (32), kernel K5s, at 1200x800,
depth 50.

    python -m raytracingweekend_tpu_torch.tools.coherence_sweep
        [--scenes random_balls_large,random_balls_huge,large_mixed]
        [--nx 1200 --ny 800 --spp 0 --max-depth 50] [--launches 3]
        [--json rows.jsonl] [--device cuda|cpu]

`--spp 0` takes each scene's spp above. It prints one line and one JSON
row a turn (the card's name and power limit under "device"); `--json`
appends the rows to a file, and it writes nothing else. On the CPU
(`--device cpu`, the plain version) keep the shape tiny.
"""
from __future__ import annotations

import argparse
import json
import sys

from . import card_line, pick, tool_scene
from .mega_perf import launch_series, rates

SCENES = {"random_balls_large": 32, "random_balls_huge": 16,
          "large_mixed": 32}
# the layouts of one scene's turns: block-linear, binned, binned,
# block-linear
TURNS = (False, True, True, False)


def run(scenes, nx: int, ny: int, spp: int, max_depth: int, launches: int,
        device) -> list:
    """One row a (scene, turn) (see the module docstring)."""
    card = card_line(device)
    rows = []
    for name in scenes:
        scene = tool_scene(name, nx / ny)
        n = spp or SCENES[name]
        for turn, coherent in enumerate(TURNS):
            series = launch_series(scene, nx, ny, n, max_depth, launches,
                                   device, coherent=coherent)
            r = rates(series)
            row = dict(scene=name, coherent=coherent, turn=turn, nx=nx,
                       ny=ny, spp=n, max_depth=max_depth, launches=launches,
                       T=r["T"], SB=r["SB"], C=r["C"],
                       dyn_order=r["dyn_order"], segments=r["segments"],
                       m_seg_per_s=r["m_seg_per_s"],
                       warp_survival=r["cull_survival"],
                       lane_survival=r["lane_survival"], util=r["util"],
                       device=card)
            print(f"{name} {nx}x{ny}@{n}spp "
                  f"{'binned' if coherent else 'block-linear':<12s} "
                  f"turn {turn}: {row['m_seg_per_s']:10.3f} M seg/s  "
                  f"warp_survival={row['warp_survival']:.4f} "
                  f"lane_survival={row['lane_survival']:.4f} "
                  f"util={row['util']:.3f}", flush=True)
            rows.append(row)
    return rows


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--scenes", default=",".join(SCENES))
    ap.add_argument("--nx", type=int, default=1200)
    ap.add_argument("--ny", type=int, default=800)
    ap.add_argument("--spp", type=int, default=0,
                    help="samples a launch (0 = the scene's: large 32, huge "
                         "16, large_mixed 32)")
    ap.add_argument("--max-depth", type=int, default=50)
    ap.add_argument("--launches", type=int, default=3)
    ap.add_argument("--json", default="",
                    help="append one JSON row a turn here")
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    scenes = pick(args.scenes, list(SCENES))
    rows = run(scenes, args.nx, args.ny, args.spp, args.max_depth,
               args.launches, args.device)
    if args.json:
        with open(args.json, "a") as f:
            for row in rows:
                f.write(json.dumps(row) + "\n")
    for row in rows:
        print(json.dumps(row), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
