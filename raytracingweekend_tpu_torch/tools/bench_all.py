"""Megakernel rates on the seven benchmark scenes, one JSON row a scene.

The port of tools/bench_all.py: each of `SCENES` through trace_mega at
its own shape and plan, two warm-up launches (seeds
`render.launch_seed(0, 900 + w)`), then `--launches` timed launches
(`launch_seed(0, i)`: the JAX tool's `fold_in(key(0), i)` draws), each
rate its segments over the host seconds up to the read of its segment
count. earth and earth_rect render on the oracle's texels
(tools/reference_oracle/earth.rtwi).

    python -m raytracingweekend_tpu_torch.tools.bench_all
        [--scenes random_balls,cornell_box,...] [--launches 5]
        [--max-depth 50] [--nx N --ny N --spp N] [--out rows.jsonl]
        [--device cuda|cpu]

`--nx`, `--ny` and `--spp` replace every scene's own (tiny shapes on the
CPU). It prints a line a scene, then the rows (the JAX tool's keys, each
launch's segments under "segments_all", the card's name and power limit
under "device"), and writes them to a file only where `--out` names one.
"""
from __future__ import annotations

import argparse
import json
import statistics
import sys

from . import card_line, pick, tool_scene
from .mega_perf import launch_series

SCENES = [
    # (scene, nx, ny, spp): the JAX package's BASELINE.md configurations
    ("random_balls", 1200, 800, 64),        # book-1 final
    ("cornell_box", 400, 400, 256),         # book-3 MIS
    ("cornell_smoke", 400, 400, 256),       # book-2 volumes
    ("earth", 800, 600, 64),                # book-2 image texture
    ("earth_rect", 800, 600, 64),           # image texture on a rect
    ("random_balls_large", 1200, 800, 32),  # 3604 spheres
    ("random_balls_huge", 1200, 800, 16),   # 14404 spheres
]


def run(scenes, launches: int, max_depth: int, device,
        shape: tuple | None = None) -> list:
    """One row a scene of `scenes` (SCENES entries), at `shape`
    (nx, ny, spp) in place of each scene's own when given."""
    card = card_line(device)
    rows = []
    for name, nx, ny, spp in scenes:
        if shape:
            nx, ny, spp = shape
        s = launch_series(tool_scene(name, nx / ny), nx, ny, spp, max_depth,
                          launches, device)
        r = [seg / dt for seg, dt in zip(s["segments"], s["seconds"])]
        rows.append(dict(scene=name, nx=nx, ny=ny, spp=spp,
                         launches=launches,
                         rays_per_s_median=statistics.median(r),
                         rays_per_s_min=min(r), rays_per_s_max=max(r),
                         rays_per_s_all=[round(x) for x in r],
                         segments_all=s["segments"], device=card))
        print(f"{name:20s} {statistics.median(r) / 1e6:10.3f} M seg/s "
              f"(min {min(r) / 1e6:.3f}, max {max(r) / 1e6:.3f})",
              flush=True)
    return rows


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--scenes", default=None,
                    help="comma list: a subset of SCENES")
    ap.add_argument("--launches", type=int, default=5)
    ap.add_argument("--max-depth", type=int, default=50)
    ap.add_argument("--nx", type=int, default=None)
    ap.add_argument("--ny", type=int, default=None)
    ap.add_argument("--spp", type=int, default=None)
    ap.add_argument("--out", default=None, help="write the rows here")
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    shape = (args.nx, args.ny, args.spp)
    if any(shape) and not all(shape):
        raise SystemExit("--nx, --ny and --spp go together")
    names = pick(args.scenes, [s[0] for s in SCENES])
    rows = run([s for s in SCENES if s[0] in names], args.launches,
               args.max_depth, args.device, shape if all(shape) else None)
    if args.out:
        with open(args.out, "w") as f:
            for row in rows:
                f.write(json.dumps(row) + "\n")
    for row in rows:
        print(json.dumps(row), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
