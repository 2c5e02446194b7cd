"""Megakernel launch plans swept in one process: SB, T, cull, visit order.

The port of tools/cull_sweep.py. Each config is a spec
`SB[:T[:cull[:dord]]]`, an empty or missing field meaning make_plan's
auto: SB the cluster size, T the tile width, cull 1 / 0 the culled / dense
sweep, dord the near-to-far visit order's buckets (0 = ascending cluster
id). The TPU spec `SB:chunks[:idx[:T[:cull[:eb[:dyn]]]]]` has no
counterpart past these four fields (vote chunks, index extraction and its
block, the survivor-list switch): a spec of more fields is refused. A
config make_plan refuses raises; no config is skipped.

    python -m raytracingweekend_tpu_torch.tools.cull_sweep
        [--scene random_balls --nx 1200 --ny 800 --spp 64 --max-depth 50]
        [--launches 2] [--configs :128 :256 :512 128] [--json rows.jsonl]
        [--device cuda|cpu]

Each config runs mega_perf's series (two warm-ups, then `--launches`
timed launches, a host read of the segments each) and reports M
segments a second, util, the warp and per-lane survival, the T, SB and C
make_plan took, and the warm-up and timed seconds: one line each, then
one JSON row each (the last line the last row, with the card's name and
power limit under "device"). `--json` appends the rows to a file.
"""
from __future__ import annotations

import argparse
import json
import sys

from . import card_line, tool_scene
from .mega_perf import launch_series, rates

SPEC = "SB[:T[:cull[:dord]]]"


def parse_spec(spec: str) -> dict:
    """make_plan's keywords of one spec (see the module docstring)."""
    parts = spec.split(":")
    if len(parts) > 4:
        raise SystemExit(
            f"config {spec!r}: the port's spec is {SPEC}, an empty field "
            "= auto; the TPU's chunks, idx, eb and dyn fields have no "
            "counterpart")
    try:
        SB, T, cull, dord = ([int(p) if p else None for p in parts]
                             + [None] * (4 - len(parts)))
    except ValueError:
        raise SystemExit(f"config {spec!r}: fields of {SPEC} are integers")
    return dict(SB=SB, T=T, cull=None if cull is None else bool(cull),
                dyn_order=dord)


def run(scene_name: str, nx: int, ny: int, spp: int, max_depth: int,
        launches: int, configs, device) -> list:
    """One row a config (see the module docstring)."""
    card = card_line(device)
    scene = tool_scene(scene_name, nx / ny)
    rows = []
    for spec in configs:
        series = launch_series(scene, nx, ny, spp, max_depth, launches,
                               device, **parse_spec(spec))
        r = rates(series)
        row = dict(spec=spec, scene=scene_name, nx=nx, ny=ny, spp=spp, **r,
                   warm_s=series["warm_s"], timed_s=sum(series["seconds"]),
                   device=card)
        print(f"{spec:<12s} SB={r['SB']:<4d} T={r['T']:<4d} C={r['C']:<4d} "
              f"cull={int(r['cull'])} dord={r['dyn_order']:<3d} "
              f"{r['m_seg_per_s']:10.3f} M seg/s  util={r['util']:.3f} "
              f"warp_survival={r['cull_survival']:.4f} "
              f"lane_survival={r['lane_survival']:.4f}  "
              f"[warm {row['warm_s']:.3f}s, timed {row['timed_s']:.3f}s]",
              flush=True)
        rows.append(row)
    return rows


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--scene", default="random_balls")
    ap.add_argument("--nx", type=int, default=1200)
    ap.add_argument("--ny", type=int, default=800)
    ap.add_argument("--spp", type=int, default=64)
    ap.add_argument("--max-depth", type=int, default=50)
    ap.add_argument("--launches", type=int, default=2)
    ap.add_argument("--configs", nargs="+",
                    default=[":128", ":256", ":512", "128"],
                    help=f"{SPEC} specs, an empty field = auto")
    ap.add_argument("--json", default="",
                    help="append one JSON row a config here")
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    for spec in args.configs:       # refuse a bad spec before any launch
        parse_spec(spec)
    rows = run(args.scene, args.nx, args.ny, args.spp, args.max_depth,
               args.launches, args.configs, args.device)
    if args.json:
        with open(args.json, "a") as f:
            for row in rows:
                f.write(json.dumps(row) + "\n")
    for row in rows:
        print(json.dumps(row), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
