"""Pixelwise golden parity of the megakernel path (trace_mega).

The port of tools/mega_golden_check.py: each golden rendered through
`megakernel.trace_mega` (K1 on the sphere scenes, K2+K3 on the Cornell
scenes and light_sample, K4 on the earth scenes) in launches of
`--launch-spp`, held to golden_report's gate at the golden's spp (its
file name's: the JAX tool's SPPS and MULTITILE_SPPS). Launch k's seed is
`render.launch_seed(7, done)` with `done` the spp traced before it: the
value the JAX tool's `trace_mega(fold_in(key(7), done))` draws.

    python -m raytracingweekend_tpu_torch.tools.mega_golden_check
        [--scenes cornell_box,random_balls,...] [--multitile]
        [--launch-spp 512] [--SB 0] [--max-spp N] [--device cuda|cpu]

`--multitile` takes the 128x128 goldens (several tiles a frame: the pixel
layout, its inverse permutation, the per-tile streams and the overdraw
renormalisation) in place of the 32x32 set. `--max-spp` caps each
golden's spp (the gate takes the spp rendered). The JAX tool's `--chunks`
and `--idx` are TPU extraction modes the port leaves out (no vote chunks,
no index-based extraction). It prints a line and one JSON row a golden
(the last line the last row, with the card's name and power limit) and
exits 1 if a golden fails the gate.
"""
from __future__ import annotations

import argparse
import json
import sys
import time

import numpy as np

from . import card_line, pick, tool_scene
from .golden_report import (GOLDENS, GOLDENS_MULTITILE, gate, golden_spp,
                            line, load_golden)
from ..ops import megakernel as mk
from ..render import launch_seed


def launch_seeds(spp: int, launch_spp: int) -> list:
    """(seed, spp) of each launch of a render of `spp` samples in launches
    of at most `launch_spp`."""
    out, done = [], 0
    while done < spp:
        step = min(launch_spp, spp - done)
        out.append((launch_seed(7, done), step))
        done += step
    return out


def render_mega(scene, nx: int, ny: int, spp: int, launch_spp: int,
                SB: int | None = None, max_depth: int = 50,
                device="cuda") -> np.ndarray:
    """The mean radiance (ny, nx, 3) float64 of `spp` samples through
    trace_mega, the launches' sums added in float64 on the host."""
    acc = np.zeros((ny, nx, 3), np.float64)
    for seed, step in launch_seeds(spp, launch_spp):
        res = mk.trace_mega(seed, scene, nx, ny, step, max_depth=max_depth,
                            SB=SB, device=device)
        acc += res.image.double().cpu().numpy()
    return acc / spp


def run(scenes, multitile: bool, launch_spp: int, SB: int | None,
        max_spp: int | None, device) -> list:
    """The gate rows of `scenes`, each with the card line."""
    card = card_line(device)
    goldens = GOLDENS_MULTITILE if multitile else GOLDENS
    rows = []
    for name in scenes:
        g = load_golden(goldens[name])
        ny, nx, _ = g.shape
        spp = golden_spp(goldens[name])
        if max_spp:
            spp = min(spp, max_spp)
        t0 = time.perf_counter()
        ours = render_mega(tool_scene(name, nx / ny), nx, ny, spp,
                           launch_spp, SB, device=device)
        row = dict(scene=name, golden=goldens[name], nx=nx, ny=ny, spp=spp,
                   mode="mega", launch_spp=launch_spp, SB=SB,
                   mean=float(ours.mean()), golden_mean=float(g.mean()),
                   seconds=time.perf_counter() - t0, **gate(ours, g, spp),
                   device=card)
        print(line("mega golden", row), flush=True)
        rows.append(row)
    return rows


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--scenes", default=None,
                    help="comma list (default: every golden of the set)")
    ap.add_argument("--multitile", action="store_true",
                    help="the 128x128 goldens in place of the 32x32 set")
    ap.add_argument("--launch-spp", type=int, default=512)
    ap.add_argument("--SB", type=int, default=0,
                    help="make_plan's cluster size (0 = auto)")
    ap.add_argument("--max-spp", type=int, default=None)
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    table = GOLDENS_MULTITILE if args.multitile else GOLDENS
    rows = run(pick(args.scenes, sorted(table)), args.multitile,
               args.launch_spp, args.SB or None, args.max_spp, args.device)
    for row in rows:
        print(json.dumps(row), flush=True)
    return 0 if all(r["passed"] for r in rows) else 1


if __name__ == "__main__":
    sys.exit(main())
