"""Dense against culled sweeps, bit for bit, on the stress scenes.

The port of tools/dyn_ab_check.py. Culling only skips clusters that
cannot hold a lane's closest hit, and ties resolve as in the dense sweep,
so every culled plan must give the dense plan's image and segment count
exactly. Per scene, one launch (the seed JAX's `trace_mega(key(11))`
draws) of each variant:

- dense: `cull=False`, every cluster swept (K1);
- ascending: `cull=True, dyn_order=0`, clusters in ascending id (K5);
- auto: the shipping plan (culled, `dyn_order` 16 from C >= 8);
- dord4: `cull=True, dyn_order=4`, another bucket count.

Each culled variant is held to dense: the image bitwise equal and the
segments equal, else it prints max |d| and the number of differing
values, and the tool exits 1. A variant whose plan or launch is refused
(a dense sweep past a block's shared memory) is a failed row, never a
skipped one. The JAX tool's `voted` (`dyn_cull=False`) and `dyn-chunk2`
variants have no counterpart: the port has no survivor-list switch (its
interleaved votes differ from the survivor list only in the visit order,
which `dyn_order` sets) and no vote chunks; its `dyn-id` is `ascending`.

    python -m raytracingweekend_tpu_torch.tools.dyn_ab_check
        [--nx 64 --ny 64 --spp 8 --max-depth 8]
        [--scenes random_balls_large,random_balls_huge] [--device cuda|cpu]

It prints a line and one JSON row a variant (the last line the last row,
with the card's name and power limit under "device").
"""
from __future__ import annotations

import argparse
import json
import sys

import numpy as np

from . import card_line, tool_scene
from ..ops import megakernel as mk
from ..utils import prng

VARIANTS = {
    "dense": dict(cull=False),
    "ascending": dict(cull=True, dyn_order=0),
    "auto": dict(),
    "dord4": dict(cull=True, dyn_order=4),
}


def ab_seed() -> int:
    """The seed the JAX tool's trace_mega draws from key(11)."""
    return int(prng.randint(prng.key(11), (1, 1), 0, 2 ** 31 - 1,
                            device="cpu")[0, 0])


def _launch(scene, nx, ny, spp, max_depth, device, kw) -> tuple:
    """One launch of a variant: (image as numpy, segments)."""
    res = mk.trace_mega(ab_seed(), scene, nx, ny, spp, max_depth=max_depth,
                        device=device, **kw)
    return res.image.cpu().numpy(), float(res.segments)


def run(scenes, nx: int, ny: int, spp: int, max_depth: int, device) -> list:
    """One row a culled variant a scene (see the module docstring)."""
    card = card_line(device)
    rows = []
    for name in scenes:
        scene = tool_scene(name, nx / ny)
        out, err, plans = {}, {}, {}
        for vname, kw in VARIANTS.items():
            try:
                plans[vname] = mk.make_plan(scene, nx, ny, spp,
                                            max_depth=max_depth, **kw)[1]
                out[vname] = _launch(scene, nx, ny, spp, max_depth, device,
                                     kw)
            except (ValueError, RuntimeError) as e:   # refused plan, launch
                err[vname] = f"{type(e).__name__}: {e}"
        for vname in list(VARIANTS)[1:]:
            row = dict(scene=name, nx=nx, ny=ny, spp=spp,
                       max_depth=max_depth, variant=vname)
            plan = plans.get(vname)
            if plan is not None:
                row.update(C=plan.C, cull=plan.cull,
                           dyn_order=plan.dyn_order)
            error = err.get("dense") or err.get(vname)
            if error:
                row.update(bitwise_equal=False, passed=False, error=error)
                print(f"dyn-ab {name} {nx}x{ny}x{spp}spp dense-vs-{vname}: "
                      f"FAIL ({error})", flush=True)
            else:
                (a, sa), (b, sb) = out["dense"], out[vname]
                same = bool(np.array_equal(a, b))
                d = np.abs(a.astype(np.float64) - b)
                row.update(bitwise_equal=same, segments=sb, dense_segments=sa,
                           max_abs_diff=float(d.max()),
                           n_diff=int((a != b).sum()), n_values=int(a.size),
                           passed=same and sa == sb, error=None)
                print(f"dyn-ab {name} {nx}x{ny}x{spp}spp dense-vs-{vname}: "
                      f"bitwise={'EQUAL' if same else 'DIFF'} "
                      f"segs={sb:.0f}/{sa:.0f} "
                      f"{'PASS' if row['passed'] else 'FAIL'}", flush=True)
                if not same:
                    print(f"  max|d|={row['max_abs_diff']:.3e} n_diff="
                          f"{row['n_diff']}/{row['n_values']}", flush=True)
            row["device"] = card
            rows.append(row)
    return rows


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--nx", type=int, default=64)
    ap.add_argument("--ny", type=int, default=64)
    ap.add_argument("--spp", type=int, default=8)
    ap.add_argument("--max-depth", type=int, default=8)
    ap.add_argument("--scenes",
                    default="random_balls_large,random_balls_huge")
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    rows = run(args.scenes.split(","), args.nx, args.ny, args.spp,
               args.max_depth, args.device)
    for row in rows:
        print(json.dumps(row), flush=True)
    return 0 if all(r["passed"] for r in rows) else 1


if __name__ == "__main__":
    sys.exit(main())
