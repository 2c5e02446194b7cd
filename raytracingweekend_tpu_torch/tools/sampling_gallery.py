"""The diffuse-sampling gallery: one Cornell frame a lambertian strategy.

The port of tools/sampling_gallery.py. The reference compares its
historical lambertian sampling strategies (material.h:83-107) in
RayTracingWeekend/Sampling/*.png; this renders the same comparison, one
frame of `--scene` (a square image) a strategy of `STRATEGIES` at equal
sample count, through render() in a wavefront mode (seed 5, launches of
min(spp, 64)): the megakernel takes only `mis`, so every strategy takes
the wavefront (kernel K7). Each frame goes to
`<out>/sampling_<i>_<strategy>.png` through write_png(postprocess(.)).

    python -m raytracingweekend_tpu_torch.tools.sampling_gallery --out DIR
        [--nx 200 --spp 64 --max-depth 50] [--scene cornell_box]
        [--mode regen|tiled|while|scan] [--device cuda|cpu]

`--out` is required (never the repo's docs/). `--device` replaces the JAX
tool's `--platform`. It prints one line and one JSON row a frame (the
last line the last row, with the card's name and power limit under
"device") and exits 1 if a frame is not finite.
"""
from __future__ import annotations

import argparse
import dataclasses
import json
import os
import sys

import numpy as np
import torch

from . import card_line
from ..models.scenes import make_scene
from ..render import WAVEFRONT_MODES, render
from ..utils import image as image_mod
from ..utils.config import RenderConfig

STRATEGIES = ("unit_sphere", "unit_vector", "hemisphere", "onb",
              "light_only", "mis")


def render_strategy(strategy: str, scene_name: str, nx: int, spp: int,
                    max_depth: int, mode: str, device) -> torch.Tensor:
    """One square frame of `scene_name` with `strategy` (seed 5)."""
    scene = dataclasses.replace(make_scene(scene_name, 1.0),
                                lambertian_strategy=strategy)
    cfg = RenderConfig(nx=nx, ny=nx, spp=spp, max_depth=max_depth, seed=5,
                       samples_per_launch=min(spp, 64), loop_mode=mode,
                       device=device)
    return render(scene, cfg)


def run(out: str, scene_name: str, nx: int, spp: int, max_depth: int,
        mode: str, device) -> list:
    """Render and write every strategy's frame; one row each."""
    card = card_line(device)
    os.makedirs(out, exist_ok=True)
    rows = []
    for i, strategy in enumerate(STRATEGIES):
        canvas = render_strategy(strategy, scene_name, nx, spp, max_depth,
                                 mode, device).cpu().numpy()
        path = os.path.join(out, f"sampling_{i}_{strategy}.png")
        image_mod.write_png(image_mod.postprocess(canvas), path)
        rows.append(dict(strategy=strategy, scene=scene_name, nx=nx,
                         spp=spp, max_depth=max_depth, mode=mode, path=path,
                         mean=float(canvas.mean()),
                         finite=bool(np.isfinite(canvas).all()),
                         device=card))
        print(f"wrote {path} (mean {rows[-1]['mean']:.6f})", flush=True)
    return rows


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--out", required=True,
                    help="directory for the PNGs (made if missing)")
    ap.add_argument("--nx", type=int, default=200)
    ap.add_argument("--spp", type=int, default=64)
    ap.add_argument("--max-depth", type=int, default=50)
    ap.add_argument("--scene", default="cornell_box")
    ap.add_argument("--mode", default="regen", choices=WAVEFRONT_MODES)
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    rows = run(args.out, args.scene, args.nx, args.spp, args.max_depth,
               args.mode, args.device)
    for row in rows:
        print(json.dumps(row), flush=True)
    return 0 if all(r["finite"] for r in rows) else 1


if __name__ == "__main__":
    sys.exit(main())
