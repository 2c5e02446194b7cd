"""Timing of an inverse-rendering fit on the megakernel path.

The port of tools/inverse_render_bench.py: recover cornell_box's wall
colour 1 (set to 0.2) by Adam descent through the megakernel
(ops/mega_grad.py::fit_scene_params_mega: per step the tables rebuilt at
the current colours, one tape launch of K2+K3, one replay value and
gradient, the update, a clamp at 0), at the JAX tool's workload: 64x64,
16 spp, depth 8, tape T = 1024, 80 steps at lr 0.08. The target is the
tape render at the true colours with the fit's key. One warm-up step
(kernel build, caches), then the timed fit on the host clock between
device synchronisations.

    python -m raytracingweekend_tpu_torch.tools.inverse_render_bench
        [--steps 80] [--out fit.json] [--device cuda|cpu]

It prints one JSON object (the JAX tool's keys, and the card's name and
power limit under "device") as its last line, and writes it to --out
when given. The default device is `cuda` and raises without a card;
`--device cpu` runs the plain versions (keep the shape tiny there).
"""
from __future__ import annotations

import argparse
import json
import sys

import numpy as np
import torch

from . import card_line
from ..grad import _with_colors
from ..models.scenes import make_scene
from ..ops import mega_grad as mg
from ..utils import prng
from .grad_bench import synced_s


def run(scene_name: str, nx: int, ny: int, spp: int, max_depth: int, T: int,
        steps: int, lr: float, device) -> dict:
    """The tool's JSON object (see the module docstring)."""
    card = card_line(device)
    scene = make_scene(scene_name, nx / ny)
    key = prng.key(0)
    ctx = mg.plan_tape(scene, nx, ny, spp, max_depth=max_depth, T=T,
                       device=device)
    target, _, _ = mg.tape_forward(key, ctx)
    print("target mean", float(target.mean()), flush=True)
    true_color = np.asarray(scene.textures.color[1]).tolist()
    bad_c = np.array(scene.textures.color, np.float32)
    bad_c[1] = 0.2
    bad = _with_colors(scene, bad_c)

    def fit(n, losses):
        return mg.fit_scene_params_mega(
            bad, target, get_params=lambda sc: sc.textures.color,
            set_params=_with_colors, key=key, nx=nx, ny=ny, spp=spp,
            max_depth=max_depth, steps=n, lr=lr, T=T,
            postprocess=lambda p: torch.clamp_min(p, 0.0),
            log_fn=lambda i, v: losses.append(v), device=device)

    t_warm, _ = synced_s(lambda: fit(1, []), device)
    print(f"warm-up step: {t_warm:.3f} s", flush=True)
    losses: list = []
    dt, (fitted, _) = synced_s(lambda: fit(steps, losses), device)
    rec = np.asarray(fitted.textures.color[1])
    return {
        "scene": scene_name, "nx": nx, "ny": ny, "spp": spp, "steps": steps,
        "seconds_total": round(dt, 3), "s_per_step": round(dt / steps, 4),
        "loss_first": float(losses[0]), "loss_final": float(losses[-1]),
        "true_color": true_color,
        "recovered": [round(float(v), 4) for v in rec],
        "note": ("wall-colour recovery by Adam descent through the "
                 "megakernel: per step the tables rebuilt at the current "
                 "colours, one tape launch, one replay value and gradient "
                 "(plain torch), the update; host clock between device "
                 "synchronisations, after one warm-up step"),
        "device": card,
    }


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--scene", default="cornell_box")
    ap.add_argument("--nx", type=int, default=64)
    ap.add_argument("--ny", type=int, default=64)
    ap.add_argument("--spp", type=int, default=16)
    ap.add_argument("--max-depth", type=int, default=8)
    ap.add_argument("--T", type=int, default=1024)
    ap.add_argument("--steps", type=int, default=80)
    ap.add_argument("--lr", type=float, default=0.08)
    ap.add_argument("--out", default="", help="write the JSON here")
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    out = run(args.scene, args.nx, args.ny, args.spp, args.max_depth, args.T,
              args.steps, args.lr, args.device)
    if args.out:
        with open(args.out, "w") as f:
            json.dump(out, f, indent=1)
    print(json.dumps(out), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
