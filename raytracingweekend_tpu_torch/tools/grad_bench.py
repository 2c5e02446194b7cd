"""Timing of the differentiable megakernel path, one gradient step.

The port of tools/grad_bench.py. Per inverse-rendering step on
cornell_box (128x128, 32 spp, depth 8 by default; tape T = 1024) it
times (a) the tape forward, one exact-spp launch of the megakernel
(K2+K3 on the Cornell scenes) with its winner tape, and (b) the replay's
value and gradient of mean(img^2) w.r.t. the texture colours (plain
torch under autograd, ops/mega_grad.py), with (c) the replay forward
alone; `--wavefront` adds the wavefront `render_diff` value and gradient
(kernel K7). Each timing is the host clock between device
synchronisations, the mean of --repeats after one warm-up.

    python -m raytracingweekend_tpu_torch.tools.grad_bench
        [--nx 128 --ny 128 --spp 32 --max-depth 8]
        [--repeats 3] [--wavefront] [--json rows.jsonl] [--device cuda|cpu]

It prints one JSON row (the JAX tool's keys, and the card's name and
power limit under "device") as its last line and appends it to --json
when given. The default device is `cuda` and raises without a card;
`--device cpu` runs the plain versions (keep the shape tiny there).
"""
from __future__ import annotations

import argparse
import json
import sys
import time

import torch

from . import card_line
from ..grad import _with_colors, render_diff
from ..models.scenes import make_scene
from ..ops import mega_grad as mg
from ..utils import prng


def synced_s(fn, device) -> tuple:
    """fn() on the host clock between two device synchronisations: its
    seconds and its result."""
    dev = torch.device(device)
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)
    t0 = time.perf_counter()
    out = fn()
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)
    return time.perf_counter() - t0, out


def run(scene_name: str, nx: int, ny: int, spp: int, max_depth: int,
        repeats: int, wavefront: bool, device) -> dict:
    """The tool's row (see the module docstring)."""
    card = card_line(device)
    scene = make_scene(scene_name, nx / ny)
    key = prng.key(0)
    ctx = mg.plan_tape(scene, nx, ny, spp, max_depth=max_depth,
                       device=device)
    replay = mg.make_replay(ctx)
    colors = scene.textures.color

    def value_and_grad(tape, seed):
        p = torch.tensor(colors, dtype=torch.float32, device=ctx["device"],
                         requires_grad=True)
        loss = torch.mean(replay(_with_colors(scene, p), tape, seed) ** 2)
        loss.backward()
        return loss.detach(), p.grad

    def forward_only(tape, seed):
        with torch.no_grad():
            return torch.mean(replay(scene, tape, seed) ** 2)

    # warm-up of every stage (kernel build, caches)
    _, tape, seed = mg.tape_forward(key, ctx)
    value_and_grad(tape, seed)
    forward_only(tape, seed)
    keys = prng.split(key, repeats)
    t_fwd = t_rf = t_vg = 0.0
    for r in range(repeats):
        dt, (_, tape, seed) = synced_s(lambda: mg.tape_forward(keys[r], ctx),
                                       device)
        t_fwd += dt
    for _ in range(repeats):
        t_rf += synced_s(lambda: forward_only(tape, seed), device)[0]
    for _ in range(repeats):
        dt, (loss, g) = synced_s(lambda: value_and_grad(tape, seed), device)
        t_vg += dt
    t_fwd, t_rf, t_vg = t_fwd / repeats, t_rf / repeats, t_vg / repeats
    print(f"replay forward-only: {t_rf * 1e3:.1f} ms", flush=True)
    row = dict(scene=scene_name, nx=nx, ny=ny, spp=spp, max_depth=max_depth,
               tape_forward_s=t_fwd, replay_value_and_grad_s=t_vg,
               step_s=t_fwd + t_vg,
               grad_finite=bool(torch.isfinite(g).all()
                                and torch.isfinite(loss)),
               device=card)
    print(f"{scene_name} {nx}x{ny}@{spp}: tape fwd {t_fwd * 1e3:.1f} ms + "
          f"replay val+grad {t_vg * 1e3:.1f} ms = "
          f"{1e3 * (t_fwd + t_vg):.1f} ms/step (grad finite: "
          f"{row['grad_finite']})", flush=True)
    if wavefront:
        def wf_step(k):
            p = torch.tensor(colors, dtype=torch.float32,
                             device=ctx["device"], requires_grad=True)
            img = render_diff(_with_colors(scene, p), k, nx, ny, spp,
                              max_depth, device=device)
            loss = torch.mean(img ** 2)
            loss.backward()
            return loss

        wf_step(key)
        t_wf = sum(synced_s(lambda: wf_step(prng.fold_in(key, r)),
                            device)[0] for r in range(repeats)) / repeats
        row["wavefront_value_and_grad_s"] = t_wf
        row["speedup_vs_wavefront"] = t_wf / (t_fwd + t_vg)
        print(f"wavefront value_and_grad {t_wf * 1e3:.1f} ms/step -> mega "
              f"path speedup {t_wf / (t_fwd + t_vg):.1f}x", flush=True)
    return row


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--scene", default="cornell_box")
    ap.add_argument("--nx", type=int, default=128)
    ap.add_argument("--ny", type=int, default=128)
    ap.add_argument("--spp", type=int, default=32)
    ap.add_argument("--max-depth", type=int, default=8)
    ap.add_argument("--repeats", type=int, default=3)
    ap.add_argument("--wavefront", action="store_true",
                    help="also time grad.render_diff's value and gradient")
    ap.add_argument("--json", default="", help="append the row here")
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    row = run(args.scene, args.nx, args.ny, args.spp, args.max_depth,
              args.repeats, args.wavefront, args.device)
    if args.json:
        with open(args.json, "a") as f:
            f.write(json.dumps(row) + "\n")
    print(json.dumps(row), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
