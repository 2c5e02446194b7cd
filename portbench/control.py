"""The output check's readings, on the card at a cell's own size: the
program on many seeds, the control on a few, in one process.

    python3 -m portbench.control --workload <cell> --seeds 12 \
        --control-seeds 3 --seconds 2

Each program run is the harness's run with a short window; each control
run puts the control in the program's place for one image. The control
is the reference computed a precision lower than the configuration's
float32: the scene's tables rounded to bfloat16 and each launch's
radiance accumulated in a bfloat16 canvas (the reference's arithmetic in
between is float32, as its random numbers and rounding helpers are). It
prints one JSON line a run: {"who", "seed", "correct", "checks"}.
"""
from __future__ import annotations

import argparse
import dataclasses
import json
import sys

import numpy as np
import torch

from . import harness
from .reference import render as rrender


def bf16_scene(scene):
    """`scene` with every float32 leaf rounded to bfloat16 (kept as
    float32 numbers)."""
    def rnd(x):
        a = np.asarray(x)
        if a.dtype != np.float32:
            return x
        return torch.from_numpy(np.array(a, np.float32)).to(
            torch.bfloat16).float().numpy()

    def table(tab):
        if not dataclasses.is_dataclass(tab):
            return tab
        return dataclasses.replace(tab, **{
            f.name: rnd(getattr(tab, f.name))
            for f in dataclasses.fields(tab)})

    return dataclasses.replace(scene, **{
        f.name: table(getattr(scene, f.name))
        for f in dataclasses.fields(scene)})


def control_render(cell: dict, seed: int, device: str):
    """A `render_fn` for `harness.run_cell` that computes the control on
    the tiles that the check of a one-image window samples (the first
    draw of `seed`'s tile stream), instead of the program's image."""
    conf, mix = cell["config"], cell["traffic"]
    nx, ny = int(conf["nx"]), int(conf["ny"])
    spp = int(mix.get("spp", conf["spp"]))
    spl = int(mix["samples_per_launch"])
    cache = {}

    def render_fn(scene, cfg, stats=None):
        if "knobs" not in cache:
            from . import adapter
            cache["knobs"] = adapter.plan_knobs(scene, cfg)
            knobs = cache["knobs"]
            n_tiles = -(-nx * ny // (knobs["T"]
                                     // knobs["slots_per_pixel"]))
            cache["tiles"] = rrender.sample_tiles(
                n_tiles, int(conf["check"]["tiles"]),
                harness.check_rng(seed, harness.TAG_TILES))
            cache["scene"] = bf16_scene(scene)
        return rrender.render_tiles(
            cache["scene"], nx, ny, spp, int(conf["max_depth"]), spl,
            [(cfg.seed, cache["tiles"])], cache["knobs"], device,
            canvas_dtype=torch.bfloat16)[0]

    return render_fn


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seeds", type=int, default=12)
    p.add_argument("--control-seeds", type=int, default=3)
    p.add_argument("--first-seed", type=int, default=4_100_000_000)
    p.add_argument("--seconds", type=float, default=2.0)
    p.add_argument("--device", default="cuda")
    args = p.parse_args(argv)
    if args.device != "cpu" and not torch.cuda.is_available():
        print("control: no NVIDIA GPU", file=sys.stderr)
        return 2
    harness._cache_dirs(harness.ROOT)
    cell = harness.find_cell(harness.load_spec(), args.workload)
    runs = [("program", args.first_seed + i) for i in range(args.seeds)]
    runs += [("control", args.first_seed + 1000 + i)
             for i in range(args.control_seeds)]
    # the control renders one image with no warm-up: nothing compiles
    ccell = dict(cell, traffic=dict(cell["traffic"], warmup_images=0,
                                    warmup_seconds=0.0))
    for who, seed in runs:
        fn = (control_render(cell, seed, args.device)
              if who == "control" else None)
        r = harness.run_cell(ccell if fn else cell, seed,
                             1e-3 if who == "control" else args.seconds,
                             False, device=args.device, render_fn=fn)
        print(json.dumps({"who": who, "seed": seed, "correct": r["correct"],
                          "images": r["attempted"], "checks": r["checks"]}),
              flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
