"""Scaling report: measured rows over spawned ranks, and the predicted cost
of the sharded megakernel's one collective.

The port of tools/scaling_report.py. Two halves:

1. Measured: parallel/scaling.py::dp_scaling_report over --ranks ranks
   spawned on this host (parallel/distributed.py::spawn), for the
   wavefront and the megakernel paths. On the card the ranks take NCCL,
   one card a rank; `--backend gloo` lets ranks share one card (their
   times then say nothing of scaling over cards). `--device cpu` runs
   gloo ranks on the CPU: the rows show the program runs at every width,
   and their times say nothing of a card.

2. Predicted: per launch, render_sharded_mega all-reduces lanes x 16
   bytes over "sp" (three float32 radiance sums and one float32 sample
   count a lane), lanes = ceil(nx (ny / dp) / T) T; dp adds no
   collective (row tiles are independent). With the single-card rate
   --rate (samples/s of the book-1 launch, measured on the card:
   chip_smoke.py phase 30 prints it), a launch computes for
   t_c = nx ny launch_spp / (dp sp) / rate, and a ring all-reduce takes
   t_m = 2 (sp - 1) / sp payload / bw; efficiency t_c / (t_c + t_m), no
   overlap assumed. The bandwidths are NVIDIA's published NVLink 4
   figures for the H100 SXM (18 links of 50 GB/s, both directions), not
   measured here.

    python -m raytracingweekend_tpu_torch.tools.scaling_report --rate R
        [--ranks N] [--backend nccl|gloo] [--device cuda|cpu]
        [--skip-measured] [--out report.json]

It prints the report as one JSON object on its last line.
"""
from __future__ import annotations

import argparse
import json
import math
import sys

import torch

from . import card_line
from ..models.scenes import make_scene
from ..parallel.distributed import spawn
from ..parallel.scaling import dp_scaling_report

# NVIDIA's published NVLink 4 figures for the H100 SXM (bytes/s)
NVLINK4_BW = {
    "nvlink4_1link_25GBs": 25e9,          # one link, one direction
    "nvlink4_per_direction_450GBs": 450e9,  # all 18 links, one direction
    "nvlink4_bidirectional_900GBs": 900e9,  # the published total
}
MESHES = ((1, 2), (1, 4), (1, 8), (2, 2), (4, 2), (2, 4), (8, 8))


def predicted_nvlink_model(rate: float, nx: int = 1200, ny: int = 800,
                           launch_spp: int = 64, T: int = 256) -> dict:
    """The analytic (dp, sp) model of the module docstring's second half
    for one launch of `launch_spp` samples of an nx x ny image at tile
    width T (the port's book-1 launch by default), at the single-card
    rate `rate` in samples/s."""
    rows = []
    for dp, sp in MESHES:
        lanes = math.ceil(nx * (ny // dp) / T) * T
        payload = lanes * 16
        t_c = nx * ny * launch_spp / (dp * sp) / rate
        row = {"dp": dp, "sp": sp, "cards": dp * sp,
               "allreduce_payload_bytes": payload,
               "compute_s_per_launch": t_c}
        for name, bw in NVLINK4_BW.items():
            t_m = 2.0 * (sp - 1) / sp * payload / bw
            row[f"efficiency_{name}"] = t_c / (t_c + t_m)
        rows.append(row)
    return {"config": {"nx": nx, "ny": ny, "launch_spp": launch_spp, "T": T,
                       "single_card_samples_per_s": rate,
                       "bandwidths": "NVIDIA's published NVLink 4 figures "
                                     "(H100 SXM), not measured"},
            "rows": rows}


def _measure(scene_name: str, nx: int, ny: int, spp: int, dps: tuple,
             device: str) -> list:
    """One rank's share of the measured half: both paths' rows."""
    scene = make_scene(scene_name, nx / ny)
    return (dp_scaling_report(scene, nx, ny, spp, dps=dps, max_depth=8,
                              path="wavefront", device=device)
            + dp_scaling_report(scene, nx, ny, spp, dps=dps, max_depth=6,
                                path="mega", T=256, device=device))


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--rate", type=float, required=True,
                    help="single-card samples/s of the book-1 launch")
    ap.add_argument("--ranks", type=int, default=0,
                    help="ranks to spawn (0: one a card; 2 on the CPU)")
    ap.add_argument("--backend", default=None, choices=("nccl", "gloo"))
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--scene", default="cornell_box")
    ap.add_argument("--nx", type=int, default=32)
    ap.add_argument("--ny", type=int, default=32)
    ap.add_argument("--spp", type=int, default=8)
    ap.add_argument("--skip-measured", action="store_true")
    ap.add_argument("--out", default="", help="write the report here")
    args = ap.parse_args(argv)
    doc = {"device": card_line(args.device),
           "predicted_nvlink": predicted_nvlink_model(args.rate)}
    if not args.skip_measured:
        ranks = args.ranks or (torch.cuda.device_count()
                               if torch.device(args.device).type == "cuda"
                               else 2)
        dps = tuple(d for d in (1, 2, 4, 8) if d <= ranks)
        doc["ranks"] = ranks
        doc["backend"] = args.backend or (
            "nccl" if torch.device(args.device).type == "cuda" else "gloo")
        doc["rows"] = spawn(_measure, ranks, args=(
            args.scene, args.nx, args.ny, args.spp, dps, args.device),
            device=args.device, backend=args.backend)[0]
        for r in doc["rows"]:
            print(f"  {r['path']} dp={r['dp']}: {r['seconds']:.4f} s",
                  flush=True)
    if args.out:
        with open(args.out, "w") as f:
            json.dump(doc, f, indent=1)
    print(json.dumps(doc), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
