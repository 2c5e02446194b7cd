"""The port's measurement instruments: the sweep twin (K8), the
dot-formulation microbenchmark (K9), the Mosaic repros (K10-K14), the
kernel A/B, the gradient path's timing tools (grad_bench,
inverse_render_bench), the mesh path's scaling report, the golden checks
(golden_report, mega_golden_check), the culled-path A/B (dyn_ab_check),
the launch-plan timers (mega_perf, cull_sweep, bench_all), the
pixel-layout A/B (coherence_sweep), the closest-hit timer (bvh_bench),
the sampling gallery and the oracle texture's exporter
(export_texture_raw), each with its CLI (`python -m
raytracingweekend_tpu_torch.tools.<name>`)."""
from __future__ import annotations

import os
import subprocess
import time

import torch

from ..models import scene_types as st
from ..models.scenes import make_scene
from ..render import cli_scene

REPO = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))
# the reference oracle's earth texels, which made the earth goldens
RTWI = os.path.join(REPO, "tools", "reference_oracle", "earth.rtwi")


def tool_scene(name: str, aspect: float) -> st.Scene:
    """A scene by its CLI name (render.cli_scene); the earth scenes on the
    oracle's texels (RTWI), not the package's stand-in."""
    if name in ("earth", "earth_rect"):
        return make_scene(name, aspect, image_path=RTWI)
    return cli_scene(name, aspect)


def pick(names: str | None, choices: list) -> list:
    """The comma-separated `names` (all of `choices` when None or empty);
    an unknown name is a SystemExit that lists the choices."""
    if not names:
        return list(choices)
    picked = names.split(",")
    unknown = sorted(set(picked) - set(choices))
    if unknown:
        raise SystemExit(f"unknown scene(s): {unknown}; choices: "
                         f"{list(choices)}")
    return picked


def card_line(device: str) -> str:
    """The card's name and power limit as nvidia-smi gives them, for rows
    measured on `device`; "cpu (plain version)" for the CPU. Raises on a
    CUDA device when none is present."""
    if torch.device(device).type != "cuda":
        return "cpu (plain version)"
    if not torch.cuda.is_available():
        raise RuntimeError("no CUDA device: the tools run on the card by "
                           "default; pass --device cpu for the plain "
                           "version")
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True, timeout=60)
    return smi.stdout.strip().splitlines()[0]


def time_ms(fn, device) -> tuple:
    """One call of fn() in ms, and its result: CUDA events around it on
    the card, the host clock on the CPU."""
    if torch.device(device).type == "cuda":
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        out = fn()
        b.record()
        b.synchronize()
        return a.elapsed_time(b), out
    t0 = time.perf_counter()
    out = fn()
    return (time.perf_counter() - t0) * 1e3, out
