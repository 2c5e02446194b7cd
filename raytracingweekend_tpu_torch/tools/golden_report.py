"""Pixelwise parity of render() with the reference oracle's goldens.

The port of tools/golden_report.py. It renders every 32x32 golden
(`GOLDENS`, tests/goldens) through `render()` in a wavefront loop mode
(seed 7, launches of min(spp, 256), depth 50) at the golden's own spp,
which its file name gives, and applies tests/test_golden.py's pixelwise
gate: the scene mean within 2%, and more than 99.5% of pixels within
0.05 + 4 sqrt(golden / spp) of the golden, at the spp rendered.

    python -m raytracingweekend_tpu_torch.tools.golden_report
        [--mode regen|tiled|while] [--scenes dielectric,...]
        [--max-spp N] [--max-depth 50] [--out report.md]
        [--device cuda|cpu]

The earth goldens render on the oracle's own texels
(tools/reference_oracle/earth.rtwi), from which the oracle made them.
`--max-spp` caps each golden's spp (the tolerance widens with it); on the
CPU keep it and the depth tiny. It prints a line and one JSON row a golden
(the last line the last row, with the card's name and power limit under
"device"), writes the Markdown report only where `--out` names a file, and
exits 1 if a golden fails the gate.
"""
from __future__ import annotations

import argparse
import datetime
import json
import os
import re
import sys
import time

import numpy as np

from . import REPO, card_line, pick, tool_scene
from ..render import render
from ..utils.config import RenderConfig

GOLDEN_DIR = os.path.join(REPO, "tests", "goldens")
# tests/test_golden.py's tables: the 32x32 set, and the 128x128 set of
# several megakernel tiles
GOLDENS = {
    "dielectric": "dielectric_32x32_4096spp.bin",
    "light_sample": "light_sample_32x32_4096spp.bin",
    "cornell_box": "cornell_box_32x32_8192spp.bin",
    "random_balls": "random_balls_32x32_2048spp.bin",
    "cornell_smoke": "cornell_smoke_32x32_8192spp.bin",
    "earth": "earth_32x32_4096spp.bin",
    "earth_rect": "earth_rect_32x32_4096spp.bin",
}
GOLDENS_MULTITILE = {
    "cornell_box": "cornell_box_128x128_8192spp.bin",
    "random_balls": "random_balls_128x128_2048spp.bin",
}
MEAN_REL_MAX = 0.02
FRAC_OK_MIN = 0.995


def load_golden(name: str) -> np.ndarray:
    """A golden's linear radiance, (ny, nx, 3) float64, row 0 the image
    bottom."""
    with open(os.path.join(GOLDEN_DIR, name), "rb") as f:
        m = re.match(r"RTWO (\d+) (\d+)", f.readline().decode())
        nx, ny = int(m.group(1)), int(m.group(2))
        data = np.frombuffer(f.read(), dtype="<f8")
    return data.reshape(ny, nx, 3)


def golden_spp(name: str) -> int:
    """The spp the oracle rendered a golden at, from its file name."""
    return int(re.search(r"_(\d+)spp\.bin$", name).group(1))


def gate(ours: np.ndarray, golden: np.ndarray, spp: int) -> dict:
    """tests/test_golden.py's pixelwise criterion at `spp` samples:
    mean_rel, frac_ok and whether both pass (a non-finite image fails)."""
    o = np.asarray(ours, np.float64)
    g = np.asarray(golden, np.float64)
    mean_rel = abs(o.mean() - g.mean()) / max(g.mean(), 1e-6)
    tol = 0.05 + 4.0 * np.sqrt(np.maximum(g, 0.0) / spp)
    frac_ok = float((np.abs(o - g) <= tol).mean())
    passed = bool(np.isfinite(o).all() and mean_rel < MEAN_REL_MAX
                  and frac_ok > FRAC_OK_MIN)
    return dict(mean_rel=float(mean_rel), frac_ok=frac_ok, passed=passed)


def check(scene_name: str, golden_name: str, mode: str, launch_spp: int,
          max_spp: int | None = None, max_depth: int = 50,
          device="cuda") -> dict:
    """One golden through render() in `mode` (seed 7, launches of
    launch_spp) at its spp, or at most max_spp: the gate's row, with the
    image mean beside the golden's and the host seconds of the render."""
    g = load_golden(golden_name)
    ny, nx, _ = g.shape
    spp = golden_spp(golden_name)
    if max_spp:
        spp = min(spp, max_spp)
    cfg = RenderConfig(nx=nx, ny=ny, spp=spp, max_depth=max_depth,
                       samples_per_launch=launch_spp, seed=7,
                       loop_mode=mode, device=device)
    t0 = time.perf_counter()
    ours = render(tool_scene(scene_name, nx / ny), cfg).double().cpu().numpy()
    secs = time.perf_counter() - t0
    return dict(scene=scene_name, golden=golden_name, nx=nx, ny=ny, spp=spp,
                mode=mode, mean=float(ours.mean()),
                golden_mean=float(g.mean()), seconds=secs,
                **gate(ours, g, spp))


def line(label: str, row: dict) -> str:
    """A gate row as one line of text."""
    return (f"{label} {row['scene']} {row['nx']}x{row['ny']} {row['spp']} "
            f"spp: mean {row['mean']:.6f} vs {row['golden_mean']:.6f} (rel "
            f"{row['mean_rel']:.5f} < {MEAN_REL_MAX}), pixels in tolerance "
            f"{row['frac_ok']:.5f} > {FRAC_OK_MIN}, {row['seconds']:.3f} s: "
            f"{'ok' if row['passed'] else 'FAIL'}")


def write_report(path: str, rows: list, mode: str, card: str) -> None:
    """The JAX tool's Markdown report of the gate rows."""
    with open(path, "w") as f:
        f.write("# Pixelwise golden parity report\n\n")
        f.write(f"- date: {datetime.datetime.now().isoformat()}\n")
        f.write(f"- device: {card}\n")
        f.write(f"- integrator mode: {mode}\n")
        f.write("- oracle: tools/reference_oracle (unmodified reference "
                "headers, float64, serial)\n")
        f.write("- gate: scene-mean rel err < 2%; pixel err <= "
                "0.05 + 4*sqrt(golden/spp) for > 99.5% of pixels\n\n")
        f.write("| scene | res | spp | mean rel err | frac_ok | result |\n")
        f.write("|---|---|---|---|---|---|\n")
        for r in rows:
            f.write(f"| {r['scene']} | {r['nx']}x{r['ny']} | {r['spp']} | "
                    f"{r['mean_rel']:.4f} | {r['frac_ok']:.4f} | "
                    f"{'PASS' if r['passed'] else 'FAIL'} |\n")


def run(mode: str, scenes, max_spp: int | None, max_depth: int,
        device) -> list:
    """The gate rows of `scenes` (GOLDENS keys), each with the card line."""
    card = card_line(device)
    rows = []
    for name in scenes:
        spp = golden_spp(GOLDENS[name])
        row = check(name, GOLDENS[name], mode, min(spp, 256), max_spp,
                    max_depth, device)
        row["device"] = card
        print(line(f"golden ({mode})", row), flush=True)
        rows.append(row)
    return rows


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--mode", default="regen",
                    choices=("regen", "tiled", "while"))
    ap.add_argument("--scenes", default=None,
                    help="comma list of GOLDENS scenes (default: all)")
    ap.add_argument("--max-spp", type=int, default=None,
                    help="cap each golden's spp (the gate takes the spp "
                         "rendered)")
    ap.add_argument("--max-depth", type=int, default=50)
    ap.add_argument("--out", default=None,
                    help="write the Markdown report here")
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    rows = run(args.mode, pick(args.scenes, sorted(GOLDENS)), args.max_spp,
               args.max_depth, args.device)
    if args.out:
        write_report(args.out, rows, args.mode, rows[0]["device"])
        print(f"wrote {args.out}", flush=True)
    for row in rows:
        print(json.dumps(row), flush=True)
    return 0 if all(r["passed"] for r in rows) else 1


if __name__ == "__main__":
    sys.exit(main())
