"""Top-level rendering API + CLI of the PyTorch/CUDA port.

The port of raytracingweekend_tpu/render.py's megakernel route: each launch
traces `samples_per_launch` samples of every pixel through the CUDA
megakernel (ops/megakernel.py), and the launches accumulate on the device.
On `--device cpu` the kernel's plain PyTorch version runs instead (slow:
for small checks only).

Usage:
    python -m raytracingweekend_tpu_torch.render --scene random_balls \
        --nx 1200 --ny 800 --spp 128 --samples-per-launch 64 \
        --max-depth 50 --stats --out final.png
    python -m raytracingweekend_tpu_torch.render --scene cornell_box \
        --nx 400 --ny 400 --spp 256 --samples-per-launch 64 \
        --max-depth 50 --stats --out cornell.png
    python -m raytracingweekend_tpu_torch.render --scene earth \
        --nx 800 --ny 600 --spp 64 --max-depth 50 --out earth.png

The default scene is `cornell_box`, the reference's
(RayTracingWeekend.cpp:201).
"""
from __future__ import annotations

import argparse
import json
import time
from dataclasses import dataclass

import numpy as np
import torch

from .models import scene_types as st
from .models.scenes import SCENES, make_scene
from .ops import megakernel as mk
from .utils import image as image_mod
from .utils.config import RenderConfig


def launch_seed(seed: int, launch: int) -> int:
    """The int32 kernel seed of launch `launch` of a render seeded `seed`,
    drawn from a torch.Generator seeded by the pair: renders are
    seed-deterministic and each launch has its own streams."""
    pair_seed = int(np.random.SeedSequence([seed, launch]).generate_state(
        1, np.uint64)[0])
    gen = torch.Generator().manual_seed(pair_seed)
    return int(torch.randint(0, 2 ** 31 - 1, (1,), generator=gen))


def render_chunk_mega(scene: st.Scene, seed: int, nx: int, ny: int,
                      chunk_spp: int, max_depth: int = 100,
                      tile_lanes: int = 256, device="cuda"):
    """Radiance sums over chunk_spp samples per pixel via the megakernel.
    Returns ((ny, nx, 3) sums on `device`, segment count tensor)."""
    res = mk.trace_mega(seed, scene, nx, ny, chunk_spp, max_depth=max_depth,
                        T=tile_lanes, device=device)
    return res.image, res.segments


@dataclass
class RenderStats:
    """Per-render observability: path segments per second, spp progress,
    and a per-pixel Welford variance over launch means (kept on the
    device)."""
    spp_done: int = 0
    segments: float = 0.0
    trace_seconds: float = 0.0
    _n: int = 0
    _mean: torch.Tensor | None = None
    _m2: torch.Tensor | None = None

    @property
    def rays_per_s(self) -> float:
        return self.segments / self.trace_seconds if self.trace_seconds else 0.0

    def update_variance(self, launch_mean: torch.Tensor):
        """Welford update with one launch's per-pixel mean radiance."""
        x = launch_mean.to(torch.float64)
        self._n += 1
        if self._mean is None:
            self._mean = x.clone()
            self._m2 = torch.zeros_like(x)
            return
        delta = x - self._mean
        self._mean += delta / self._n
        self._m2 += delta * (x - self._mean)

    @property
    def pixel_variance(self) -> float:
        """Mean per-pixel variance of a single launch estimate (0 until two
        launches have completed)."""
        if self._n < 2:
            return 0.0
        return float((self._m2 / (self._n - 1)).mean())

    @property
    def mean_std_error(self) -> float:
        """Standard error of the accumulated per-pixel mean."""
        if self._n < 2:
            return 0.0
        return float(np.sqrt(self.pixel_variance / self._n))


def render(scene: st.Scene, cfg: RenderConfig, *, progress: bool = False,
           stats: RenderStats | None = None,
           metrics_path: str | None = None) -> torch.Tensor:
    """Render to a linear-radiance canvas (ny, nx, 3) float32 on
    cfg.device, averaged over cfg.spp samples (row 0 = image bottom).

    Raises NotImplementedError for a scene or loop mode this slice of the
    port does not cover."""
    if cfg.loop_mode not in ("auto", "mega"):
        raise NotImplementedError(
            f"loop mode {cfg.loop_mode!r} needs the wavefront integrators "
            "(ROADMAP Queue 1 item 6)")
    reason = mk.unsupported_reason(scene)
    if reason is not None:
        raise NotImplementedError(f"scene {scene.name!r}: {reason}")
    device = torch.device(cfg.device)
    chunk = min(cfg.samples_per_launch, cfg.spp)
    want_stats = stats is not None
    collect = stats if want_stats else RenderStats()
    acc = torch.zeros((cfg.ny, cfg.nx, 3), dtype=torch.float32, device=device)
    done = 0
    launch = 0
    while done < cfg.spp:
        this = min(chunk, cfg.spp - done)
        t0 = time.perf_counter()
        part, segs = render_chunk_mega(
            scene, launch_seed(cfg.seed, launch), cfg.nx, cfg.ny, this,
            cfg.max_depth, tile_lanes=cfg.tile_lanes, device=device)
        acc += part
        segs = float(segs)  # waits for the launch to finish
        launch_secs = time.perf_counter() - t0
        collect.segments += segs
        collect.trace_seconds += launch_secs
        if want_stats or metrics_path:
            collect.update_variance(part / this)
        done += this
        launch += 1
        collect.spp_done = done
        if metrics_path:
            with open(metrics_path, "a") as mf:
                mf.write(json.dumps({
                    "launch": launch - 1, "spp_done": done,
                    "launch_seconds": launch_secs,
                    "segments": collect.segments,
                    "rays_per_s": collect.rays_per_s,
                    "pixel_variance": collect.pixel_variance,
                    "mean_std_error": collect.mean_std_error,
                    "device": str(device),
                }) + "\n")
        if progress:
            rate = (f", {collect.rays_per_s / 1e6:.1f} M rays/s"
                    if want_stats else "")
            print(f"  spp {done}/{cfg.spp}{rate}", flush=True)
    return acc / cfg.spp


def main(argv=None):
    p = argparse.ArgumentParser(description=__doc__)
    p.add_argument("--scene", default="cornell_box", choices=sorted(SCENES))
    p.add_argument("--nx", type=int, default=400)
    p.add_argument("--ny", type=int, default=400)
    p.add_argument("--spp", type=int, default=64)
    p.add_argument("--max-depth", type=int, default=100)
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--samples-per-launch", type=int, default=8)
    p.add_argument("--out", default="out.png")
    p.add_argument("--mode", default="auto", choices=("auto", "mega"),
                   help="integrator loop: auto = mega = the fused megakernel "
                        "(the port's only integrator so far)")
    p.add_argument("--tile-lanes", type=int, default=256,
                   help="megakernel tile width: lanes per CUDA block "
                        "(at most 1024)")
    p.add_argument("--device", default="cuda",
                   help="torch device: cuda launches the CUDA kernel, cpu "
                        "runs its plain PyTorch version")
    p.add_argument("--stats", action="store_true",
                   help="report path segments/s per launch")
    p.add_argument("--metrics", default=None, metavar="OUT.JSONL",
                   help="append one JSON line of metrics per launch")
    args = p.parse_args(argv)

    cfg = RenderConfig(nx=args.nx, ny=args.ny, spp=args.spp,
                       max_depth=args.max_depth, seed=args.seed,
                       samples_per_launch=args.samples_per_launch,
                       loop_mode=args.mode, tile_lanes=args.tile_lanes,
                       device=args.device)
    scene = make_scene(args.scene, cfg.aspect)
    stats = RenderStats() if (args.stats or args.metrics) else None
    t0 = time.perf_counter()
    canvas = render(scene, cfg, progress=True, stats=stats,
                    metrics_path=args.metrics)
    canvas = canvas.cpu().numpy()
    trace_ms = (time.perf_counter() - t0) * 1000.0

    t0 = time.perf_counter()
    image_mod.write_png(image_mod.postprocess(canvas), args.out)
    write_ms = (time.perf_counter() - t0) * 1000.0

    print(f"Trace: {trace_ms:.0f}ms")
    print(f"Write: {write_ms:.0f}ms")
    if stats is not None:
        print(f"Rays/s: {stats.rays_per_s:.3e} "
              f"({stats.segments:.3e} segments) on {cfg.device}")
        print(f"Pixel variance: {stats.pixel_variance:.3e} "
              f"(mean std error {stats.mean_std_error:.3e})")
    print(f"wrote {args.out} ({args.scene}, {cfg.nx}x{cfg.ny}, "
          f"{cfg.spp} spp)")


if __name__ == "__main__":
    main()
