"""Top-level rendering API + CLI of the PyTorch/CUDA port.

The port of raytracingweekend_tpu/render.py. Each launch traces
`samples_per_launch` samples of every pixel, and the launches accumulate
on the device. Loop modes:

- mega: the fused CUDA megakernel (ops/megakernel.py);
- regen: the path-regenerative wavefront (ops/integrator.py), JAX's
  default; tiled: its per-pixel-slot variant; while / scan: the lockstep
  wavefront. Their closest sphere hit is kernel K7 (ops/intersect.py);
- auto: mega where the megakernel covers the scene, else regen, as in JAX.

On `--device cpu` every kernel's plain PyTorch version runs instead (slow:
for small checks only). The wavefront modes draw JAX's random numbers
(utils/prng.py): with the same seed they trace JAX's samples.

Usage:
    python -m raytracingweekend_tpu_torch.render --scene random_balls \
        --nx 1200 --ny 800 --spp 128 --samples-per-launch 64 \
        --max-depth 50 --stats --out final.png
    python -m raytracingweekend_tpu_torch.render --scene cornell_box \
        --nx 400 --ny 400 --spp 256 --samples-per-launch 64 \
        --max-depth 50 --stats --out cornell.png
    python -m raytracingweekend_tpu_torch.render --scene random_balls \
        --mode regen --nx 1200 --ny 800 --spp 8 --max-depth 50 --stats
    python -m raytracingweekend_tpu_torch.render --scene large_mixed_huge \
        --nx 1200 --ny 800 --spp 32 --samples-per-launch 16 \
        --max-depth 50 --stats --out large_mixed.png
    python -m raytracingweekend_tpu_torch.render --scene random_balls \
        --nx 1200 --ny 800 --spp 1024 --samples-per-launch 64 \
        --max-depth 50 --checkpoint final.rtwf --out final.png

The last one writes its radiance sums to final.rtwf after every launch;
run the same command again after an interruption and it resumes there.

The default scene is `cornell_box`, the reference's
(RayTracingWeekend.cpp:201).
"""
from __future__ import annotations

import argparse
import dataclasses
import json
import os
import time
from dataclasses import dataclass

import numpy as np
import torch

from . import native
from .models import builder, probe_scenes
from .models import scene_types as st
from .models.scenes import SCENES, make_scene
from .ops import camera as camera_mod
from .ops import megakernel as mk
from .ops import sampling
from .ops.integrator import (trace, trace_regenerative, trace_tiled,
                             trace_with_stats)
from .ops.packing import device_scene
from .utils import image as image_mod
from .utils import prng, spans
from .utils.config import RenderConfig

WAVEFRONT_MODES = ("regen", "tiled", "while", "scan")
# builder scenes of models/probe_scenes.py that the CLI renders by name
# beside the library's: random_balls_large's grid (n x n) with a checker
# ground, a rect light, an emissive sphere and a medium, whose culled
# sweep runs ahead of the rects, media and textures (kernel K5s)
PROBE_SCENES = {"large_mixed": 60, "large_mixed_huge": 120}


def cli_scene(name: str, aspect: float) -> st.Scene:
    """A scene of the library, or a probe scene, by its CLI name."""
    if name in PROBE_SCENES:
        return probe_scenes.large_mixed_scene(
            builder, st, n=PROBE_SCENES[name], aspect=aspect)
    return make_scene(name, aspect)


def launch_seed(seed: int, launch: int) -> int:
    """The int32 kernel seed of launch `launch` of a render seeded `seed`:
    `randint(fold_in(key(seed), launch), (1, 1), 0, 2**31 - 1)`, the value
    the JAX package's `render` passes to the same launch, computed in
    scalar host arithmetic (`prng.randint_scalar`: Python ints, no torch
    operator). Only the seed is JAX's: the pixels stay bitwise different
    while the port's `mega` tile width (T = 256) differs from JAX's plan,
    because the RNG streams are keyed by tile and lane."""
    k = prng.fold_in(prng.key(seed), launch)
    return prng.randint_scalar(k, 0, 2 ** 31 - 1)


def _camera_rays(scene: st.Scene, key, nx: int, ny: int, chunk_spp: int,
                 device, rows: int | None = None, row0: int = 0):
    """chunk_spp jittered camera rays per pixel (cpp:227-228), ray k on
    pixel k % (nx rows), and the trace key. `rows` image rows from row
    `row0` on (default: all ny), v taken over the whole image's ny (a row
    tile of parallel/mesh.py's sharded render)."""
    ds = device_scene(scene, device)
    n_pix = nx * (ny if rows is None else rows)
    n_rays = n_pix * chunk_spp
    pix = torch.arange(n_pix, dtype=torch.int64, device=ds.device)
    i = (pix % nx).repeat(chunk_spp).float()
    j = (torch.div(pix, nx, rounding_mode="floor").repeat(chunk_spp)
         + row0).float()
    k_u, k_v, k_cam, k_trace = prng.split(key, 4)
    u = (i + sampling.uniform(k_u, (n_rays,), device=ds.device)) / nx
    v = (j + sampling.uniform(k_v, (n_rays,), device=ds.device)) / ny
    o, d, t = camera_mod.get_rays(k_cam, ds.camera, u, v)
    return o, d, t, k_trace


def render_chunk(scene: st.Scene, key, nx: int, ny: int, chunk_spp: int,
                 max_depth: int = 100, mode: str = "while", device="cuda",
                 rows: int | None = None, row0: int = 0):
    """Radiance *sum* (ny, nx, 3) over chunk_spp samples per pixel through
    the lockstep wavefront (`trace` in "while" or "scan" mode); row 0 is
    the image bottom, like the reference canvas (cpp:247). With `rows`,
    the (rows, nx, 3) tile of image rows row0 .. row0 + rows - 1."""
    rows = ny if rows is None else rows
    o, d, t, k_trace = _camera_rays(scene, key, nx, ny, chunk_spp, device,
                                    rows, row0)
    rad = trace(k_trace, o, d, t, scene, max_depth=max_depth, mode=mode)
    return rad.reshape(chunk_spp, rows, nx, 3).sum(dim=0)


def render_chunk_with_stats(scene: st.Scene, key, nx: int, ny: int,
                            chunk_spp: int, max_depth: int = 100,
                            device="cuda"):
    """render_chunk ("while") and the number of path segments traced."""
    o, d, t, k_trace = _camera_rays(scene, key, nx, ny, chunk_spp, device)
    rad, segs = trace_with_stats(k_trace, o, d, t, scene, max_depth=max_depth)
    return rad.reshape(chunk_spp, ny, nx, 3).sum(dim=0), segs


def render_chunk_regen(scene: st.Scene, key, nx: int, ny: int,
                       chunk_spp: int, max_depth: int = 100,
                       n_slots: int = 1 << 19, device="cuda"):
    """Radiance sums over chunk_spp samples per pixel through the
    path-regenerative wavefront (integrator.trace_regenerative). Returns
    ((ny, nx, 3) sums, segment count, loop iterations)."""
    return trace_regenerative(key, scene, nx, ny, chunk_spp,
                              max_depth=max_depth, n_slots=n_slots,
                              device=device)


def render_chunk_tiled(scene: st.Scene, key, nx: int, ny: int,
                       chunk_spp: int, max_depth: int = 100,
                       n_slots: int = 1 << 19, device="cuda"):
    """Radiance sums through the scatter-free per-pixel-slot wavefront
    (integrator.trace_tiled). Returns ((ny, nx, 3) sums, segment count,
    loop iterations)."""
    return trace_tiled(key, scene, nx, ny, chunk_spp, max_depth=max_depth,
                       n_slots=n_slots, device=device)


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
    # wavefront loop iterations (regen / tiled), 0 for the megakernel
    iterations: int = 0
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


def resolve_mode(scene: st.Scene, mode: str) -> str:
    """The loop mode `render` takes: auto is mega where the megakernel
    covers the scene (shaded, `unsupported_reason` None), else regen."""
    if mode == "auto":
        return "mega" if mk.unsupported_reason(scene) is None else "regen"
    if mode not in ("mega",) + WAVEFRONT_MODES:
        raise ValueError(f"unknown loop mode {mode!r}")
    return mode


def render(scene: st.Scene, cfg: RenderConfig, *, progress: bool = False,
           stats: RenderStats | None = None,
           metrics_path: str | None = None) -> torch.Tensor:
    """Render to a linear-radiance canvas (ny, nx, 3) float32 on
    cfg.device, averaged over cfg.spp samples (row 0 = image bottom).
    Launch k of the wavefront modes draws from
    fold_in(key(cfg.seed), k), as the JAX package's render does.

    With cfg.checkpoint set, the radiance sums and their spp persist in
    that file (native.py's format, the JAX package's), written after each
    launch; an existing file is loaded into the device canvas first and
    the render resumes at launch spp // samples_per_launch, so it draws
    the seeds an uninterrupted render draws and ends on the same bits.
    The result divides by the checkpoint's spp, as the JAX package's
    does. Without a checkpoint the image stays on the device until the
    end; each launch reads its segment count (or, in the while and scan
    modes without `stats`, one pixel) to the host, which waits for the
    launch before the next one is enqueued.

    While a torch.profiler session records, the image's host steps are
    recorded as spans (utils/spans.py) under the root span `render`.

    Raises NotImplementedError for `mega` on a scene the megakernel does
    not cover, ValueError for a checkpoint of another size or one whose
    spp is not a whole number of launches short of cfg.spp."""
    with spans.span("render", image=spans.new_image()):
        return _render(scene, cfg, progress, stats, metrics_path)


def _render(scene: st.Scene, cfg: RenderConfig, progress: bool,
            stats: RenderStats | None, metrics_path: str | None):
    """`render`'s body, inside its image's span."""
    with spans.span("render.start"):
        mode = resolve_mode(scene, cfg.loop_mode)
        if mode == "mega":
            reason = mk.unsupported_reason(scene)
            if reason is not None:
                raise NotImplementedError(f"scene {scene.name!r}: {reason}")
        device = torch.device(cfg.device)
        key = prng.key(cfg.seed)
        chunk = min(cfg.samples_per_launch, cfg.spp)
        want_stats = stats is not None
        collect = stats if want_stats else RenderStats()
        acc = torch.zeros((cfg.ny, cfg.nx, 3), dtype=torch.float32,
                          device=device)
        done = 0
        if cfg.checkpoint and os.path.exists(cfg.checkpoint):
            sums, done = native.load_checkpoint(cfg.checkpoint)
            if sums.shape != (cfg.ny, cfg.nx, 3):
                raise ValueError(
                    f"checkpoint is {sums.shape[1]}x{sums.shape[0]}, config "
                    f"wants {cfg.nx}x{cfg.ny}")
            acc = torch.from_numpy(sums).to(device)
        if done % chunk and done < cfg.spp:
            raise ValueError(f"checkpoint spp {done} is not aligned with "
                             f"samples_per_launch {chunk}")
        launch = done // chunk
    while done < cfg.spp:
        with spans.span("loop.launch", launch=launch):
            this = min(chunk, cfg.spp - done)
            t0 = time.perf_counter()
            with spans.span("loop.key"):
                k_launch = prng.fold_in(key, launch)
            segs = None
            if mode == "mega":
                with spans.span("loop.seed"):
                    seed = launch_seed(cfg.seed, launch)
                part, segs = render_chunk_mega(
                    scene, seed, cfg.nx, cfg.ny, this, cfg.max_depth,
                    tile_lanes=cfg.tile_lanes, device=device)
            elif mode in ("regen", "tiled"):
                fn = (render_chunk_regen if mode == "regen"
                      else render_chunk_tiled)
                part, segs, iters = fn(scene, k_launch, cfg.nx, cfg.ny, this,
                                       cfg.max_depth, device=device)
                collect.iterations += iters
            elif want_stats:
                part, segs = render_chunk_with_stats(
                    scene, k_launch, cfg.nx, cfg.ny, this, cfg.max_depth,
                    device=device)
            else:
                part = render_chunk(scene, k_launch, cfg.nx, cfg.ny, this,
                                    cfg.max_depth, mode, device=device)
            with spans.span("loop.accumulate"):
                acc += part
            with spans.span("loop.wait"):     # waits for the launch
                if segs is not None:
                    collect.segments += float(segs)
                else:
                    float(part[0, 0, 0])
            launch_secs = time.perf_counter() - t0
            collect.trace_seconds += launch_secs
            if want_stats or metrics_path:
                with spans.span("loop.stats"):
                    collect.update_variance(part / this)
            done += this
            launch += 1
            collect.spp_done = done
            if cfg.checkpoint:
                native.save_checkpoint(cfg.checkpoint, acc.cpu().numpy(),
                                       done)
            if metrics_path:
                with open(metrics_path, "a") as mf:
                    mf.write(json.dumps({
                        "launch": launch - 1, "spp_done": done,
                        "launch_seconds": launch_secs,
                        "segments": collect.segments,
                        "rays_per_s": collect.rays_per_s,
                        "pixel_variance": collect.pixel_variance,
                        "mean_std_error": collect.mean_std_error,
                        "device": str(device), "mode": mode,
                    }) + "\n")
            if progress:
                rate = (f", {collect.rays_per_s / 1e6:.1f} M rays/s"
                        if want_stats else "")
                print(f"  spp {done}/{cfg.spp}{rate}", flush=True)
    with spans.span("render.finish"):
        return acc / max(done, 1)


def add_spans(path: str, recorded: list) -> None:
    """Add `recorded` spans (utils/spans.py) to the Chrome trace that
    torch.profiler exported to `path`, on a process row of their own,
    aligned with the trace's events by its base time."""
    with open(path) as f:
        trace = json.load(f)
    trace["traceEvents"] += spans.chrome_events(
        recorded, int(trace.get("baseTimeNanoseconds", 0)))
    with open(path, "w") as f:
        json.dump(trace, f)


def debug_ray(scene: st.Scene, seed: int = 0, device="cuda"):
    """DEBUG_RAY (cpp:38-43): one centre-pixel ray traced at depth 1.
    Returns (origin (3,), direction (3,), radiance (3,)) as numpy."""
    ds = device_scene(scene, device)
    k_cam, k_tr = prng.split(prng.key(seed))
    uv = torch.full((1,), 0.5, dtype=torch.float32, device=ds.device)
    o, d, t = camera_mod.get_rays(k_cam, ds.camera, uv, uv)
    rad = trace(k_tr, o, d, t, scene, max_depth=1)
    return (o[0].cpu().numpy(), d[0].cpu().numpy(), rad[0].cpu().numpy())


def main(argv=None):
    p = argparse.ArgumentParser(description=__doc__)
    p.add_argument("--scene", default="cornell_box",
                   choices=sorted({*SCENES, *PROBE_SCENES}))
    p.add_argument("--nx", type=int, default=400)
    p.add_argument("--ny", type=int, default=400)
    p.add_argument("--spp", type=int, default=64)
    p.add_argument("--max-depth", type=int, default=100)
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--samples-per-launch", type=int, default=8)
    p.add_argument("--out", default="out.png")
    p.add_argument("--checkpoint", default=None,
                   help="framebuffer checkpoint path; rerun to resume")
    p.add_argument("--mode", default="auto",
                   choices=("auto", "mega") + WAVEFRONT_MODES,
                   help="integrator loop: auto = megakernel when the scene "
                        "supports it else regen, mega = the fused CUDA "
                        "megakernel, regen = global path regeneration, "
                        "tiled = scatter-free per-pixel slots, while/scan "
                        "= lockstep")
    p.add_argument("--tile-lanes", type=int, default=256,
                   help="megakernel tile width: lanes per CUDA block "
                        "in overdraw mode, at most 512 (the kernels' "
                        "launch bounds); exact mode takes up to 1024")
    p.add_argument("--device", default="cuda",
                   help="torch device: cuda launches the CUDA kernel, cpu "
                        "runs its plain PyTorch version")
    p.add_argument("--stats", action="store_true",
                   help="report path segments/s per launch")
    p.add_argument("--metrics", default=None, metavar="OUT.JSONL",
                   help="append one JSON line of metrics per launch")
    p.add_argument("--normals", action="store_true",
                   help="RenderType::Normal debug shading (cpp:135-136); "
                        "takes the wavefront path")
    p.add_argument("--debug-ray", action="store_true",
                   help="DEBUG_RAY analogue (cpp:38-43): trace one "
                        "centre-pixel ray at depth 1 and print its radiance")
    p.add_argument("--profile", default=None, metavar="DIR",
                   help="record a torch.profiler trace of the render into "
                        "DIR/trace.json (chrome trace format), with the "
                        "render's host spans on a row of their own")
    args = p.parse_args(argv)

    cfg = RenderConfig(nx=args.nx, ny=args.ny, spp=args.spp,
                       max_depth=args.max_depth, seed=args.seed,
                       samples_per_launch=args.samples_per_launch,
                       checkpoint=args.checkpoint, loop_mode=args.mode,
                       tile_lanes=args.tile_lanes, device=args.device)
    scene = cli_scene(args.scene, cfg.aspect)
    if args.normals:
        scene = dataclasses.replace(scene, render_type=st.RENDER_NORMAL)
    if args.debug_ray:
        o, d, rad = debug_ray(scene, cfg.seed, cfg.device)
        print(f"debug ray: origin={o} dir={d} radiance={rad}")
        return
    stats = RenderStats() if (args.stats or args.metrics) else None
    t0 = time.perf_counter()
    if args.profile:
        from torch.profiler import ProfilerActivity, profile
        acts = [ProfilerActivity.CPU]
        if torch.device(cfg.device).type == "cuda":
            acts.append(ProfilerActivity.CUDA)
        with profile(activities=acts) as prof:
            canvas = render(scene, cfg, progress=True, stats=stats,
                            metrics_path=args.metrics)
        os.makedirs(args.profile, exist_ok=True)
        path = os.path.join(args.profile, "trace.json")
        prof.export_chrome_trace(path)
        add_spans(path, spans.take())
    else:
        canvas = render(scene, cfg, progress=True, stats=stats,
                        metrics_path=args.metrics)
    canvas = canvas.cpu().numpy()
    trace_ms = (time.perf_counter() - t0) * 1000.0

    t0 = time.perf_counter()
    out01 = image_mod.postprocess(canvas)
    if args.out.endswith(".ppm"):
        image_mod.write_ppm(out01, args.out)
    else:
        image_mod.write_png(out01, args.out)
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
