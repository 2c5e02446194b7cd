"""Where a regen launch's device time goes, by CUDA kernel.

    python -m raytracingweekend_tpu_torch.wavefront_profile \
        [--scene random_balls] [--nx 1200] [--ny 800] [--spp 8] \
        [--max-depth 50]

Renders the scene through the path-regenerative wavefront three times, one
launch of `spp` samples each: a warm-up, an unprofiled launch timed on the
host clock, and a launch under torch.profiler (CUDA activity only, so the
trace stays small). Prints the device time by kernel, the number of kernel
launches, the device's busy share of the unprofiled launch, and the shares
of device time taken by K7 (`hit_spheres_kernel`) and by the int64
elementwise kernels (the threefry uniforms and pixel indices). Needs a
CUDA device.
"""
from __future__ import annotations

import argparse
import re
import sys
import time

import torch

from .models.scenes import make_scene
from .ops import intersect
from .render import render
from .utils.config import RenderConfig


def short_kernel_name(name: str) -> str:
    """A CUDA kernel's name cut to its base and functor, e.g.
    'vectorized_elementwise_kernel BitwiseAndFunctor<long>'."""
    head = name.replace("(anonymous namespace)::", "").replace("void ", "", 1)
    base = re.split(r"[<(]", head, maxsplit=1)[0].split("::")[-1]
    ops = re.findall(r"(\w+(?:Functor\w*|_kernel_cuda|_kernel_impl|Reduce"
                     r"\w*|_functor))(?:<(\w+)[,>])?",
                     head.split(">(", 1)[0])
    if not ops:
        return base
    op, dtype = ops[-1]
    return f"{base} {op}" + (f"<{dtype}>" if dtype else "")


def device_time_by_kernel(prof) -> dict:
    """{short name: (device ms, launches, one full name)} of a finished
    torch.profiler run."""
    by_name: dict = {}
    for ev in prof.key_averages():
        dev_us = getattr(ev, "self_device_time_total",
                         getattr(ev, "self_cuda_time_total", 0.0))
        if dev_us > 0 and ev.device_type.name == "CUDA":
            short = short_kernel_name(ev.key)
            ms, n, full = by_name.get(short, (0.0, 0, ev.key))
            by_name[short] = (ms + dev_us / 1e3, n + ev.count, full)
    return by_name


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--scene", default="random_balls")
    p.add_argument("--nx", type=int, default=1200)
    p.add_argument("--ny", type=int, default=800)
    p.add_argument("--spp", type=int, default=8)
    p.add_argument("--max-depth", type=int, default=50)
    args = p.parse_args(argv)
    if not torch.cuda.is_available():
        print("wavefront_profile needs a CUDA device", file=sys.stderr)
        return 1
    from torch.profiler import ProfilerActivity, profile
    scene = make_scene(args.scene, args.nx / args.ny)
    cfg = RenderConfig(nx=args.nx, ny=args.ny, spp=args.spp,
                       samples_per_launch=args.spp, max_depth=args.max_depth,
                       seed=1, loop_mode="regen", device="cuda")
    render(scene, cfg)                                   # warm-up
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    render(scene, cfg)
    torch.cuda.synchronize()
    wall_ms = (time.perf_counter() - t0) * 1e3
    k7_before = intersect.KERNEL_LAUNCHES["K7"]
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        render(scene, cfg)
        torch.cuda.synchronize()
    iters = intersect.KERNEL_LAUNCHES["K7"] - k7_before
    by_name = device_time_by_kernel(prof)
    if not by_name:
        print("the profiler recorded no device time", file=sys.stderr)
        return 1
    rows = sorted(((ms, n, short, full) for short, (ms, n, full)
                   in by_name.items()), reverse=True)
    busy = sum(r[0] for r in rows)
    k7_ms = sum(r[0] for r in rows if "hit_spheres_kernel" in r[3])
    i64_ms = sum(r[0] for r in rows
                 if "elementwise" in r[3] and "<long" in r[3])
    n_launch = sum(r[1] for r in rows)
    print(f"{torch.cuda.get_device_name(0)}: {args.scene} "
          f"{args.nx}x{args.ny}x{args.spp}, regen, depth {args.max_depth}; "
          f"unprofiled launch {wall_ms:.1f} ms; profiled launch: device "
          f"kernels {busy:.1f} ms in {n_launch} launches "
          f"({n_launch / max(1, iters):.0f} an iteration of {iters}); busy "
          f"share of the unprofiled launch {busy / wall_ms:.3f} (idle "
          f"{1 - busy / wall_ms:.3f}); K7 {k7_ms:.2f} ms "
          f"({k7_ms / busy:.4f} of device time); int64 elementwise kernels "
          f"{i64_ms:.1f} ms ({i64_ms / busy:.4f})")
    for ms, n, short, _ in rows[:15]:
        print(f"  {ms:9.2f} ms  x{n:<7d} {short}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
