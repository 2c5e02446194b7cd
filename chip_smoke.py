#!/usr/bin/env python3
"""Smoke test of the PyTorch/CUDA port on one NVIDIA GPU.

Run from the root of a checkout:

    python3 chip_smoke.py

It builds the port's CUDA kernels from the sources in the checkout, holds
each against its plain PyTorch version on the card, checks the renderer
against the reference oracle's golden images, and drives the main path
(book-1 `random_balls` at 1200x800, 64 spp per launch, max_depth 50)
through `render()`, printing one line per phase. Any failure exits
non-zero; without a CUDA device it exits non-zero before printing any
result. The last line is one JSON object naming the device.
"""
from __future__ import annotations

import json
import os
import re
import subprocess
import sys
import tempfile
import time

import numpy as np
import torch

from raytracingweekend_tpu_torch.models.scenes import make_scene
from raytracingweekend_tpu_torch.ops import _build
from raytracingweekend_tpu_torch.ops import megakernel as mk
from raytracingweekend_tpu_torch.render import RenderStats, render
from raytracingweekend_tpu_torch.utils import image as image_mod
from raytracingweekend_tpu_torch.utils.config import RenderConfig

REPO = os.path.dirname(os.path.abspath(__file__))
GOLDEN_DIR = os.path.join(REPO, "tests", "goldens")
# kernel vs plain version: the replay gate of tests/test_mega_grad.py
RTOL, ATOL = 1e-3, 5e-5
MIN_SAME = 0.99       # fraction of lanes / pixels that must agree
NX, NY, SPP, DEPTH = 1200, 800, 64, 50   # the main path (bench.py)
SEED = 20240601


def fail(msg: str):
    raise SystemExit(f"chip_smoke: FAIL: {msg}")


def phase_device() -> None:
    if not torch.cuda.is_available():
        fail("torch.cuda.is_available() is False: this smoke test needs an "
             "NVIDIA GPU")
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60)
    print(smi.stdout.strip())
    print(f"phase 1 device: {torch.cuda.get_device_name(0)}, "
          f"count {torch.cuda.device_count()}, torch {torch.__version__}, "
          f"CUDA {torch.version.cuda}", flush=True)


def phase_build() -> None:
    t0 = time.perf_counter()
    lib, nvcc_secs = _build.build()
    mk._kernel_lib()
    regs = re.findall(r"Used (\d+) registers", _build.build_log())
    spills = re.findall(r"(\d+) bytes spill stores", _build.build_log())
    print(f"phase 2 build: {os.path.basename(lib)} nvcc {nvcc_secs:.3f} s, "
          f"build+load {time.perf_counter() - t0:.3f} s, registers {regs}, "
          f"spill stores {spills}", flush=True)


def _launch_both(scene, nx, ny, spp, depth, exact, T=256):
    """The kernel and its plain version on the same card tensors."""
    _, plan = mk.make_plan(scene, nx, ny, spp, max_depth=depth, T=T,
                           exact=exact)
    args, _ = mk.device_inputs(scene, plan, "cuda")
    out_k = mk.mega_kernel(*args, SEED, plan)
    out_r = mk.trace_mega_reference(*args, SEED, plan)
    torch.cuda.synchronize()
    return args[0], out_k, out_r


def phase_exact_parity() -> None:
    """Exact-spp mode: winner tapes lane by lane, radiance on equal lanes."""
    scene = make_scene("random_balls", 1.0)
    pixf, out_k, out_r = _launch_both(scene, 64, 64, 8, 8, exact=True)
    valid = pixf[:, 2] > 0
    same = (out_k[:, 8:] == out_r[:, 8:]).all(dim=1) & valid
    frac = same.sum().item() / valid.sum().item()
    a = out_k[:, 0:3].transpose(1, 2)[same]
    b = out_r[:, 0:3].transpose(1, 2)[same]
    err = (a - b).abs().max().item()
    close = torch.allclose(a, b, rtol=RTOL, atol=ATOL)
    print(f"phase 3 exact-spp parity (random_balls 64x64, 8 spp, depth 8, "
          f"T=256): tapes equal on {frac:.6f} of lanes (mismatch "
          f"{1 - frac:.6f}), max abs radiance err {err:.3e} "
          f"(rtol {RTOL}, atol {ATOL}): {'ok' if close else 'FAIL'}",
          flush=True)
    if frac < MIN_SAME or not close:
        fail("kernel disagrees with its plain version in exact-spp mode")


def _load_golden(name):
    with open(os.path.join(GOLDEN_DIR, name), "rb") as f:
        m = re.match(r"RTWO (\d+) (\d+)", f.readline().decode())
        nx, ny = int(m.group(1)), int(m.group(2))
        data = np.frombuffer(f.read(), dtype="<f8")
    return data.reshape(ny, nx, 3)


def phase_goldens() -> None:
    """The pixelwise criterion of tests/test_golden.py through render()."""
    for name, golden, spp in (
            ("random_balls", "random_balls_128x128_2048spp.bin", 2048),
            ("dielectric", "dielectric_32x32_4096spp.bin", 4096)):
        g = _load_golden(golden)
        ny, nx, _ = g.shape
        cfg = RenderConfig(nx=nx, ny=ny, spp=spp, max_depth=50,
                           samples_per_launch=64, seed=7, device="cuda")
        t0 = time.perf_counter()
        o = render(make_scene(name, nx / ny), cfg).double().cpu().numpy()
        secs = time.perf_counter() - t0
        mean_rel = abs(o.mean() - g.mean()) / max(g.mean(), 1e-6)
        err = np.abs(o - g)
        tol = 0.05 + 4.0 * np.sqrt(np.maximum(g, 0.0) / spp)
        frac_ok = float((err <= tol).mean())
        ok = np.isfinite(o).all() and mean_rel < 0.02 and frac_ok > 0.995
        print(f"phase 4 golden {name} {nx}x{ny} {spp} spp: mean {o.mean():.6f}"
              f" vs {g.mean():.6f} (rel {mean_rel:.5f} < 0.02), pixels in "
              f"tolerance {frac_ok:.5f} > 0.995, {secs:.3f} s: "
              f"{'ok' if ok else 'FAIL'}", flush=True)
        if not ok:
            fail(f"golden parity failed for {name}")


def phase_main_path() -> dict:
    """render() at the main path's shapes, counting kernel launches."""
    scene = make_scene("random_balls", NX / NY)
    base = dict(nx=NX, ny=NY, max_depth=DEPTH, samples_per_launch=SPP,
                device="cuda")
    mk.KERNEL_LAUNCHES = 0
    render(scene, RenderConfig(spp=SPP, seed=0, **base))   # warm-up launch
    stats = RenderStats()
    canvas = render(scene, RenderConfig(spp=3 * SPP, seed=1, **base),
                    stats=stats)
    launches = mk.KERNEL_LAUNCHES
    img = canvas.cpu().numpy()
    mean = float(img.mean())
    with tempfile.TemporaryDirectory() as tmp:
        png = os.path.join(tmp, "random_balls.png")
        image_mod.write_png(image_mod.postprocess(img), png)
        png_bytes = os.path.getsize(png)
    print(f"phase 5 main path (random_balls {NX}x{NY}, {SPP} spp/launch, "
          f"depth {DEPTH}, 1 warm-up + 3 timed launches): "
          f"{stats.rays_per_s:.6e} path segments/s, "
          f"{stats.trace_seconds / 3:.6f} s/launch, "
          f"{stats.segments:.6e} segments, kernel launches {launches}, "
          f"image mean {mean:.6f}, png {png_bytes} bytes", flush=True)
    if launches < 1:
        fail("the main path launched no CUDA kernel")
    if img.shape != (NY, NX, 3) or not np.isfinite(img).all():
        fail("main path image is not finite or has the wrong shape")
    return dict(launches=launches)


def _event_ms(fn, reps: int) -> tuple[float, object]:
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        out = fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps, out


def phase_kernel_vs_plain() -> dict:
    """One launch at the main path's shapes: kernel and plain version on
    the same inputs, timed with CUDA events, compared pixel by pixel."""
    scene = make_scene("random_balls", NX / NY)
    _, plan = mk.make_plan(scene, NX, NY, SPP, max_depth=DEPTH)
    args, inv = mk.device_inputs(scene, plan, "cuda")

    def kernel():
        return mk.mega_kernel(*args, SEED, plan)

    def plain():
        return mk.trace_mega_reference(*args, SEED, plan)

    kernel()                                   # warm-up
    ms, out_k = _event_ms(kernel, 3)
    plain_ms, out_r = _event_ms(plain, 1)
    img_k = mk._epilogue(out_k, inv, plan).image / SPP
    img_r = mk._epilogue(out_r, inv, plan).image / SPP
    err = (img_k - img_r).abs()
    max_err = err.max().item()
    frac = torch.isclose(img_k, img_r, rtol=RTOL, atol=ATOL).all(
        dim=-1).float().mean().item()
    print(f"phase 5b kernel vs plain at the main path's shapes (T={plan.T}, "
          f"S={plan.S}): kernel {ms:.3f} ms, plain PyTorch {plain_ms:.3f} ms "
          f"per launch; pixels equal within rtol {RTOL}/atol {ATOL}: "
          f"{frac:.6f}, max abs err {max_err:.3e}", flush=True)
    if frac < MIN_SAME:
        fail("kernel disagrees with its plain version at the main path's "
             "shapes")
    return dict(ms=ms, plain_ms=plain_ms, max_abs_err=max_err)


def main() -> int:
    phase_device()
    phase_build()
    phase_exact_parity()
    phase_goldens()
    main_run = phase_main_path()
    timing = phase_kernel_vs_plain()
    print(json.dumps({"kernels": [{
        "name": "megakernel (K1, book-1 sphere path)",
        "route": "cuda",
        "source": "raytracingweekend_tpu_torch/csrc/megakernel.cu",
        "replaces": "raytracingweekend_tpu/ops/megakernel.py:371",
        "launches": main_run["launches"],
        "max_abs_err": timing["max_abs_err"],
        "ms": timing["ms"],
        "plain_ms": timing["plain_ms"],
    }]}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
