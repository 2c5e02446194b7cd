"""The T = 1 << 15 tile of the tiled integrator, on the card; the
counterpart of tools/mosaic_repros/repro_tile_32768_fault.py.

That script runs the JAX package's `trace_tiled` at the one tile width the
TPU faults on (the JAX package bumps 1 << 15 to 1 << 16); the port has no
such guard (`ops/integrator.py::_tile_width`). `run()` renders
random_balls at 1200x800, 16 spp, one sample a slot and 2^19 slots, so
k = 16 slots a pixel and T = 32768 pixels a tile, at depth 8; then the same
at 2^20 slots (T = 65536). The first must finish with a finite image and
segments > 0, and its image mean must lie within 2% of the second's.
"""
from __future__ import annotations

import time

import torch

from ...models.scenes import make_scene
from ...ops import intersect
from ...ops.integrator import _tile_width, trace_tiled
from ...utils import prng

NX, NY, SPP, DEPTH = 1200, 800, 16, 8
SLOTS, SLOTS_REF = 1 << 19, 1 << 20
SPP_PER_SLOT = 1
MEAN_RTOL = 0.02


def _sync(device) -> None:
    if torch.device(device).type == "cuda":
        torch.cuda.synchronize(device)


def render(n_slots: int, device, nx=NX, ny=NY, spp=SPP, depth=DEPTH,
           seed: int = 0) -> dict:
    """One trace_tiled launch: its tile width, seconds (host clock between
    synchronisations), segments, iterations, image mean and finiteness."""
    scene = make_scene("random_balls", nx / ny)
    _sync(device)
    t0 = time.perf_counter()
    img, segs, iters = trace_tiled(prng.key(seed), scene, nx, ny, spp,
                                   max_depth=depth, n_slots=n_slots,
                                   spp_per_slot=SPP_PER_SLOT, device=device)
    _sync(device)
    return dict(T=_tile_width(n_slots, spp // SPP_PER_SLOT),
                seconds=time.perf_counter() - t0, segments=int(segs),
                iterations=iters, mean=img.double().mean().item(),
                finite=bool(torch.isfinite(img).all()))


def run(device="cuda") -> dict:
    """The T = 32768 launch and its T = 65536 yardstick; `ok` when the
    first finishes finite with segments and its mean is within 2%."""
    T = _tile_width(SLOTS, SPP // SPP_PER_SLOT)
    if T != 1 << 15:
        raise AssertionError(f"tile width {T}, not 32768")
    k7_before = intersect.KERNEL_LAUNCHES["K7"]
    got = render(SLOTS, device)
    k7 = intersect.KERNEL_LAUNCHES["K7"] - k7_before
    ref = render(SLOTS_REF, device)
    rel = abs(got["mean"] - ref["mean"]) / abs(ref["mean"])
    return dict(shape=f"random_balls {NX}x{NY}, {SPP} spp, depth {DEPTH}",
                tile=got, reference=ref, k7_launches=k7, mean_rel_diff=rel,
                ok=got["finite"] and got["segments"] > 0 and
                rel <= MEAN_RTOL)


def verdict(result: dict) -> list:
    t = result["tile"]
    return [f"T=32768 tile: finishes on the card ({t['seconds']:.3f} s, "
            f"{t['segments']} segments, image mean within "
            f"{result['mean_rel_diff']:.2e} of T=65536's)" if result["ok"]
            else "T=32768 tile: WRONG (not finite, no segments or mean off "
            "by more than 2%)"]
