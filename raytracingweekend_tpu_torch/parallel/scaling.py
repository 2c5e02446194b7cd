"""Data-parallel scaling harness (BASELINE.md: >= 90% rays/s scaling
efficiency target).

The port of raytracingweekend_tpu/parallel/scaling.py. Times
render_sharded (or render_sharded_mega) at increasing dp widths over the
ranks of the process group, and reports samples/s per rank and the
efficiency against dp = 1. Every rank calls it (each width's mesh is made
by all of them); ranks outside a width's mesh sit its row out, and every
rank returns the same rows. On gloo ranks of the CPU the numbers say
nothing of a card; tools/scaling_report.py runs it over spawned ranks.
"""
from __future__ import annotations

import time

import torch
import torch.distributed as dist

from ..utils import prng
from .mesh import make_mesh, rank_device, render_sharded, render_sharded_mega

__all__ = ["dp_scaling_report"]


def _sync(device: torch.device) -> None:
    """Wait until `device` has finished the work queued on it."""
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def _barrier(device: torch.device) -> None:
    """Every rank of the process group reaches this point, device idle."""
    _sync(device)
    dist.all_reduce(torch.zeros(1, device=device))
    _sync(device)


def dp_scaling_report(scene, nx: int, ny: int, spp: int,
                      dps=(1, 2, 4, 8), sp: int = 1, max_depth: int = 8,
                      key=None, repeats: int = 1, path: str = "wavefront",
                      T: int | None = None, device="cuda") -> list:
    """Returns a list of dicts: {path, dp, sp, seconds,
    samples_per_s, samples_per_s_per_device, efficiency_vs_dp1}, one a dp
    of `dps` that fits the process group and divides ny. `path` selects
    the renderer under the mesh: "wavefront" (render_sharded) or "mega"
    (render_sharded_mega). A width's seconds are its slowest rank's mean
    over `repeats` renders, each ending in a device synchronisation,
    after one warm-up render; the ranks start each width together."""
    if path not in ("wavefront", "mega"):
        raise ValueError(f"unknown path {path!r}")
    key = prng.key(0) if key is None else key
    n = dist.get_world_size()
    rows = []
    base = None

    def run(mesh, k):
        if path == "mega":
            return render_sharded_mega(scene, mesh, k, nx, ny, spp,
                                       max_depth=max_depth, T=T)
        return render_sharded(scene, mesh, k, nx, ny, spp,
                              max_depth=max_depth)

    for dp in dps:
        if dp * sp > n or ny % dp:
            continue
        mesh = make_mesh(dp, sp, device=device)
        dev = rank_device(mesh)
        in_mesh = mesh.get_coordinate() is not None
        if in_mesh:
            run(mesh, key)                    # warm-up
        _barrier(dev)
        t0 = time.perf_counter()
        if in_mesh:
            for r in range(repeats):
                run(mesh, prng.fold_in(key, r + 1))
                _sync(dev)
        dt = (time.perf_counter() - t0) / repeats if in_mesh else 0.0
        slowest = torch.tensor([dt], dtype=torch.float64, device=dev)
        dist.all_reduce(slowest, op=dist.ReduceOp.MAX)
        dt = float(slowest[0])
        sps = nx * ny * spp / dt
        per_dev = sps / (dp * sp)
        if base is None:
            base = per_dev
        rows.append(dict(path=path, dp=dp, sp=sp, seconds=dt,
                         samples_per_s=sps,
                         samples_per_s_per_device=per_dev,
                         efficiency_vs_dp1=per_dev / base))
    return rows
