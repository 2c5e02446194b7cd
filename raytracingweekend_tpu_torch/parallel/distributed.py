"""Multi-process rendering on torch.distributed (SURVEY.md §2.3, §5).

The port of raytracingweekend_tpu/parallel/distributed.py. The reference
has no networking at all (one process, PPL threads). Here every rank is
one process with one device: `initialize` joins the process group (NCCL
between cards, gloo on the CPU), `global_mesh` lays a (dp, sp) mesh over
every rank so parallel/mesh.py's sharded renderers run unchanged, and
`render_distributed` gathers the row tiles so that every rank holds the
whole canvas.

The only traffic forward rendering needs is the sample-shard sum of the
pixel accumulators over "sp" (mesh.py); inverse rendering adds the
gradient sum (ops/mega_grad.py::make_sharded_value_and_grad). Rays do not
interact, so there is no neighbour exchange to schedule.

`spawn` starts n ranks on this host (the CPU tests, `dryrun_multichip`,
chip_smoke.py and tools/scaling_report.py use it); on several hosts,
start the ranks with torchrun and call `initialize()` in each.
"""
from __future__ import annotations

import datetime
import multiprocessing
import os
import queue
import tempfile
import time
import traceback

import numpy as np
import torch
import torch.distributed as dist

__all__ = ["initialize", "global_mesh", "render_distributed", "spawn",
           "DEFAULT_TIMEOUT"]

# seconds: a spawned run's deadline and every collective's timeout
DEFAULT_TIMEOUT = 300.0


def initialize(coordinator_address: str | None = None,
               num_processes: int | None = None,
               process_id: int | None = None, device="cuda",
               backend: str | None = None,
               timeout: float = DEFAULT_TIMEOUT) -> None:
    """Join the process group. Idempotent: returns at once if this process
    already joined one. Under torchrun every argument comes from the
    environment (RANK, WORLD_SIZE, MASTER_ADDR, MASTER_PORT, LOCAL_RANK);
    elsewhere pass them: `coordinator_address` is "host:port" (TCP) or a
    "file://" or "tcp://" URL. `device` "cuda" takes NCCL and binds this
    process to card LOCAL_RANK (or its rank) modulo the cards there; "cpu"
    takes gloo. `backend` overrides that choice (gloo ranks sharing one
    card). Raises without a card for "cuda"."""
    if dist.is_initialized():
        return
    device = torch.device(device)
    if device.type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError("initialize(device='cuda') needs a CUDA "
                               "device; pass device='cpu' for gloo ranks "
                               "on the CPU")
        local = os.environ.get("LOCAL_RANK", process_id
                               if process_id is not None
                               else os.environ.get("RANK", 0))
        torch.cuda.set_device(int(local) % torch.cuda.device_count())
    if backend is None:
        backend = "nccl" if device.type == "cuda" else "gloo"
    if coordinator_address is None:
        init_method = "env://"
    elif "://" in coordinator_address:
        init_method = coordinator_address
    else:
        init_method = f"tcp://{coordinator_address}"
    dist.init_process_group(
        backend, init_method=init_method, world_size=num_processes,
        rank=process_id, timeout=datetime.timedelta(seconds=timeout))


def global_mesh(dp: int | None = None, sp: int = 1, device="cuda"):
    """(dp, sp) mesh over every rank of the process group. dp defaults to
    whatever fills the world size. Collective: every rank calls it."""
    from .mesh import make_mesh

    n = dist.get_world_size()
    if dp is None:
        if n % sp:
            raise ValueError(f"sp={sp} does not divide {n} ranks")
        dp = n // sp
    if dp * sp != n:
        raise ValueError(f"mesh {dp}x{sp} != {n} ranks")
    return make_mesh(dp, sp, device=device)


def render_distributed(scene, key, nx: int, ny: int, spp: int,
                       max_depth: int = 100, sp: int = 1,
                       device="cuda") -> np.ndarray:
    """Render over every rank: image rows sharded over dp, samples over
    sp. Returns the whole (ny, nx, 3) canvas as numpy on every rank (an
    all-gather of the row tiles over dp). Call from every rank (SPMD)."""
    from .mesh import render_sharded

    mesh = global_mesh(sp=sp, device=device)
    tile = render_sharded(scene, mesh, key, nx, ny, spp, max_depth=max_depth)
    tiles = [torch.empty_like(tile) for _ in range(mesh.shape[0])]
    dist.all_gather(tiles, tile.contiguous(), group=mesh.get_group("dp"))
    return torch.cat(tiles).cpu().numpy()


def _rank_main(rank: int, world_size: int, init_method: str, device: str,
               backend: str | None, timeout: float, threads: int | None,
               fn, args: tuple, results) -> None:
    """One spawned rank: join the group, run fn(*args), report."""
    try:
        if threads is not None:
            torch.set_num_threads(threads)
        initialize(init_method, world_size, rank, device=device,
                   backend=backend, timeout=timeout)
        try:
            out = fn(*args)
        finally:
            dist.destroy_process_group()
        results.put((rank, True, out))
    except BaseException:
        results.put((rank, False, traceback.format_exc()))
        raise SystemExit(1)


def spawn(fn, world_size: int, args: tuple = (), device="cuda",
          backend: str | None = None, timeout: float = DEFAULT_TIMEOUT,
          threads: int | None = None) -> list:
    """Run fn(*args) SPMD in `world_size` fresh processes of this host
    (multiprocessing's spawn start method: fn must be importable, and
    args and results picklable). Each rank joins one process group
    (`initialize` with `device` and `backend`) through a file rendezvous
    in a temporary directory; `timeout` bounds every collective and the
    whole run; `threads` sets each rank's torch threads. Returns the
    ranks' results in rank order. If a rank raises or dies, or the
    deadline passes, every rank is killed and RuntimeError carries the
    failing rank's traceback."""
    device = torch.device(device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("spawn(device='cuda') needs a CUDA device; pass "
                           "device='cpu' for gloo ranks on the CPU")
    ctx = multiprocessing.get_context("spawn")
    results = ctx.Queue()
    got: dict = {}
    failure = None
    with tempfile.TemporaryDirectory(prefix="rtw_rendezvous_") as tmp:
        init_method = "file://" + os.path.join(tmp, "store")
        procs = [ctx.Process(target=_rank_main, args=(
            rank, world_size, init_method, str(device), backend, timeout,
            threads, fn, tuple(args), results)) for rank in range(world_size)]
        for p in procs:
            p.start()
        deadline = time.monotonic() + timeout
        try:
            while len(got) < world_size and failure is None:
                left = deadline - time.monotonic()
                if left <= 0:
                    failure = (f"ranks {sorted(set(range(world_size)) - set(got))}"
                               f" did not finish within {timeout} s")
                    break
                dead = [r for r, p in enumerate(procs)
                        if r not in got and p.exitcode not in (None, 0)]
                try:
                    # a rank that died has had a second to report why
                    rank, ok, out = results.get(
                        timeout=1.0 if dead else min(left, 0.5))
                except queue.Empty:
                    if dead:
                        failure = (f"rank {dead[0]} exited with code "
                                   f"{procs[dead[0]].exitcode}")
                    continue
                if ok:
                    got[rank] = out
                else:
                    failure = f"rank {rank} failed:\n{out}"
        finally:
            for p in procs:
                if failure is not None and p.is_alive():
                    p.kill()
                p.join(timeout=30)
                if p.is_alive():
                    p.kill()
                    p.join()
            results.close()
    if failure is not None:
        raise RuntimeError(f"spawn({getattr(fn, '__name__', fn)}, "
                           f"{world_size}): {failure}")
    return [got[r] for r in range(world_size)]
