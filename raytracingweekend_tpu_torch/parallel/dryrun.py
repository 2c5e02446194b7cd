"""Multi-rank dry run: the port of `__graft_entry__.dryrun_multichip`.

Runs, over n spawned ranks on this host factored into a (dp, sp) mesh,
the three sharded programs at tiny shapes: the wavefront training step
(forward render through `trace` in "scan" mode, loss, scene-parameter
gradients summed over both mesh axes, one SGD update), one
render_sharded_mega launch, and one sharded tape + replay value and
gradient; then prints one summary line.

    python -m raytracingweekend_tpu_torch.parallel.dryrun 4 --device cpu
    python -m raytracingweekend_tpu_torch.parallel.dryrun 4 --backend gloo

The first runs gloo ranks on the CPU; on the card, ranks take NCCL (one
card a rank) unless gloo is asked for (gloo ranks may share one card).
"""
from __future__ import annotations

import argparse

import torch
import torch.distributed as dist

from ..grad import _with_colors
from ..models.scenes import make_scene
from ..ops import intersect as k7
from ..ops import mega_grad as mg
from ..ops import megakernel as mk
from ..utils import prng
from .distributed import DEFAULT_TIMEOUT, spawn
from .mesh import (_render_tile, make_mesh, rank_device, render_sharded_mega,
                   shard_key)

__all__ = ["dryrun_multichip"]


def _factor(n: int) -> tuple[int, int]:
    """(dp, sp) with sp the largest divisor of n up to sqrt(n), as the
    JAX package factors its devices."""
    sp = next(c for c in range(int(n ** 0.5), 0, -1) if n % c == 0)
    return n // sp, sp


def _all_sum(x: torch.Tensor, *groups) -> torch.Tensor:
    """x summed over each group in turn (in place)."""
    for g in groups:
        dist.all_reduce(x, group=g)
    return x


def _dryrun_rank(n_devices: int, device: str) -> dict:
    """One rank's share of the dry run; returns its numbers."""
    dp, sp = _factor(n_devices)
    mesh = make_mesh(dp, sp, device=device)
    dev = rank_device(mesh)
    di, si = (int(c) for c in mesh.get_coordinate())
    g_dp, g_sp = mesh.get_group("dp"), mesh.get_group("sp")
    nx, ny = 8, 8 * dp
    spp = 2 * sp
    rows, spp_shard = ny // dp, spp // sp
    max_depth = 3
    scene = make_scene("cornell_box", nx / ny)
    for counts in (mk.KERNEL_LAUNCHES, k7.KERNEL_LAUNCHES):
        for name in counts:
            counts[name] = 0

    # the wavefront training step: this rank's samples of its row tile,
    # their mean over sp (the gradient flows into this rank's own
    # samples), the tile's squared error, the gradient of the mean over
    # dp of the tiles' losses
    colors = torch.tensor(scene.textures.color, dtype=torch.float32,
                          device=dev, requires_grad=True)
    tile = _render_tile(_with_colors(scene, colors),
                        shard_key(prng.key(0), di, si), di * rows, nx, rows,
                        ny, spp_shard, max_depth, "scan", dev) / spp_shard
    total = _all_sum(tile.detach().clone(), g_sp)
    tile = (total + (tile - tile.detach())) / sp
    loss = torch.mean(tile ** 2)
    loss.backward()
    g = _all_sum(colors.grad, g_sp, g_dp) / dp
    loss = _all_sum(loss.detach().reshape(1).clone(), g_dp)[0] / dp
    new_colors = colors.detach() - 0.1 * g
    if not (torch.isfinite(loss) and torch.isfinite(g).all()
            and torch.isfinite(new_colors).all()):
        raise RuntimeError("the wavefront training step is not finite")

    # the megakernel under the same mesh
    img = render_sharded_mega(scene, mesh, prng.key(1), nx, ny, spp,
                              max_depth=max_depth, T=128)
    if img.shape != (rows, nx, 3) or not torch.isfinite(img).all():
        raise RuntimeError(f"bad mega tile {tuple(img.shape)}")
    mega_sum = _all_sum(img.sum().reshape(1), g_dp)[0]

    # the sharded tape + replay value and gradient
    vg, _ = mg.make_sharded_value_and_grad(
        scene, mesh, torch.zeros((ny, nx, 3)), nx=nx, ny=ny, spp=spp,
        max_depth=max_depth, T=128, set_params=_with_colors)
    seed = prng.randint(prng.key(2), (1, 1), 0, mg.SEED_MAX, device="cpu")
    mg_loss, mg_g = vg(scene.textures.color, seed)
    mg_gsum = float(mg_g.abs().sum())
    if not (torch.isfinite(mg_loss) and mg_gsum > 0.0
            and torch.isfinite(mg_g).all()):
        raise RuntimeError("bad mega tape + replay gradient")
    return dict(dp=dp, sp=sp, rank=dist.get_rank(), device=str(dev),
                loss=float(loss), g_abs_sum=float(g.abs().sum()),
                mega_mean=float(mega_sum) / (ny * nx * 3), shards=dp,
                mg_loss=float(mg_loss), mg_g_abs_sum=mg_gsum,
                launches={**mk.KERNEL_LAUNCHES, **k7.KERNEL_LAUNCHES})


def dryrun_multichip(n_devices: int, device="cuda",
                     backend: str | None = None,
                     timeout: float = DEFAULT_TIMEOUT) -> list:
    """Spawn `n_devices` ranks (parallel/distributed.py::spawn) on
    `device`, factor them into (dp, sp) as the JAX package does, run the
    dry run's three programs, print one summary line and return every
    rank's numbers. `backend` None takes NCCL on the card (one card a
    rank: raises when there are fewer cards than ranks) and gloo on the
    CPU; "gloo" on the card is an explicit choice (ranks may share a
    card). Raises if any rank fails."""
    if torch.device(device).type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError("dryrun_multichip(device='cuda') needs a "
                               "CUDA device; pass device='cpu'")
        cards = torch.cuda.device_count()
        if backend in (None, "nccl") and n_devices > cards:
            raise ValueError(f"NCCL takes one card a rank: {n_devices} "
                             f"ranks, {cards} cards (backend='gloo' lets "
                             "ranks share a card)")
    res = spawn(_dryrun_rank, n_devices, args=(n_devices, str(device)),
                device=device, backend=backend, timeout=timeout)
    r = res[0]
    if backend is None:
        backend = "nccl" if r["device"].startswith("cuda") else "gloo"
    print(f"dryrun_multichip(n_devices={n_devices}): mesh=({r['dp']},"
          f"{r['sp']}) on {r['device']} ({backend}) "
          f"wavefront train step loss={r['loss']:.6f} "
          f"|g|={r['g_abs_sum']:.6f} ok; "
          f"megakernel render_sharded_mega mean={r['mega_mean']:.6f} "
          f"shards={r['shards']} ok; "
          f"mega tape+replay grad step loss={r['mg_loss']:.6f} "
          f"|g|={r['mg_g_abs_sum']:.6f} ok", flush=True)
    return res


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("n_devices", type=int)
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--backend", default=None, choices=("nccl", "gloo"))
    args = ap.parse_args(argv)
    dryrun_multichip(args.n_devices, device=args.device,
                     backend=args.backend)


if __name__ == "__main__":
    main()
