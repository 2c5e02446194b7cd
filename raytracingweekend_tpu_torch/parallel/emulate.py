"""Sequential emulations of the sharded paths in one process.

The reference the tests and chip_smoke.py hold parallel/mesh.py and
ops/mega_grad.py::make_sharded_value_and_grad to: each (dp, sp) shard's
work runs in turn on one device with the shard's own key, seed and row
tile, and the shards are combined by plain sums in shard order, where the
sharded code sums over ranks with all-reduces. With at most two shards a
sum (sp <= 2) the all-reduce adds the same two values, so the rendered
images agree bit for bit; the gradient's sums over four ranks reorder
float additions (tolerance).
"""
from __future__ import annotations

import torch

from ..models import scene_types as st
from ..ops import mega_grad as mg
from ..ops import megakernel as mk
from ..ops.packing import leaf_tensor
from .mesh import _render_tile, shard_key, shard_seed

__all__ = ["render_sharded_mega", "render_sharded", "value_and_grad"]


def render_sharded_mega(scene: st.Scene, dp: int, sp: int, key, nx: int,
                        ny: int, spp: int, max_depth: int = 50,
                        T: int | None = None, device="cpu") -> torch.Tensor:
    """mesh.render_sharded_mega's (ny, nx, 3) canvas, the dp row tiles
    stacked: per tile, each sample shard's launch, the lanes' sums and
    counts added over the shards, then the renormalisation."""
    rows = ny // dp
    _, plan = mk.make_plan(scene, nx, ny, spp // sp, max_depth=max_depth,
                           T=T)
    tiles = []
    for di in range(dp):
        args, inv = mk.device_inputs(scene, plan, device, rows=rows,
                                     row0=di * rows)
        acc = 0
        for si in range(sp):
            out = mk._mega_call(*args, shard_seed(key, di, si), plan)
            acc = acc + torch.cat([out[:, 0:3, :], out[:, 5:6, :]], dim=1)
        acc = acc.transpose(1, 2).reshape(-1, 4)
        sums, dones = acc[:, 0:3], acc[:, 3]
        scaled = sums * (spp / torch.clamp_min(dones, 1.0))[:, None]
        tiles.append(scaled[inv].reshape(rows, nx, 3) / spp)
    return torch.cat(tiles)


def render_sharded(scene: st.Scene, dp: int, sp: int, key, nx: int,
                   ny: int, spp: int, max_depth: int = 100,
                   mode: str = "while", device="cpu") -> torch.Tensor:
    """mesh.render_sharded's (ny, nx, 3) canvas, the dp row tiles
    stacked, each the sum of its sample shards' tiles / spp."""
    rows, spp_shard = ny // dp, spp // sp
    tiles = []
    for di in range(dp):
        acc = 0
        for si in range(sp):
            acc = acc + _render_tile(scene, shard_key(key, di, si), di * rows,
                                     nx, rows, ny, spp_shard, max_depth, mode,
                                     device)
        tiles.append(acc / spp)
    return torch.cat(tiles)


def value_and_grad(scene: st.Scene, target, dp: int, sp: int, params, seed,
                   *, nx: int, ny: int, spp: int, max_depth: int = 8,
                   T: int = 1024, set_params, device="cpu"):
    """make_sharded_value_and_grad's (loss, gradient) at `params` and
    `seed`: every shard's tape launch and replay lanes in turn, the lanes
    added over sp, the squared error added over dp, one backward. Returns
    (loss, gradient, {(di, si): the shard's tape})."""
    aux = mg.sharded_setup(scene, target, dp, sp, nx=nx, ny=ny, spp=spp,
                           max_depth=max_depth, T=T, device=device)
    p = leaf_tensor(params, device).detach().clone().requires_grad_(True)
    total, tapes = 0, {}
    for di in range(dp):
        img = 0
        for si in range(sp):
            seed_dev, pixf, tape = mg.shard_tape(
                aux, set_params(scene, p.detach()), di, si, seed)
            tapes[di, si] = tape
            img = img + aux["replay"].lanes(set_params(scene, p), tape,
                                            seed_dev, pixf)
        img = img / float(spp)
        diff = torch.where(aux["valid"][..., None], img - aux["tgt"][di],
                           0.0)
        total = total + torch.sum(diff * diff)
    loss = total / float(ny * nx * 3)
    loss.backward()
    return loss.detach(), p.grad, tapes
