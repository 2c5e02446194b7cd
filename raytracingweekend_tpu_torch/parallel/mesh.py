"""Scale-out of rendering over a (dp, sp) mesh of ranks.

The port of raytracingweekend_tpu/parallel/mesh.py. The reference's only
parallelism is shared-memory PPL parallel_for over rows x cols x samples
with racy static RNGs (reference: RayTracingWeekend.cpp:186-193,213-219;
SURVEY.md §2.3). Here:

- mesh axis "dp": image row tiles, embarrassingly parallel; the output
  stays sharded (each rank returns its own tile);
- mesh axis "sp": sample shards, combined with one all-reduce (sum) of the
  accumulators over the rank's sp group: the only traffic in forward
  rendering;
- the gradient all-reduce of inverse rendering is the same sum applied to
  scene-parameter gradients (ops/mega_grad.py).

A mesh is a torch.distributed DeviceMesh with mesh_dim_names ("dp", "sp")
over the first dp * sp ranks (`make_mesh`), and every function here runs
SPMD: each rank of the process group calls it. The RNG is keyed per (tile,
sample shard) as the JAX package keys it, fold_in(fold_in(key, di), si),
so a sharded render is deterministic and its shards independent.
"""
from __future__ import annotations

import torch
import torch.distributed as dist
from torch.distributed.device_mesh import DeviceMesh

from ..models import scene_types as st
from ..ops import megakernel as mk
from ..ops.mega_grad import tape_seed
from ..render import render_chunk
from ..utils import prng

__all__ = ["make_mesh", "render_sharded", "render_sharded_mega"]

def make_mesh(dp: int = 1, sp: int = 1, device="cuda") -> DeviceMesh:
    """Build a (dp, sp) mesh over the first dp * sp ranks of the process
    group (parallel/distributed.py). dp shards image row tiles; sp shards
    samples per pixel. The mesh's collectives run on `device`'s type
    ("cuda": each rank's current card; "cpu"). Collective: every rank of
    the group calls it, those past dp * sp too, which get a mesh they are
    not in (`get_coordinate()` None) and sit out the sharded calls.
    Raises without a process group, without a card for "cuda", and when
    the group has fewer than dp * sp ranks."""
    if not dist.is_initialized():
        raise RuntimeError("make_mesh needs a process group: "
                           "distributed.initialize() in every rank, or "
                           "distributed.spawn()")
    device = torch.device(device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("make_mesh(device='cuda') needs a CUDA device")
    world = dist.get_world_size()
    if dp < 1 or sp < 1 or dp * sp > world:
        raise ValueError(f"a {dp}x{sp} mesh needs {dp * sp} ranks, the "
                         f"process group has {world}")
    return DeviceMesh(device.type, torch.arange(dp * sp).reshape(dp, sp),
                      mesh_dim_names=("dp", "sp"))


def mesh_shape(mesh: DeviceMesh) -> tuple[int, int]:
    """(dp, sp) of a mesh from make_mesh; raises on any other object."""
    if getattr(mesh, "mesh_dim_names", None) != ("dp", "sp"):
        raise TypeError(f"expected a (dp, sp) DeviceMesh from make_mesh, "
                        f"got {mesh!r}")
    dp, sp = mesh.shape
    return int(dp), int(sp)


def rank_device(mesh: DeviceMesh) -> torch.device:
    """This rank's device under `mesh`: its current card, or the CPU."""
    mesh_shape(mesh)
    if mesh.device_type == "cuda":
        return torch.device("cuda", torch.cuda.current_device())
    return torch.device(mesh.device_type)


def shard_key(key, di: int, si: int):
    """The key of shard (di, si): fold_in(fold_in(key, di), si)."""
    return prng.fold_in(prng.fold_in(key, di), si)


def shard_seed(key, di: int, si: int) -> int:
    """The megakernel seed of shard (di, si), the JAX package's draw
    randint(shard_key, (1, 1), 0, 2**31 - 1)."""
    return int(tape_seed(shard_key(key, di, si), "cpu")[0, 0])


def _render_tile(scene: st.Scene, key, row0: int, nx: int, rows: int,
                 ny_total: int, spp_shard: int, max_depth: int, mode: str,
                 device):
    """Render `rows` image rows from absolute row `row0` on with spp_shard
    samples each. Returns the radiance sum (rows, nx, 3)."""
    return render_chunk(scene, key, nx, ny_total, spp_shard,
                        max_depth=max_depth, mode=mode, device=device,
                        rows=rows, row0=row0)


def _split(mesh: DeviceMesh, ny: int, spp: int):
    """(dp, sp, di, si, rows, spp_shard) of this rank, or None when the
    rank is not in the mesh."""
    dp, sp = mesh_shape(mesh)
    if ny % dp:
        raise ValueError(f"ny={ny} must divide by dp={dp}")
    if spp % sp:
        raise ValueError(f"spp={spp} must divide by sp={sp}")
    coord = mesh.get_coordinate()
    if coord is None:
        return None
    di, si = (int(c) for c in coord)
    return dp, sp, di, si, ny // dp, spp // sp


def render_sharded(scene: st.Scene, mesh: DeviceMesh, key, nx: int, ny: int,
                   spp: int, max_depth: int = 100, mode: str = "while"):
    """Render (ny, nx) at `spp` with rows sharded over mesh axis "dp" and
    samples over "sp", through the lockstep wavefront (`trace` in `mode`,
    kernel K7). Returns this rank's tile of the averaged canvas, (ny / dp,
    nx, 3) on its device: rows di * ny / dp on, the tile of mesh
    coordinate (di, si) (None on a rank outside the mesh).

    Each rank traces its (row tile x sample shard) block with its folded
    key; the sample shards are combined with one all-reduce over "sp"."""
    split = _split(mesh, ny, spp)
    if split is None:
        return None
    _, _, di, si, rows, spp_shard = split
    tile = _render_tile(scene, shard_key(key, di, si), di * rows, nx, rows,
                        ny, spp_shard, max_depth, mode, rank_device(mesh))
    dist.all_reduce(tile, group=mesh.get_group("sp"))
    return tile / spp


def render_sharded_mega(scene: st.Scene, mesh: DeviceMesh, key, nx: int,
                        ny: int, spp: int, max_depth: int = 50,
                        T: int | None = None, SB: int | None = None,
                        cull: bool | None = None):
    """The megakernel (ops/megakernel.py) over a (dp, sp) mesh: image row
    tiles over "dp", samples over "sp", one all-reduce over "sp" of each
    lane's radiance sums and sample counts (one (lanes, 4) float32 buffer:
    lanes x 16 bytes) combines the shards. Returns this rank's tile of the
    averaged canvas, (ny / dp, nx, 3) on its device (None on a rank
    outside the mesh).

    The plan is made once for the whole image at spp / sp samples (the
    camera's v runs over the full ny); each rank launches the kernel on
    its own row tile's pixel layout (rows offset by di * ny / dp) with
    the seed of its (dp, sp)-folded key. The overdraw counts are pooled
    over the sample shards before the renormalisation, so the estimator
    is trace_mega's: at (1, 1) the image is trace_mega's with the seed
    `shard_seed(key, 0, 0)`, divided by spp, bit for bit. T, SB and cull
    are make_plan's."""
    split = _split(mesh, ny, spp)
    if split is None:
        return None
    _, _, di, si, rows, spp_shard = split
    _, plan = mk.make_plan(scene, nx, ny, spp_shard, max_depth=max_depth,
                           T=T, SB=SB, cull=cull)
    args, inv = mk.device_inputs(scene, plan, rank_device(mesh), rows=rows,
                                 row0=di * rows)
    out = mk._mega_call(*args, shard_seed(key, di, si), plan)
    acc = torch.cat([out[:, 0:3, :], out[:, 5:6, :]], dim=1)
    acc = acc.transpose(1, 2).reshape(-1, 4).contiguous()
    dist.all_reduce(acc, group=mesh.get_group("sp"))
    sums, dones = acc[:, 0:3], acc[:, 3]
    scaled = sums * (spp / torch.clamp_min(dones, 1.0))[:, None]
    return scaled[inv].reshape(rows, nx, 3) / spp
