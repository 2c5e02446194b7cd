"""Rank-side work of tests/test_torch_parallel.py: each function runs in
every rank that parallel/distributed.py::spawn starts (gloo on the CPU).
This module imports no JAX (the ranks import it by name), and the test
module compares what the ranks return with JAX and with the sequential
emulations (parallel/emulate.py).

Sizes are the JAX package's tests' (tests/test_sharding.py,
tests/test_mega_grad.py:339-430)."""
import dataclasses

import numpy as np
import torch
import torch.distributed as dist

from raytracingweekend_tpu_torch.models.scenes import make_scene
from raytracingweekend_tpu_torch.ops import mega_grad as mg
from raytracingweekend_tpu_torch.ops import megakernel as mk
from raytracingweekend_tpu_torch.parallel import distributed
from raytracingweekend_tpu_torch.parallel.mesh import (
    make_mesh, render_sharded, render_sharded_mega)
from raytracingweekend_tpu_torch.parallel.scaling import dp_scaling_report
from raytracingweekend_tpu_torch.utils import prng

# render_sharded_mega: dielectric 16x16, 8 spp, depth 5, T = 128, key 5
MEGA = ("dielectric", 16, 16, 8, 5, 128, 5)
MEGA_MESHES = ((2, 2), (1, 2), (2, 1), (1, 1))
# render_sharded: dielectric 16x16, 64 spp, depth 8, key 0
WAVE = ("dielectric", 16, 16, 64, 8, 0)
# the sharded gradient: cornell_box 12x12, 4 spp, depth 3, T = 128, key 0
GRAD = ("cornell_box", 12, 12, 4, 3, 128, 0)
# fit_scene_params_mega(mesh=): tests/test_mega_grad.py:397-430
FIT = dict(nx=12, ny=12, spp=4, max_depth=4, T=256, steps=25, lr=0.08)
# dp_scaling_report: dielectric 16x16x8, depth 4, tests/test_distributed.py
SCALING = ("dielectric", 16, 16, 8, 4, (1, 2, 4))


def set_colors(scene, p):
    return dataclasses.replace(scene, textures=dataclasses.replace(
        scene.textures, color=p))


def grad_seed():
    """The sharded gradient's seed: JAX's randint(key(0), (1, 1), 0,
    2**31 - 1)."""
    return prng.randint(prng.key(GRAD[6]), (1, 1), 0, mg.SEED_MAX,
                        device="cpu")


def _coord(mesh):
    c = mesh.get_coordinate()
    return None if c is None else tuple(int(v) for v in c)


def _tile(t):
    return None if t is None else t.numpy()


def battery(jax_tapes: dict, jax_T: int) -> dict:
    """Every sharded check of the test module on a (2, 2) world of four
    ranks, narrower meshes included. `jax_tapes` maps (di, si) to JAX's
    tape of that shard of the sharded gradient at tile width jax_T."""
    res = dict(rank=dist.get_rank(), world=dist.get_world_size())
    name, nx, ny, spp, depth, T, k = MEGA
    scene = make_scene(name, 1.0)
    for dp, sp in MEGA_MESHES:
        mesh = make_mesh(dp, sp, device="cpu")
        tile = render_sharded_mega(scene, mesh, prng.key(k), nx, ny, spp,
                                   max_depth=depth, T=T)
        res["mega", dp, sp] = (_coord(mesh), _tile(tile))

    name, nx, ny, spp, depth, k = WAVE
    mesh = make_mesh(2, 2, device="cpu")
    tile = render_sharded(make_scene(name, 1.0), mesh, prng.key(k), nx, ny,
                          spp, max_depth=depth)
    res["wave"] = (_coord(mesh), _tile(tile))

    name, nx, ny, spp, depth, T, _ = GRAD
    scene = make_scene(name, 1.0)
    target = np.zeros((ny, nx, 3), np.float32)
    vg, aux = mg.make_sharded_value_and_grad(
        scene, mesh, target, nx=nx, ny=ny, spp=spp, max_depth=depth, T=T,
        set_params=set_colors)
    loss, g = vg(scene.textures.color, grad_seed())
    res["grad"] = (float(loss), g.numpy(), sorted(aux))

    # the same step at JAX's tile width, each shard's tape launch replaced
    # by JAX's tape of the shard
    vg, aux = mg.make_sharded_value_and_grad(
        scene, mesh, target, nx=nx, ny=ny, spp=spp, max_depth=depth,
        T=jax_T, set_params=set_colors)
    di, si = _coord(mesh)
    jtape = torch.from_numpy(jax_tapes[di, si])

    def jax_tape_launch(args, pixf, seed, plan):
        out = torch.zeros((jtape.shape[0], mk.OUT_ROWS + jtape.shape[1],
                           jtape.shape[2]))
        out[:, mk.OUT_ROWS:] = jtape
        return out

    own = mg._tape_launch
    mg._tape_launch = jax_tape_launch
    try:
        loss, g = vg(scene.textures.color, grad_seed())
    finally:
        mg._tape_launch = own
    res["grad_jax_tapes"] = (float(loss), g.numpy())

    ctx = mg.plan_tape(scene, FIT["nx"], FIT["ny"], FIT["spp"],
                       max_depth=FIT["max_depth"], T=FIT["T"], device="cpu")
    target, _, _ = mg.tape_forward(prng.key(0), ctx)
    bad = np.array(scene.textures.color, np.float32)
    bad[1] = 0.2
    losses = []
    fitted, final = mg.fit_scene_params_mega(
        set_colors(scene, bad), target,
        get_params=lambda sc: sc.textures.color, set_params=set_colors,
        key=prng.key(0), postprocess=lambda p: torch.clamp_min(p, 0.0),
        log_fn=lambda i, v: losses.append(v), mesh=mesh, **FIT)
    res["fit"] = (losses, final, np.asarray(fitted.textures.color))

    name, nx, ny, spp, depth, dps = SCALING
    res["scaling"] = dp_scaling_report(make_scene(name, 1.0), nx, ny, spp,
                                       dps=dps, max_depth=depth,
                                       device="cpu")
    res["distributed"] = distributed.render_distributed(
        make_scene("dielectric", 1.0), prng.key(4), 16, 16, spp=8,
        max_depth=5, sp=2, device="cpu")
    return res
