"""Differentiable megakernel rendering: the winner tape and its replay.

The port of raytracingweekend_tpu/ops/mega_grad.py (ROADMAP kernel K6). A
CUDA kernel has no reverse mode, so the gradient path splits in two:

1. **Tape forward**: the megakernel (csrc/megakernel.cu, the plain version
   on a CPU tensor) runs in exact-spp mode: each lane traces exactly `spp`
   samples of its pixel and records, per bounce iteration, one number,
   the winning primitive (-1 miss, sphere slot, S + rect row, S + R +
   medium row). Everything else the backward needs (every uniform, every
   branch coin, the quadratic roots) is recomputable from the counter RNG
   and the scene parameters; the winner is the one quantity whose
   recomputation would cost the O(S) intersection sweep.

2. **Replay**: the plain version of the kernel run in its tape mode
   (`megakernel.trace_mega_reference(..., tape=)`), where the tape's
   winner takes the place of the sweeps and only the winner's hit
   distance is recomputed. With the tape fixed (the detached discrete
   decisions of the JAX package's design), the replay is an ordinary
   torch autograd graph over the kernel's tables, and the tables are
   torch ops over the scene's tensor leaves (`build_tables_traced`), so
   `backward()` reaches sphere centres and radii, rect extents and
   transforms, texture colours and noise scales, texels, metal fuzz,
   dielectric IOR, medium density and the camera vectors.

The replay is the plain version op for op, so on one device it reproduces
the plain version's tape image bit for bit, and the kernel's to float
round-off. The JAX package's one-hot MXU extraction is a gather here (its
backward an index_add). `make_sharded_value_and_grad` and
`fit_scene_params_mega(mesh=)` run the same step over a (dp, sp) mesh of
torch.distributed ranks (parallel/mesh.py).

The float64 twin (`make_replay(dict(ctx, f64=True))`, the JAX package's
`ctx["f64"]`): the replay with float64 tables, the scene cast by
utils/validation.py's scene_to_dtype, so the plain version runs in
float64 (its uniforms the kernel's float32 values, promoted exactly; its
FMAs, square roots and reciprocals plain float64 operations). The tape
fixes every discrete decision of the float32 kernel forward, so the twin
walks the same paths, and its image differs from the float32 replay's by
float32 round-off alone.

Entry points take `device` ("cuda" by default: the kernel makes the tape;
"cpu" runs the plain version).
"""
from __future__ import annotations

import functools

import numpy as np
import torch
import torch.distributed as dist

from ..models import scene_types as st
from ..utils import prng
from ..utils.validation import scene_to_dtype
from . import megakernel as mk
from . import noise as _noise
from .packing import leaf_tensor, scene_dtype

SEED_MAX = 2 ** 31 - 1


def plan_tape(scene: st.Scene, nx: int, ny: int, spp: int,
              max_depth: int = 8, T: int = 1024, device="cuda") -> dict:
    """Static launch plan of the tape-mode kernel and the replay: exact-spp
    mode, no Russian roulette, T lanes a tile. Returns the dict `ctx` that
    tape_forward / make_replay take. Needs a concrete (numpy) scene:
    gradients later flow through a scene with tensor leaves handed to the
    replay, whose structure (type codes, indices, active flags) is this
    one's."""
    tabs, plan = mk.make_plan(scene, nx, ny, spp, max_depth=max_depth,
                              rr_depth=None, T=T, exact=True)
    device = torch.device(device)
    pixf, inv = mk._device_layout(nx, ny, T, str(device))
    return dict(scene=scene, tabs=tabs, plan=plan, meta=tabs[-1], pixf=pixf,
                inv=inv, n_tiles=pixf.shape[0], T=T, nx=nx, ny=ny, spp=spp,
                max_depth=max_depth, device=device)


def tape_seed(key, device) -> torch.Tensor:
    """The (1, 1) int32 kernel seed drawn from `key` as the JAX package
    draws it: randint(key, (1, 1), 0, 2**31 - 1)."""
    return prng.randint(key, (1, 1), 0, SEED_MAX, device=device)


def _tape_launch(args, pixf, seed: int, plan) -> torch.Tensor:
    """One exact-mode launch on the launch tensors `args` (the kernel's
    arguments after pixf); returns its (n_tiles, 8 + n_iters, T) rows."""
    return mk._mega_call(pixf, *args, seed, plan)


def _image(sums: torch.Tensor, ctx: dict) -> torch.Tensor:
    """(n_tiles, T, 3) lane sums -> the (ny, nx, 3) spp-averaged image."""
    return (sums.reshape(-1, 3)[ctx["inv"]].reshape(ctx["ny"], ctx["nx"], 3)
            / float(ctx["spp"]))


def tape_forward_sync(key, ctx: dict):
    """tape_forward plus a scalar checksum (the image sum), so a caller can
    wait for the launch with one transfer."""
    if "args" not in ctx:
        ctx["args"] = mk.table_tensors(ctx["tabs"], ctx["scene"],
                                       ctx["plan"], ctx["device"])
    seed = tape_seed(key, ctx["device"])
    out = _tape_launch(ctx["args"], ctx["pixf"], int(seed[0, 0]),
                       ctx["plan"])
    image = _image(out[:, 0:3, :].transpose(1, 2), ctx)
    return image, out[:, mk.OUT_ROWS:, :], seed, image.sum()


def tape_forward(key, ctx: dict):
    """Run the megakernel in tape mode. Returns (image, tape, seed): image
    the spp-averaged (ny, nx, 3) canvas, tape the (n_tiles, n_iters, T)
    winner codes, seed the (1, 1) int32 the replay reuses."""
    return tape_forward_sync(key, ctx)[:3]


def make_replay(ctx: dict):
    """The differentiable replay: replay(scene, tape, seed) -> the (ny, nx,
    3) spp-averaged image of the tape-mode launch at the parameters of
    `scene` (whose leaves may be tensors with requires_grad), with the
    decisions frozen at the tape.

    `replay.lanes(scene, tape, seed, pixf)` is the same computation over
    any (n, 4, T) pixel-lane block, returning the raw (n, T, 3) radiance
    sums without the image gather; its RNG streams are keyed by the local
    tile index, as the kernel's are. With ctx["f64"] the replay is the
    float64 twin: `scene` is cast to float64 first, and the image is
    float64."""
    plan, meta, base = ctx["plan"], ctx["meta"], ctx["scene"]

    def replay_lanes(scene: st.Scene, tape: torch.Tensor, seed_arr,
                     pixf: torch.Tensor) -> torch.Tensor:
        if ctx.get("f64"):
            scene = scene_to_dtype(scene, torch.float64)
        args = build_tables_traced(scene, base, meta, pixf.device, plan)
        out = mk.trace_mega_reference(pixf, *args,
                                      int(seed_arr.reshape(-1)[0]), plan,
                                      tape=tape.to(pixf.device))
        return out[:, 0:3, :].transpose(1, 2)

    def replay(scene: st.Scene, tape: torch.Tensor, seed_arr):
        return _image(replay_lanes(scene, tape, seed_arr, ctx["pixf"]), ctx)

    replay.lanes = replay_lanes
    return replay


def build_tables_traced(scene: st.Scene, base: st.Scene, meta: dict, device,
                        plan: mk.MegaPlan) -> tuple:
    """The launch's tensors (cam_vec, sph_tab, attr_tab, clus_tab,
    rect_tab, light_tab, med_tab, perm, ranvec, images) on `device` under
    meta's pinned slot layout, as torch ops over `scene`'s leaves (a
    tensor leaf keeps its graph), with every structural decision read from
    the concrete `base` (megakernel.table_rows: the tables build_tables
    returns, bit for bit); texels take the scene's dtype (float32, or
    float64 in the float64 twin)."""
    ft = scene_dtype(scene)
    images = (leaf_tensor(scene.textures.images, device, ft) if plan.img_hw
              else torch.zeros((1, 1, 1, 3), dtype=ft, device=device))
    return (*mk.table_rows(scene, base, meta, device),
            *_noise.noise_tables(str(device)), images)


def render_diff_mega(scene: st.Scene, key, nx: int, ny: int, spp: int,
                     max_depth: int = 8, T: int = 1024, device="cuda"):
    """Runs the tape forward once on the concrete `scene` and returns
    (image, diff_fn): diff_fn(scene_with_tensor_leaves) -> image is
    differentiable, with the path decisions frozen at `scene`."""
    ctx = plan_tape(scene, nx, ny, spp, max_depth=max_depth, T=T,
                    device=device)
    image, tape, seed = tape_forward(key, ctx)
    return image, functools.partial(make_replay(ctx), tape=tape,
                                    seed_arr=seed)


def fit_scene_params_mega(scene: st.Scene, target, *, get_params,
                          set_params, key, nx: int, ny: int, spp: int,
                          max_depth: int = 8, steps: int = 50,
                          lr: float = 0.05, T: int = 1024,
                          postprocess=None, log_fn=None, mesh=None,
                          device="cuda"):
    """Inverse rendering on the megakernel path. `get_params(scene)` gives
    the parameter array (a float32 tensor is made of it), and
    `set_params(scene, p)` writes a tensor back (e.g. with
    dataclasses.replace). Each step rebuilds the tables at the current
    parameters on the device, takes one tape launch with the one seed drawn
    from `key` before the fit (as the JAX package does), runs one replay
    loss (the image's mean squared error to `target`) and its backward,
    then one torch.optim.Adam(lr) step and `postprocess` (a projection of
    the parameters, e.g. a clamp). `log_fn(i, loss)` is called for each
    step after the fit (the loop reads no loss on the host). Returns
    (fitted scene, final loss); the fitted scene holds the parameters as a
    CPU tensor.

    With `mesh` (a (dp, sp) DeviceMesh, parallel/mesh.py::make_mesh) the
    step is sharded: each rank of the mesh takes its value and gradient
    from make_sharded_value_and_grad (its row tile, its sample shard, the
    gradient of the global loss replicated on every rank) and one Adam
    step on it, so every rank holds the same parameters. Every rank of
    the mesh calls it; `device` is then the rank's (the mesh's type)."""
    if mesh is not None:
        from ..parallel.mesh import rank_device

        dev = rank_device(mesh)
        vg, _ = make_sharded_value_and_grad(
            scene, mesh, target, nx=nx, ny=ny, spp=spp,
            max_depth=max_depth, T=T, set_params=set_params)
    else:
        dev = torch.device(device)
        ctx = plan_tape(scene, nx, ny, spp, max_depth=max_depth, T=T,
                        device=dev)
        plan, meta, pixf = ctx["plan"], ctx["meta"], ctx["pixf"]
        replay = make_replay(ctx)
        target = leaf_tensor(target, dev)
    seed_arr = tape_seed(key, dev)
    seed = int(seed_arr[0, 0])
    params = leaf_tensor(get_params(scene), dev).detach().clone()
    params.requires_grad_(True)
    opt = torch.optim.Adam([params], lr=lr)
    losses = []
    for _ in range(steps):
        opt.zero_grad()
        if mesh is not None:
            loss, params.grad = vg(params.detach(), seed_arr)
        else:
            with torch.no_grad():
                args = build_tables_traced(set_params(scene, params), scene,
                                           meta, dev, plan)
                tape = _tape_launch(args, pixf, seed, plan)[
                    :, mk.OUT_ROWS:, :]
            img = replay(set_params(scene, params), tape, seed_arr)
            loss = torch.mean((img - target) ** 2)
            loss.backward()
        opt.step()
        if postprocess is not None:
            with torch.no_grad():
                params.copy_(postprocess(params))
        losses.append(loss.detach())
    losses = torch.stack(losses).tolist()
    if log_fn is not None:
        for i, v in enumerate(losses):
            log_fn(i, v)
    return set_params(scene, params.detach().cpu()), losses[-1]


# distinct per-shard RNG stream offsets, the JAX package's (any odd
# constants work: the kernel's lowbias32 hash avalanches the seed)
_DP_SEED = 7919
_SP_SEED = 104729


def shard_tape_seed(seed, di: int, si: int) -> int:
    """The tape seed of shard (di, si): seed + di * 7919 + si * 104729 in
    wrapping int32 arithmetic, as the JAX package's np.int32 arithmetic
    wraps (a seed near 2^31 - 1 turns negative; the kernel hashes the
    int32's bits). `seed` is an int or a (1, 1) int32 tensor."""
    x = int(torch.as_tensor(seed).reshape(-1)[0]) + di * _DP_SEED \
        + si * _SP_SEED
    return (x + (1 << 31)) % (1 << 32) - (1 << 31)


def sharded_setup(scene: st.Scene, target, dp: int, sp: int, *, nx: int,
                  ny: int, spp: int, max_depth: int = 8, T: int = 1024,
                  device="cuda") -> dict:
    """What every shard of a (dp, sp) sharded value and gradient shares,
    under the JAX package's `aux` keys: the exact-mode plan of the whole
    image at spp / sp samples ("cfg", "meta", in "ctx" with the replay's
    other inputs), the replay, the pixel layout of one ny / dp row tile
    ("pixf_l", (n_tiles_l, 4, T)), the per-dp targets in lane layout
    ("tgt", (dp, n_tiles_l, T, 3), pad lanes zeroed) and the valid lanes
    ("valid"), "rows", "spp_shard", "dp", "sp", "n_tiles_l"."""
    if ny % dp:
        raise ValueError(f"ny={ny} must divide by dp={dp}")
    if spp % sp:
        raise ValueError(f"spp={spp} must divide by sp={sp}")
    rows, spp_shard = ny // dp, spp // sp
    device = torch.device(device)
    tabs, plan = mk.make_plan(scene, nx, ny, spp_shard, max_depth=max_depth,
                              rr_depth=None, T=T, exact=True)
    pix, _ = mk._pixel_layout(nx, rows, plan.T)
    pixf_l = torch.tensor(pix, device=device)
    n_tiles_l = pixf_l.shape[0]
    ctx = dict(scene=scene, tabs=tabs, plan=plan, meta=tabs[-1],
               pixf=pixf_l, inv=None, n_tiles=n_tiles_l, T=plan.T, nx=nx,
               ny=ny, spp=spp_shard, max_depth=max_depth, device=device)
    ii = pix[:, 0, :].astype(np.int64)
    jj = pix[:, 1, :].astype(np.int64)
    val = pix[:, 2, :] > 0
    tgt_np = leaf_tensor(target, "cpu").detach().numpy()
    tgt = np.zeros((dp, n_tiles_l, plan.T, 3), np.float32)
    for di in range(dp):
        tl = tgt_np[np.clip(jj + di * rows, 0, ny - 1), np.clip(ii, 0, nx - 1)]
        tgt[di] = np.where(val[..., None], tl, 0.0)
    return dict(ctx=ctx, replay=make_replay(ctx), pixf_l=pixf_l,
                tgt=torch.tensor(tgt, device=device),
                valid=torch.tensor(val, device=device), rows=rows,
                spp_shard=spp_shard, dp=dp, sp=sp, cfg=plan, meta=tabs[-1],
                n_tiles_l=n_tiles_l)


def shard_tape(aux: dict, scene: st.Scene, di: int, si: int, seed):
    """Shard (di, si)'s tape launch at the parameters of `scene` (no
    graph): returns (its seed as a (1, 1) int32 tensor, its row tile's
    pixel layout, its (n_tiles_l, n_iters, T) tape)."""
    seed_dev = shard_tape_seed(seed, di, si)
    pixf = aux["pixf_l"].clone()
    pixf[:, 1, :] += float(di * aux["rows"])
    with torch.no_grad():
        args = build_tables_traced(scene, aux["ctx"]["scene"], aux["meta"],
                                   pixf.device, aux["cfg"])
        tape = _tape_launch(args, pixf, seed_dev, aux["cfg"])
    return (torch.tensor([[seed_dev]], dtype=torch.int32), pixf,
            tape[:, mk.OUT_ROWS:, :])


def make_sharded_value_and_grad(scene: st.Scene, mesh, target, *, nx: int,
                                ny: int, spp: int, max_depth: int = 8,
                                T: int = 1024, set_params):
    """The (dp, sp)-sharded tape + replay value and gradient over `mesh`
    (parallel/mesh.py::make_mesh): vg(params, seed) -> (loss, grads), both
    replicated on every rank of the mesh, on the rank's device. Per rank:
    one tape launch on its row tile (spp / sp samples, seed
    `shard_tape_seed(seed, di, si)`), the replay of its own lanes, one
    all-reduce of the lanes over "sp" (the sample-shard accumulation), the
    loss sum over dp of the squared error / (ny nx 3), and the gradient of
    that global loss: each rank backpropagates into its own lanes only
    (its image is the detached all-reduced sum plus its lanes minus
    themselves, exactly the sum in value), and one sum of the gradients
    over both axes gives the whole. `seed` is an int or the (1, 1) int32
    tensor of tape_seed. Also returns the aux dict of `sharded_setup`.
    Every rank of the mesh calls it and vg; raises on a rank outside it."""
    from ..parallel.mesh import mesh_shape, rank_device

    dp, sp = mesh_shape(mesh)
    coord = mesh.get_coordinate()
    if coord is None:
        raise ValueError("this rank is not in the mesh")
    di, si = (int(c) for c in coord)
    dev = rank_device(mesh)
    aux = sharded_setup(scene, target, dp, sp, nx=nx, ny=ny, spp=spp,
                        max_depth=max_depth, T=T, device=dev)
    replay, valid, tgt = aux["replay"], aux["valid"], aux["tgt"][di]
    sp_group, dp_group = mesh.get_group("sp"), mesh.get_group("dp")
    denom = float(ny * nx * 3)

    def vg(params, seed):
        p = leaf_tensor(params, dev).detach().clone().requires_grad_(True)
        seed_dev, pixf, tape = shard_tape(aux, set_params(scene, p.detach()),
                                          di, si, seed)
        lanes = replay.lanes(set_params(scene, p), tape, seed_dev, pixf)
        total = lanes.detach().clone(memory_format=torch.contiguous_format)
        dist.all_reduce(total, group=sp_group)
        img = (total + (lanes - lanes.detach())) / float(spp)
        diff = torch.where(valid[..., None], img - tgt, 0.0)
        sq = torch.sum(diff * diff)
        (sq / denom).backward()
        loss = sq.detach().clone().reshape(1)
        dist.all_reduce(loss, group=dp_group)
        g = p.grad
        dist.all_reduce(g, group=sp_group)
        dist.all_reduce(g, group=dp_group)
        return loss[0] / denom, g

    return vg, aux


# meta fields the launch plan was specialised on: a re-tape whose rebuilt
# meta disagrees here would run the kernel with stale static branches
_CFG_STATIC_KEYS = ("S", "C", "SB", "uniform_time", "ut_t0", "ut_idt",
                    "moving_axes", "moving", "lens", "has_metal",
                    "has_dielectric", "bg_gradient", "has_spheres",
                    "has_light", "has_checker", "has_noise", "noise_modes",
                    "has_image", "n_img", "img_hw", "has_iso",
                    "clus_moving", "R", "rect_axes", "rect_rot",
                    "rect_trans", "rect_tf", "L", "light_kinds",
                    "light_axes", "light_rot", "light_trans", "V",
                    "med_kinds", "med_rot", "med_trans")


def _retabbed(ctx: dict, scene: st.Scene) -> dict:
    """ctx with tables rebuilt for an updated concrete scene under the
    ORIGINAL slot layout (meta["slot_ext"] pins build_tables' order: the
    Morton sort and the radius block order follow the geometry, so an
    unpinned rebuild could reshuffle the slots a replay decodes the tape
    with). Cluster AABBs follow the current geometry; the plan's static
    fields must not change."""
    meta = ctx["meta"]
    tabs = mk.build_tables(scene, ctx["plan"].SB,
                           order_override=meta["slot_ext"])
    new_meta = tabs[-1]
    for k in _CFG_STATIC_KEYS:
        if new_meta[k] != meta[k]:
            raise ValueError(
                f"re-tape changed static plan field {k!r}: {meta[k]!r} -> "
                f"{new_meta[k]!r}; parameter updates that flip the kernel's "
                "specialisation (e.g. introducing motion or a new texture "
                "mode) need a fresh plan_tape")
    new = {k: v for k, v in ctx.items() if k != "args"}
    new.update(tabs=tabs, scene=scene)
    return new
