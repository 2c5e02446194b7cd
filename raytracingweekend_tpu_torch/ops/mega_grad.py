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
backward an index_add), and its float64 twin (`ctx["f64"]`) and sharded
value-and-grad (`make_sharded_value_and_grad`) are not ported (ROADMAP
Queue 1, "Image I/O, validation and extras" and "Parallel").

Entry points take `device` ("cuda" by default: the kernel makes the tape;
"cpu" runs the plain version).
"""
from __future__ import annotations

import functools

import torch

from ..models import scene_types as st
from ..utils import prng
from . import megakernel as mk
from . import noise as _noise
from .packing import leaf_tensor

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
    tile index, as the kernel's are."""
    plan, meta, base = ctx["plan"], ctx["meta"], ctx["scene"]

    def replay_lanes(scene: st.Scene, tape: torch.Tensor, seed_arr,
                     pixf: torch.Tensor) -> torch.Tensor:
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
    returns, bit for bit); texels stay the scene's float32 images."""
    images = (leaf_tensor(scene.textures.images, device) if plan.img_hw
              else torch.zeros((1, 1, 1, 3), dtype=torch.float32,
                               device=device))
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
    CPU tensor."""
    if mesh is not None:
        raise NotImplementedError(
            "the sharded gradient (mesh=) waits for the port of "
            "parallel/ (ROADMAP Queue 1, Parallel)")
    ctx = plan_tape(scene, nx, ny, spp, max_depth=max_depth, T=T,
                    device=device)
    dev, plan, meta, pixf = ctx["device"], ctx["plan"], ctx["meta"], \
        ctx["pixf"]
    replay = make_replay(ctx)
    seed_arr = tape_seed(key, dev)
    seed = int(seed_arr[0, 0])
    params = leaf_tensor(get_params(scene), dev).detach().clone()
    params.requires_grad_(True)
    opt = torch.optim.Adam([params], lr=lr)
    target = leaf_tensor(target, dev)
    losses = []
    for _ in range(steps):
        with torch.no_grad():
            args = build_tables_traced(set_params(scene, params), scene,
                                       meta, dev, plan)
            tape = _tape_launch(args, pixf, seed, plan)[:, mk.OUT_ROWS:, :]
        opt.zero_grad()
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
