"""The port's differentiable megakernel path (ops/mega_grad.py, kernel K6)
on the CPU, after tests/test_mega_grad.py: the tape comes from the plain
version of the megakernel, the replay is its tape mode under autograd.

- the replay reproduces the tape-mode image (bit for bit on one device;
  the JAX package's gate is rtol 1e-3 / atol 5e-5);
- gradients match central finite differences through the tape forward at
  the perturbed parameters (re-taped, same key), at the JAX tests'
  scenes, keys, epsilons and tolerances;
- build_tables_traced equals build_tables bit for bit; _retabbed pins the
  slot layout; fit_scene_params_mega recovers a wall colour.

The replay against the JAX package's replay on JAX's own tape, and exact
mode at T = 1024 against JAX's tape, are in test_torch_mega_grad_jax.py.
"""
import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from raytracingweekend_tpu_torch.models import builder  # noqa: E402
from raytracingweekend_tpu_torch.models import scene_types as st  # noqa: E402
from raytracingweekend_tpu_torch.models.scenes import make_scene  # noqa: E402
from raytracingweekend_tpu_torch.ops import mega_grad as mg  # noqa: E402
from raytracingweekend_tpu_torch.ops import megakernel as mk  # noqa: E402
from raytracingweekend_tpu_torch.utils import prng  # noqa: E402

torch.set_num_threads(2)

RTOL, ATOL = 1e-3, 5e-5


def _with(scene, table, **leaves):
    return dataclasses.replace(scene, **{table: dataclasses.replace(
        getattr(scene, table), **leaves)})


def _loss(img):
    return torch.mean(img ** 2)


def _plan(scene, nx, ny, spp, depth, T=256):
    return mg.plan_tape(scene, nx, ny, spp, max_depth=depth, T=T,
                        device="cpu")


@pytest.mark.parametrize("name", ["random_balls", "cornell_box",
                                  "cornell_smoke"])
def test_replay_matches_tape_image(name):
    """The replay of the plain version's tape gives the tape-mode image:
    bit for bit (it is the same arithmetic on the same device), and so
    inside the JAX package's replay gate."""
    scene = make_scene(name, 1.0)
    ctx = _plan(scene, 16, 16, 4, 5)
    img, tape, seed = mg.tape_forward(prng.key(3), ctx)
    img2 = mg.make_replay(ctx)(scene, tape, seed)
    assert torch.equal(img, img2)
    assert torch.allclose(img, img2, rtol=RTOL, atol=ATOL)
    assert tape.shape == (ctx["n_tiles"], 20, 256)
    assert bool((tape >= 0).any())


def test_replay_perlin_multi_tile():
    """Several tiles, Perlin noise: each tile keys its own streams."""
    scene = make_scene("two_perlin_spheres", 1.0)
    ctx = _plan(scene, 32, 32, 2, 4, T=512)
    assert ctx["n_tiles"] >= 2
    img, tape, seed = mg.tape_forward(prng.key(7), ctx)
    assert torch.equal(img, mg.make_replay(ctx)(scene, tape, seed))


def test_replay_lanes_of_a_block():
    """replay.lanes on a block of tiles gives that block's lane sums: two
    half blocks (the second with its j already offset) sum to the whole
    image's lanes, with each block's tiles keyed from 0 as a shard's
    would be (so they are compared with a launch over that block)."""
    scene = make_scene("cornell_box", 1.0)
    ctx = _plan(scene, 16, 16, 2, 3, T=64)
    img, tape, seed = mg.tape_forward(prng.key(1), ctx)
    replay = mg.make_replay(ctx)
    full = replay.lanes(scene, tape, seed, ctx["pixf"])
    assert torch.equal(full.reshape(-1, 3)[ctx["inv"]].reshape(16, 16, 3)
                       / 2.0, img)
    half = ctx["n_tiles"] // 2
    pix_b = ctx["pixf"][half:]
    out_b = mk.trace_mega_reference(pix_b, *mk.table_tensors(
        ctx["tabs"], scene, ctx["plan"], "cpu"), int(seed[0, 0]),
        ctx["plan"])
    lanes_b = replay.lanes(scene, out_b[:, mk.OUT_ROWS:], seed, pix_b)
    assert torch.equal(lanes_b, out_b[:, 0:3].transpose(1, 2))


# ---- finite differences through the tape forward (test_mega_grad.py) ------

def _kernel_loss(scene, ctx, key):
    """mean(img^2) of the tape forward at `scene`, summed in float64: a
    float32 sum rounds the loss by ~3e-8, which at eps = 1e-4 moves a
    central difference by ~1.5e-4 (6% of the radius gradient below)."""
    img, _, _ = mg.tape_forward(key, mg._retabbed(ctx, scene))
    return float(_loss(img.double()))


def _fd_check(scene, ctx, key, table, field, picks, eps, rtol, atol,
              also=()):
    """Replay gradient of mean(img^2) w.r.t. scene.table.field against
    central differences through the tape forward at the perturbed
    parameters (re-taped under the pinned layout, same key). `also`
    fields are set to the same array (center1 of static spheres)."""
    _, tape, seed = mg.tape_forward(key, ctx)
    replay = mg.make_replay(ctx)
    p0 = np.asarray(getattr(getattr(scene, table), field), np.float32)

    def set_p(arr):
        return _with(scene, table, **{field: arr, **{a: arr for a in also}})

    p = torch.tensor(p0, requires_grad=True)
    _loss(replay(set_p(p), tape, seed)).backward()
    g = p.grad.numpy()
    fd_list, an_list = [], []
    for idx in picks:
        pp, pm = p0.copy(), p0.copy()
        pp[idx] += eps
        pm[idx] -= eps
        # divided by the step the float32 entries really take
        fd_list.append((_kernel_loss(set_p(pp), ctx, key)
                        - _kernel_loss(set_p(pm), ctx, key))
                       / (float(pp[idx]) - float(pm[idx])))
        an_list.append(float(g[idx]))
    np.testing.assert_allclose(fd_list, an_list, rtol=rtol, atol=atol)
    return g


def test_fd_texture_colors_cornell():
    scene = make_scene("cornell_box", 1.0)
    ctx = _plan(scene, 16, 16, 4, 5)
    g = _fd_check(scene, ctx, prng.key(3), "textures", "color",
                  [(1, 0), (1, 1), (3, 2), (0, 0)], eps=1e-3, rtol=2e-3,
                  atol=1e-6)
    assert np.abs(g).sum() > 0.0


def _mis_fd_scene():
    """Lambertian sphere under a rect light on black (test_mega_grad.py's
    smooth MIS scene)."""
    b = builder.SceneBuilder()
    red = b.lambertian(b.constant((0.8, 0.2, 0.2)))
    lightm = b.diffuse_light(b.constant((4.0, 4.0, 4.0)))
    b.sphere((0.0, 0.0, 0.0), 1.0, red)
    h = b.rect("xz", -1.0, 1.0, -1.0, 1.0, 2.5, lightm)
    b.add_light(h)
    b.camera((0, 1, 6), (0, 0, 0), (0, 1, 0), 30.0, 1.0, 0.0, 6.0, 0.0, 1.0)
    return b.build(background=st.BG_BLACK, name="fd_mis")


def test_fd_sphere_center_through_mis():
    scene = _mis_fd_scene()
    ctx = _plan(scene, 16, 16, 6, 5)
    _fd_check(scene, ctx, prng.key(5), "spheres", "center0",
              [(0, 0), (0, 1), (0, 2)], eps=5e-4, rtol=3e-2, atol=1e-7,
              also=("center1",))


def test_fd_ior_scene_level():
    scene = make_scene("dielectric", 2.0)
    ctx = _plan(scene, 24, 12, 6, 6)
    _fd_check(scene, ctx, prng.key(11), "materials", "ref_idx", [(2,)],
              eps=2e-3, rtol=5e-2, atol=1e-7)


def test_fd_radius_and_fuzz():
    scene = make_scene("dielectric", 2.0)
    ctx = _plan(scene, 24, 12, 4, 5)
    _fd_check(scene, ctx, prng.key(2), "spheres", "radius", [(1,)],
              eps=1e-4, rtol=8e-2, atol=1e-7)
    _fd_check(scene, ctx, prng.key(2), "materials", "fuzz", [(3,)],
              eps=2e-3, rtol=5e-2, atol=1e-7)


def test_fd_camera_origin():
    scene = _mis_fd_scene()
    ctx = _plan(scene, 16, 16, 6, 5)
    _fd_check(scene, ctx, prng.key(13), "camera", "origin",
              [(0,), (1,), (2,)], eps=3e-3, rtol=3e-2, atol=1e-7)


def _rho_fd_scene():
    """Marble-textured isotropic medium over a ground sphere."""
    b = builder.SceneBuilder()
    iso = b.isotropic(b.noise(scale=2.0, mode=st.NOISE_MARBLE))
    b.constant_medium_sphere((0.0, 0.0, 0.0), 1.5, 1.2, iso)
    ground = b.lambertian(b.constant((0.4, 0.5, 0.6)))
    b.sphere((0.0, -101.5, 0.0), 100.0, ground)
    b.camera((0, 0.5, 6), (0, 0, 0), (0, 1, 0), 30.0, 1.0, 0.0, 6.0, 0.0, 1.0)
    return b.build(background=st.BG_GRADIENT, name="fd_rho")


def test_fd_medium_density():
    scene = _rho_fd_scene()
    ctx = _plan(scene, 16, 16, 4, 5)
    _fd_check(scene, ctx, prng.key(17), "media", "density", [(0,)],
              eps=1e-4, rtol=3e-2, atol=1e-7)


def test_fd_noise_scale():
    scene = make_scene("two_perlin_spheres", 1.0)
    ctx = _plan(scene, 16, 16, 4, 4)
    _fd_check(scene, ctx, prng.key(8), "textures", "scale", [(0,)],
              eps=1e-3, rtol=5e-2, atol=1e-6)


def test_fd_image_texels():
    """Texels enter only through the albedo: analytic == FD at the two
    hottest texels."""
    scene = make_scene("earth", 1.0)
    assert scene.textures.images is not None
    ctx = _plan(scene, 16, 16, 4, 4)
    key = prng.key(6)
    _, tape, seed = mg.tape_forward(key, ctx)
    p0 = np.asarray(scene.textures.images, np.float32)
    p = torch.tensor(p0, requires_grad=True)
    _loss(mg.make_replay(ctx)(_with(scene, "textures", images=p), tape,
                              seed)).backward()
    g = p.grad.numpy()
    assert np.abs(g).sum() > 0.0
    eps = 5e-3
    for fi in np.argsort(np.abs(g).ravel())[::-1][:2]:
        idx = np.unravel_index(fi, g.shape)
        pp, pm = p0.copy(), p0.copy()
        pp[idx] += eps
        pm[idx] -= eps
        fd = (_kernel_loss(_with(scene, "textures", images=pp), ctx, key)
              - _kernel_loss(_with(scene, "textures", images=pm), ctx, key)
              ) / (float(pp[idx]) - float(pm[idx]))
        np.testing.assert_allclose(fd, g[idx], rtol=3e-2, atol=1e-9)


# ---- tables, re-taping, fitting -------------------------------------------

@pytest.mark.parametrize("name", ["random_balls", "cornell_box",
                                  "cornell_smoke", "two_perlin_spheres",
                                  "earth", "light_sample"])
def test_build_tables_traced_matches_eager(name):
    """The torch table builder, on a scene with tensor leaves, equals
    build_tables bit for bit under the pinned layout, and carries the
    leaves' gradient."""
    scene = make_scene(name, 1.0)
    ctx = _plan(scene, 8, 8, 2, 3, T=128)
    eager = mk.table_tensors(ctx["tabs"], scene, ctx["plan"], "cpu")
    col = torch.tensor(np.asarray(scene.textures.color, np.float32),
                       requires_grad=True)
    traced = mg.build_tables_traced(_with(scene, "textures", color=col),
                                    scene, ctx["meta"], "cpu", ctx["plan"])
    names = ("cam", "sph", "attr", "clus", "rect", "light", "med", "perm",
             "ranvec", "images")
    for nm, a, b in zip(names, eager, traced):
        assert a.shape == b.shape and a.dtype == b.dtype, nm
        assert torch.equal(a.view(torch.int32) if a.is_floating_point()
                           else a, b.detach().view(torch.int32)
                           if b.is_floating_point() else b), nm
    assert traced[2].requires_grad


def test_retab_pins_slot_layout():
    """A re-tape at moved geometry keeps the slot layout its tape codes
    name (an unpinned rebuild would reorder the slots), and the replay
    made on the original plan reproduces the re-taped forward."""
    scene = make_scene("random_balls", 1.0)
    ctx = _plan(scene, 8, 8, 2, 3, T=128)
    c0 = np.asarray(scene.spheres.center0).copy()
    live = np.nonzero(np.asarray(scene.spheres.active))[0]
    c0[live[3]] = c0[live[-1]] + np.asarray([0.5, 0.0, 0.5], np.float32)
    moved = _with(scene, "spheres", center0=c0, center1=c0 + (
        np.asarray(scene.spheres.center1) - np.asarray(scene.spheres.center0)))
    unpinned = mk.build_tables(moved, ctx["plan"].SB)[-1]
    assert not np.array_equal(unpinned["slot_ext"], ctx["meta"]["slot_ext"])
    c2 = mg._retabbed(ctx, moved)
    np.testing.assert_array_equal(c2["tabs"][-1]["slot_ext"],
                                  ctx["meta"]["slot_ext"])
    img, tape, seed = mg.tape_forward(prng.key(1), c2)
    img2 = mg.make_replay(ctx)(moved, tape, seed)
    assert torch.allclose(img, img2, rtol=2e-4, atol=2e-5)
    with pytest.raises(ValueError, match="static plan field"):
        mg._retabbed(ctx, dataclasses.replace(moved,
                                              background=st.BG_BLACK))


def test_render_diff_mega_closure():
    scene = make_scene("cornell_box", 1.0)
    img, diff = mg.render_diff_mega(scene, prng.key(4), 8, 8, 2,
                                    max_depth=3, T=64, device="cpu")
    col = torch.tensor(np.asarray(scene.textures.color, np.float32),
                       requires_grad=True)
    img2 = diff(_with(scene, "textures", color=col))
    assert torch.equal(img, img2.detach())
    img2.sum().backward()
    assert torch.isfinite(col.grad).all() and bool((col.grad != 0).any())


def test_fit_scene_params_mega_converges():
    """tests/test_mega_grad.py:431-457: recover a perturbed wall colour by
    gradient descent, one tape launch and one replay gradient a step."""
    scene = make_scene("cornell_box", 1.0)
    key = prng.key(0)
    ctx = _plan(scene, 12, 12, 4, 4)
    target, _, _ = mg.tape_forward(key, ctx)
    color = np.asarray(scene.textures.color, np.float32)
    bad_c = color.copy()
    bad_c[1] = 0.2
    losses = []
    fitted, final = mg.fit_scene_params_mega(
        _with(scene, "textures", color=bad_c), target,
        get_params=lambda sc: sc.textures.color,
        set_params=lambda sc, p: _with(sc, "textures", color=p),
        key=key, nx=12, ny=12, spp=4, max_depth=4, T=256, steps=12, lr=0.08,
        postprocess=lambda p: torch.clamp_min(p, 0.0),
        log_fn=lambda i, v: losses.append(v), device="cpu")
    assert len(losses) == 12
    assert final < losses[0] * 0.5, (losses[0], final)
    rec = np.asarray(fitted.textures.color[1])
    assert np.abs(rec - color[1]).max() < 0.25, (rec, color[1])


def test_fit_scene_params_mega_mesh_is_not_ported():
    """The sharded fit (mesh=) is ported (tests/test_torch_parallel.py
    runs it on four ranks); what it does not take is a mesh other than
    parallel/mesh.py's (dp, sp) DeviceMesh."""
    scene = make_scene("cornell_box", 1.0)
    with pytest.raises(TypeError, match=r"\(dp, sp\) DeviceMesh"):
        mg.fit_scene_params_mega(
            scene, np.zeros((4, 4, 3), np.float32),
            get_params=lambda sc: sc.textures.color,
            set_params=lambda sc, p: _with(sc, "textures", color=p),
            key=prng.key(0), nx=4, ny=4, spp=1, mesh=object(), device="cpu")
