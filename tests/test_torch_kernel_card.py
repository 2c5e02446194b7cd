"""The CUDA megakernel against its plain PyTorch version, on the card.

Marked `cuda`: these tests skip without an NVIDIA GPU. They import no JAX,
so they run where the card is, without the suite's conftest (which
imports JAX): `python -m pytest --noconftest -m cuda
tests/test_torch_kernel_card.py`."""
import pytest

torch = pytest.importorskip("torch")

from raytracingweekend_tpu_torch.models import probe_scenes  # noqa: E402
from raytracingweekend_tpu_torch.models.scenes import make_scene  # noqa: E402
from raytracingweekend_tpu_torch.ops import megakernel as tk  # noqa: E402

RTOL, ATOL = 1e-3, 5e-5


# Cornell variants: rects, rect and sphere lights with MIS, emission (K2),
# constant media (K3)
CORNELL = {"cornell_box": ("cornell_box", {}),
           "cornell_box_glassless": ("cornell_box", {"glass_sphere": False}),
           "cornell_box_aluminum": ("cornell_box", {"aluminum_box": True}),
           "cornell_smoke": ("cornell_smoke", {})}
# texture scenes (K4): the five scenes of the library and the builder mix
TEXTURES = ("light_sample", "two_perlin_spheres", "checker_spheres",
            "earth", "earth_rect", "texture_mix")


def _scene(name):
    from raytracingweekend_tpu_torch.models import builder, scene_types
    if name in ("shutter", "nested", "texture_mix", "rect_tie"):
        return getattr(probe_scenes, f"{name}_scene")(builder, scene_types)
    if name in CORNELL:
        base, kw = CORNELL[name]
        return make_scene(base, 1.0, **kw)
    return make_scene(name, 1.0)


@pytest.mark.cuda
@pytest.mark.parametrize("name", ["random_balls", "shutter", *CORNELL,
                                  "nested", *TEXTURES])
@pytest.mark.parametrize("exact", [True, False])
def test_kernel_matches_plain_version_on_card(exact, name):
    """On the card: the CUDA kernel against its plain PyTorch version on
    the same tensors (exact mode: tapes and radiance; overdraw: every
    output row). Skips without a card."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU")
    scene = _scene(name)
    _, plan = tk.make_plan(scene, 64, 64, 4, max_depth=8, T=256,
                           exact=exact)
    assert plan.surfaces == (name not in ("random_balls", "shutter"))
    if name in ("random_balls", "shutter"):
        assert plan.uniform_time == (name != "shutter")
    args, _ = tk.device_inputs(scene, plan, "cuda")
    pixf = args[0]
    out_k = tk.mega_kernel(*args, 31337, plan)
    out_r = tk.trace_mega_reference(*args, 31337, plan)
    torch.cuda.synchronize()
    if exact:
        same = (out_k[:, 8:] == out_r[:, 8:]).all(dim=1)
        valid = pixf[:, 2] > 0
        assert (same & valid).sum().item() >= 0.99 * valid.sum().item()
        a = out_k[:, 0:3].transpose(1, 2)[same]
        b = out_r[:, 0:3].transpose(1, 2)[same]
        assert torch.allclose(a, b, rtol=RTOL, atol=ATOL)
    else:
        close = torch.isclose(out_k[:, :6], out_r[:, :6], rtol=RTOL,
                              atol=ATOL).all(dim=1)
        assert close.float().mean().item() >= 0.99


def _mask_scene(name):
    """A sphere-only scene for each slot-loop mask: static (dielectric,
    and random_balls_large(n=16) swept densely, 264 slots), y only
    (random_balls), all axes with per-slot shutters (the probe
    `shutter`)."""
    if name == "random_balls_large":
        return make_scene(name, 1.0, n=16)
    return _scene(name)


@pytest.mark.cuda
@pytest.mark.parametrize("name,axes", [("dielectric", 0),
                                       ("random_balls_large", 0),
                                       ("random_balls", 2), ("shutter", 7)])
@pytest.mark.parametrize("exact", [True, False])
def test_dense_masks_match_plain_version_on_card(exact, name, axes):
    """Each instantiation of the dense slot loop (static, y only, all
    axes) against the plain version on the same tensors: exact mode's
    tapes on >= 99% of lanes and their radiance; overdraw's rows 0-5 on
    >= 99% of lanes, rows 6-7 exactly."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU")
    scene = _mask_scene(name)
    _, plan = tk.make_plan(scene, 64, 64, 4, max_depth=8, exact=exact,
                           cull=False)
    assert tk.sweep_axes(plan) == axes and not plan.surfaces
    args, _ = tk.device_inputs(scene, plan, "cuda")
    valid = args[0][:, 2] > 0
    before = tk.KERNEL_LAUNCHES["K1"]
    out_k = tk.mega_kernel(*args, 4242, plan)
    assert tk.KERNEL_LAUNCHES["K1"] == before + 1
    out_r = tk.trace_mega_reference(*args, 4242, plan)
    torch.cuda.synchronize()
    if exact:
        same = (out_k[:, 8:] == out_r[:, 8:]).all(dim=1) & valid
        assert same.sum().item() >= 0.99 * valid.sum().item()
        a = out_k[:, 0:3].transpose(1, 2)[same]
        b = out_r[:, 0:3].transpose(1, 2)[same]
        assert torch.allclose(a, b, rtol=RTOL, atol=ATOL)
    else:
        close = torch.isclose(out_k[:, :6], out_r[:, :6], rtol=RTOL,
                              atol=ATOL).all(dim=1)[valid]
        assert close.float().mean().item() >= 0.99
        assert torch.equal(out_k[:, 6:8], out_r[:, 6:8])


@pytest.mark.cuda
@pytest.mark.parametrize("name,kind", [("random_balls", "spheres"),
                                       ("cornell_box", "surfaces"),
                                       ("earth", "surfaces")])
def test_widest_dense_tile_matches_plain_version_on_card(name, kind):
    """ROADMAP F3: every dense instantiation of the library takes blocks
    of exactly DENSE_MAX_T lanes (its launch bounds); at that width an
    overdraw launch of K1 (random_balls) and of K2-K4 (cornell_box,
    earth), 512 lanes, agrees with its plain version, and T = 1024 and
    DENSE_MAX_T + 32 raise ValueError in make_plan and trace_mega before
    any launch."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU")
    assert set(tk.dense_max_threads(tk._kernel_lib())[kind]) == {
        tk.DENSE_MAX_T}
    scene = make_scene(name, 1.5)
    top = tk.DENSE_MAX_T
    for T in (1024, top + 32):
        before = dict(tk.KERNEL_LAUNCHES)
        with pytest.raises(ValueError, match=f"at most {top} lanes"):
            tk.make_plan(scene, 96, 64, 4, max_depth=8, T=T)
        with pytest.raises(ValueError, match=f"at most {top} lanes"):
            tk.trace_mega(1, scene, 96, 64, 4, max_depth=8, T=T)
        assert tk.KERNEL_LAUNCHES == before
    _, plan = tk.make_plan(scene, 96, 64, 4, max_depth=8, T=top)
    args, _ = tk.device_inputs(scene, plan, "cuda")
    out_k = tk.mega_kernel(*args, 777, plan)
    out_r = tk.trace_mega_reference(*args, 777, plan)
    torch.cuda.synchronize()
    assert out_k.shape[2] == top
    valid = args[0][:, 2] > 0
    close = torch.isclose(out_k[:, :6], out_r[:, :6], rtol=RTOL,
                          atol=ATOL).all(dim=1)[valid]
    assert close.float().mean().item() >= 0.99


@pytest.mark.cuda
@pytest.mark.parametrize("name", ["random_balls_large", "random_balls_huge"])
@pytest.mark.parametrize("exact", [True, False])
def test_culled_kernel_matches_plain_version_on_card(exact, name):
    """The culled kernel (K5) against its plain version on the same
    tensors: tapes, radiance, the swept-block counts of row 6 and the
    needed-block counts of row 7, lane by lane, on a launch whose visits
    fall on both sides of K_BCAST (the compacted and the broadcast
    sweep). Skips without a card."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU")
    scene = make_scene(name, 1.0)
    _, plan = tk.make_plan(scene, 64, 64, 2, max_depth=8, exact=exact)
    assert plan.cull and plan.dyn_order == (0 if exact else 16)
    args, _ = tk.device_inputs(scene, plan, "cuda")
    valid = args[0][:, 2] > 0
    out_k = tk.mega_kernel(*args, 31337, plan)
    hist = torch.zeros(33, dtype=torch.int64, device="cuda")
    out_r = tk.trace_mega_reference(*args, 31337, plan, need_hist=hist)
    torch.cuda.synchronize()
    visits = tk.visits_by_branch(hist)
    assert visits["compacted"] > 0 and visits["broadcast"] > 0
    rows = slice(0, None) if exact else slice(0, 8)
    same = (out_k[:, rows] == out_r[:, rows]).all(dim=1) & valid
    assert same.sum().item() >= 0.99 * valid.sum().item()
    a = out_k[:, 0:3].transpose(1, 2)[valid]
    b = out_r[:, 0:3].transpose(1, 2)[valid]
    assert torch.isclose(a, b, rtol=RTOL, atol=ATOL).all(
        dim=-1).float().mean().item() >= 0.99


@pytest.mark.cuda
@pytest.mark.parametrize("dyn_order", [0, 16])
@pytest.mark.parametrize("exact", [True, False])
def test_culled_kernel_equals_dense_kernel(exact, dyn_order):
    """Culling skips only clusters that cannot hold the winner: on
    random_balls_large(n=30) (SB 128, C = 8) the culled kernel's image,
    sample counts and tapes equal the dense kernel's bit for bit, with
    fewer blocks swept. Skips without a card."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU")
    scene = make_scene("random_balls_large", 1.0, n=30)
    kw = dict(max_depth=8, exact=exact, SB=128, device="cuda")
    dense = tk.trace_mega(5, scene, 96, 64, 4, cull=False, **kw)
    culled = tk.trace_mega(5, scene, 96, 64, 4, dyn_order=dyn_order, **kw)
    assert torch.equal(culled.image, dense.image)
    assert culled.segments.item() == dense.segments.item()
    assert culled.lane_iters.item() == dense.lane_iters.item()
    if exact:
        assert torch.equal(culled.tape, dense.tape)
    assert 0 < culled.blocks.item() < dense.blocks.item()
    assert 0 < culled.lane_need.item() <= culled.blocks.item()


@pytest.mark.cuda
@pytest.mark.parametrize("exact", [True, False])
def test_culled_kernel_one_lane_a_warp_on_card(exact):
    """The compacted sweep alone: random_balls_large(n=30) at 64x64 with
    the valid row of pixf zeroed on 31 lanes of every 32, so every visit
    has one needing lane (invalid lanes start done). The kernel equals its
    plain version on rows 0-7 (and the tapes) and the dense kernel on rows
    0-5. Skips without a card."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU")
    scene = make_scene("random_balls_large", 1.0, n=30)
    kw = dict(max_depth=8, exact=exact)
    _, plan = tk.make_plan(scene, 64, 64, 2, **kw)
    _, dense = tk.make_plan(scene, 64, 64, 2, cull=False, **kw)
    assert plan.cull and not dense.cull
    args, _ = tk.device_inputs(scene, plan, "cuda")
    pixf = args[0].clone()
    lone = torch.arange(pixf.shape[2], device="cuda") % 32 == 0
    pixf[:, 2, ~lone] = 0.0
    out_k = tk.mega_kernel(pixf, *args[1:], 31337, plan)
    out_d = tk.mega_kernel(pixf, *args[1:], 31337, dense)
    hist = torch.zeros(33, dtype=torch.int64, device="cuda")
    out_r = tk.trace_mega_reference(pixf, *args[1:], 31337, plan,
                                    need_hist=hist)
    torch.cuda.synchronize()
    assert hist[1].item() > 0 and hist[2:].sum().item() == 0
    valid = pixf[:, 2] > 0
    same = (out_k == out_r).all(dim=1) & valid
    assert same.sum().item() >= 0.99 * valid.sum().item()
    assert torch.equal(out_k[:, :6], out_d[:, :6])
    assert torch.equal(out_k[:, 7][valid], out_k[:, 6][valid])


def _mixed(n=60, **kw):
    """The probe scene of the culled surfaces kernel (K5s)."""
    from raytracingweekend_tpu_torch.models import builder, scene_types
    return probe_scenes.large_mixed_scene(builder, scene_types, n=n,
                                          aspect=1.0, **kw)


# the probe's variants: checker ground (kTex) with static balls; constant
# ground (no kTex) with moving balls; both
MIXED = {"textured": {}, "moving": {"textured": False, "moving": True},
         "textured_moving": {"moving": True}}


@pytest.mark.cuda
@pytest.mark.parametrize("variant", list(MIXED))
@pytest.mark.parametrize("exact", [True, False])
def test_culled_surfaces_kernel_matches_plain_version_on_card(exact,
                                                             variant):
    """The culled surfaces kernel (K5s) against its plain version on
    large_mixed(n=60) (C = 29 in overdraw, 15 in exact mode): tapes,
    radiance, the swept-block counts of row 6 and the needed-block counts
    of row 7, lane by lane, in both kTex instantiations, on a launch
    whose visits fall on both sides of K_BCAST. Skips without a card."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU")
    scene = _mixed(**MIXED[variant])
    _, plan = tk.make_plan(scene, 64, 64, 2, max_depth=8, exact=exact)
    assert plan.cull and plan.surfaces and plan.R == plan.L == plan.V == 1
    assert plan.textures == (variant != "moving")
    assert plan.dyn_order == (0 if exact else 16)
    args, _ = tk.device_inputs(scene, plan, "cuda")
    valid = args[0][:, 2] > 0
    before = tk.KERNEL_LAUNCHES["K5s"]
    out_k = tk.mega_kernel(*args, 31337, plan)
    assert tk.KERNEL_LAUNCHES["K5s"] == before + 1
    hist = torch.zeros(33, dtype=torch.int64, device="cuda")
    out_r = tk.trace_mega_reference(*args, 31337, plan, need_hist=hist)
    torch.cuda.synchronize()
    visits = tk.visits_by_branch(hist)
    assert visits["compacted"] > 0 and visits["broadcast"] > 0
    rows = slice(0, None) if exact else slice(0, 8)
    same = (out_k[:, rows] == out_r[:, rows]).all(dim=1) & valid
    assert same.sum().item() >= 0.99 * valid.sum().item()
    a = out_k[:, 0:3].transpose(1, 2)[valid]
    b = out_r[:, 0:3].transpose(1, 2)[valid]
    assert torch.isclose(a, b, rtol=RTOL, atol=ATOL).all(
        dim=-1).float().mean().item() >= 0.99


@pytest.mark.cuda
@pytest.mark.parametrize("dyn_order", [0, 16])
@pytest.mark.parametrize("exact", [True, False])
@pytest.mark.parametrize("variant", ["textured", "moving"])
def test_culled_surfaces_kernel_equals_dense_kernel(variant, exact,
                                                    dyn_order):
    """On large_mixed(n=30) (SB 128, C = 8) the culled surfaces kernel's
    image, sample counts and tapes equal the dense surfaces kernel's bit
    for bit, with fewer blocks swept. Skips without a card."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU")
    scene = _mixed(n=30, **MIXED[variant])
    kw = dict(max_depth=8, exact=exact, SB=128, device="cuda")
    dense = tk.trace_mega(5, scene, 96, 64, 4, cull=False, **kw)
    culled = tk.trace_mega(5, scene, 96, 64, 4, dyn_order=dyn_order, **kw)
    assert torch.equal(culled.image, dense.image)
    assert culled.segments.item() == dense.segments.item()
    assert culled.lane_iters.item() == dense.lane_iters.item()
    if exact:
        assert torch.equal(culled.tape, dense.tape)
    assert 0 < culled.blocks.item() < dense.blocks.item()
    assert 0 < culled.lane_need.item() <= culled.blocks.item()


# the surfaces form (features, tk.F_*) each scene plans
SURFACE_FORM_OF = {
    "earth": tk.F_IMAGE, "earth_rect": tk.F_RECTS | tk.F_IMAGE,
    "two_perlin_spheres": tk.F_NOISE, "light_sample": tk.F_RECTS | tk.F_NOISE,
    "checker_spheres": tk.F_CHECKER, "cornell_box": tk.F_RECTS | tk.F_LIGHTS,
    "cornell_smoke": tk.F_SURF, "texture_mix": tk.F_ALL}


@pytest.mark.cuda
@pytest.mark.parametrize("name", list(SURFACE_FORM_OF))
@pytest.mark.parametrize("exact", [True, False])
def test_surface_forms_match_plain_version_on_card(exact, name):
    """Every static surfaces form the library builds, on the scene that
    plans it: the library exports the forms `make_plan` picks from
    (SURFACE_FORMS, each taking DENSE_MAX_T lanes), and the kernel agrees
    with its plain version (exact: tapes on >= 99% of lanes and their
    radiance; overdraw: every output row)."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU")
    lib = tk._kernel_lib()
    rows = tk.surface_forms(lib)
    assert [(a, bool(u), f) for a, u, f, *_ in rows] == list(
        tk.SURFACE_FORMS)
    assert {r[3] for r in rows} == {tk.DENSE_MAX_T}
    scene = _scene(name)
    _, plan = tk.make_plan(scene, 64, 64, 4, max_depth=8, T=256,
                           exact=exact)
    assert plan.feat == SURFACE_FORM_OF[name]
    args, _ = tk.device_inputs(scene, plan, "cuda")
    out_k = tk.mega_kernel(*args, 2024, plan)
    out_r = tk.trace_mega_reference(*args, 2024, plan)
    torch.cuda.synchronize()
    valid = args[0][:, 2] > 0
    if exact:
        same = (out_k[:, 8:] == out_r[:, 8:]).all(dim=1)
        assert (same & valid).sum().item() >= 0.99 * valid.sum().item()
        a = out_k[:, 0:3].transpose(1, 2)[same]
        b = out_r[:, 0:3].transpose(1, 2)[same]
        assert torch.allclose(a, b, rtol=RTOL, atol=ATOL)
    else:
        close = torch.isclose(out_k[:, :6], out_r[:, :6], rtol=RTOL,
                              atol=ATOL).all(dim=1)
        assert close.float().mean().item() >= 0.99


@pytest.mark.cuda
def test_rect_tie_keeps_the_lower_row_on_card():
    """rect_tie's coplanar rects tie on every ray that reaches them; the
    kernel tests group 0 (row 2) before group 1 (row 1) and must still
    record row 1, as the plain version does: the tapes are equal on every
    lane, and row 2 never wins."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU")
    scene = _scene("rect_tie")
    _, plan = tk.make_plan(scene, 64, 64, 4, max_depth=5, rr_depth=None,
                           T=256, exact=True)
    assert tk.rect_runs(plan.rect_codes)[1:4] == (2, 0, 1)
    args, _ = tk.device_inputs(scene, plan, "cuda")
    out_k = tk.mega_kernel(*args, 99, plan)
    out_r = tk.trace_mega_reference(*args, 99, plan)
    tape_k, tape_r = out_k[:, 8:], out_r[:, 8:]
    assert torch.equal(tape_k, tape_r)
    assert (tape_k == plan.S + 1).sum().item() > 1000
    assert (tape_k == plan.S + 2).sum().item() == 0


@pytest.mark.cuda
@pytest.mark.parametrize("name", ["cornell_box", "earth"])
def test_block_order_renders_the_same_tiles_on_card(name):
    """The dense surfaces kernel renders block b's tile from the layout's
    pad row (1 + tile; 0: tile b): in the layout's order, in a random
    order and in the longest-first order the wrapper learns, every output
    row is the same bit for bit."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU")
    scene = _scene(name)
    _, plan = tk.make_plan(scene, 96, 64, 4, max_depth=8, T=128)
    args, _ = tk.device_inputs(scene, plan, "cuda")
    pixf = args[0]
    pixf[:, 3, :] = 0.0
    ref = tk.mega_kernel(*args, 7, plan)           # layout order
    learned = pixf[:, 3, 0].clone()
    assert sorted(learned.long().tolist()) == list(
        range(1, pixf.shape[0] + 1))
    assert torch.equal(tk.mega_kernel(*args, 7, plan), ref)
    gen = torch.Generator(device="cpu").manual_seed(5)
    pixf[:, 3, 0] = (torch.randperm(pixf.shape[0], generator=gen) + 1).to(
        pixf)
    assert torch.equal(tk.mega_kernel(*args, 7, plan), ref)


@pytest.mark.cuda
def test_refused_launch_raises():
    """A dense sweep table past the card's 227 KB of shared memory per
    block (random_balls_large at n = 122: 16 bytes x 14976 static slots)
    is refused by CUDA, and the wrapper raises instead of returning an
    unwritten output; `make_plan` refuses such a plan before any launch. A
    culled surfaces plan with a bad C, SB or T raises too."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU")
    import dataclasses
    scene = make_scene("random_balls_large", 1.0, n=122)
    with pytest.raises(ValueError, match="shared memory"):
        tk.make_plan(scene, 8, 8, 1, cull=False)
    _, plan = tk.make_plan(scene, 8, 8, 1)
    args, _ = tk.device_inputs(scene, plan, "cuda")
    with pytest.raises(RuntimeError, match="launch failed"):
        tk.mega_kernel(*args, 1, dataclasses.replace(plan, cull=False,
                                                     dyn_order=0))
    mixed = _mixed(n=120)
    with pytest.raises(ValueError, match="shared memory"):
        tk.make_plan(mixed, 8, 8, 1, cull=False)
    _, plan = tk.make_plan(mixed, 64, 64, 1, max_depth=3)
    assert plan.cull and plan.surfaces and plan.C == 113
    args, _ = tk.device_inputs(mixed, plan, "cuda")
    with pytest.raises(RuntimeError, match="launch failed"):   # C SB != S
        tk.mega_kernel(*args, 1, dataclasses.replace(plan, SB=plan.SB + 1))
    clus2 = torch.cat([args[4], args[4]])
    with pytest.raises(RuntimeError, match="launch failed"):
        tk.mega_kernel(*args[:4], clus2, *args[5:], 1,
                       dataclasses.replace(plan, C=2 * plan.C))
    pixf48, _ = tk._device_layout(64, 64, 48, "cuda")
    with pytest.raises(ValueError, match="T % 32"):
        tk.mega_kernel(pixf48, *args[1:], 1,
                       dataclasses.replace(plan, T=48))
    out = tk.mega_kernel(*args, 1, plan)
    assert torch.isfinite(out).all()


@pytest.mark.cuda
def test_tape_mode_runs_culled_surfaces_kernel_on_card():
    """Tape mode on large_mixed(n=30) launches the culled surfaces kernel
    in exact mode at T = 1024 (SB 256, ascending votes), and the replay of
    its tape reproduces its image to the replay gate."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU")
    from raytracingweekend_tpu_torch.ops import mega_grad as tmg
    from raytracingweekend_tpu_torch.utils import prng
    scene = _mixed(n=30)
    ctx = tmg.plan_tape(scene, 32, 32, 2, max_depth=5, T=1024,
                        device="cuda")
    plan = ctx["plan"]
    assert plan.cull and plan.surfaces and plan.SB == 256
    assert plan.dyn_order == 0
    before = tk.KERNEL_LAUNCHES["K5s"]
    img, tape, seed = tmg.tape_forward(prng.key(2), ctx)
    assert tk.KERNEL_LAUNCHES["K5s"] == before + 1
    img2 = tmg.make_replay(ctx)(scene, tape, seed)
    close = torch.isclose(img2, img, rtol=RTOL, atol=ATOL).all(dim=-1)
    assert close.float().mean().item() >= 0.99


def _k7_rays(scene, n, seed):
    """n rays on the card: half camera rays, half from points near the
    scene's spheres in random directions, at shutter times in [0, 1)."""
    from raytracingweekend_tpu_torch.ops import camera as tcamera
    from raytracingweekend_tpu_torch.ops.packing import device_scene
    from raytracingweekend_tpu_torch.utils import prng
    ds = device_scene(scene, "cuda")
    gen = torch.Generator(device="cuda").manual_seed(seed)
    h = n // 2
    s, t = (torch.rand(h, device="cuda", generator=gen) for _ in range(2))
    o1, d1, tm1 = tcamera.get_rays(prng.key(seed), ds.camera, s, t)
    act = ds.spheres.active
    c = ds.spheres.center0[act]
    pick = torch.randint(0, c.shape[0], (h,), device="cuda", generator=gen)
    o2 = c[pick] + 3.0 * torch.randn((h, 3), device="cuda", generator=gen)
    d2 = torch.randn((h, 3), device="cuda", generator=gen)
    d2 = d2 / d2.norm(dim=-1, keepdim=True)
    tm2 = torch.rand(h, device="cuda", generator=gen)
    return (torch.cat([o1, o2]), torch.cat([d1, d2]), torch.cat([tm1, tm2]),
            ds)


@pytest.mark.cuda
@pytest.mark.parametrize("name,kw", [("random_balls", {}),
                                     ("cornell_box", {}),
                                     ("dielectric", {}),
                                     ("random_balls_large", {})])
def test_k7_kernel_matches_plain_version_on_card(name, kw):
    """K7 (csrc/intersect.cu) against its plain version on the same card
    tensors, bit for bit (both write the same FMAs, the plain version's
    rounded once): best_t and the int64 best_i of every ray. Covers the
    moving table (y only, one window), the hollow sphere's negative
    radius, inactive padding rows and, on random_balls_large (3840 slots),
    the table streamed through shared memory in chunks. Skips without a
    card."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU")
    from raytracingweekend_tpu_torch.ops import intersect as tint
    scene = make_scene(name, 1.5, **kw)
    o, d, tm, ds = _k7_rays(scene, 8192 + 77, 3)
    moving = scene.has_moving_spheres
    kt, ki = tint.hit_spheres_kernel(o, d, tm, ds.sphere_table, moving)
    rt, ri = tint.hit_spheres_reference(o, d, tm, ds.sphere_table, moving)
    torch.cuda.synchronize()
    hit = rt < 1e30
    assert hit.float().mean().item() > 0.02
    assert ki.dtype == torch.int64
    assert torch.equal(kt, rt) and torch.equal(ki, ri)
    # geometry.hit_spheres launches the kernel for CUDA tensors
    from raytracingweekend_tpu_torch.ops import geometry as tgeo
    before = tint.KERNEL_LAUNCHES["K7"]
    gt, gi = tgeo.hit_spheres(o, d, tm, ds)
    assert tint.KERNEL_LAUNCHES["K7"] == before + 1
    assert torch.equal(gt, kt) and torch.equal(gi, ki)


def _k7_table(kind: str, S: int, gen) -> torch.Tensor:
    """A synthetic (S, 12) K7 table on the card: spheres in a 10-unit box,
    a third inactive; `shutters` gives every slot its own window (a fifth
    with 1/dt = 0 and motion), `all_inactive` clears every active flag."""
    from raytracingweekend_tpu_torch.ops import intersect as tint
    tab = torch.zeros((S, tint.LANES), device="cuda")
    tab[:, tint.K_CX:tint.K_CZ + 1] = (torch.rand((S, 3), device="cuda",
                                                  generator=gen) - 0.5) * 10
    tab[:, tint.K_R2] = (0.3 + 0.7 * torch.rand(S, device="cuda",
                                                generator=gen)) ** 2
    tab[:, tint.K_ACT] = (torch.rand(S, device="cuda", generator=gen)
                          > 1 / 3).float()
    if kind == "shutters":
        tab[:, tint.K_DCX:tint.K_DCZ + 1] = torch.randn(
            (S, 3), device="cuda", generator=gen)
        tab[:, tint.K_T0] = 0.5 * torch.rand(S, device="cuda", generator=gen)
        idt = 1.0 / (0.2 + 0.8 * torch.rand(S, device="cuda", generator=gen))
        zero = torch.rand(S, device="cuda", generator=gen) < 0.2
        tab[:, tint.K_IDT] = torch.where(zero, 0.0, idt)
    if kind == "all_inactive":
        tab[:, tint.K_ACT] = 0.0
    return tab


@pytest.mark.cuda
@pytest.mark.parametrize("case", ["random_balls", "random_balls_large",
                                  "random_balls_huge", "ragged",
                                  "all_inactive", "shutters", "strided",
                                  "tiny_disc"])
def test_k7_kernel_bitwise_on_card(case):
    """K7 against its plain version bit for bit (best_t, int64 best_i) on
    the card: the three K7 scenes at their table sizes (S = 512, 3840,
    14592: one chunk, streamed chunks), N not a multiple of the block's
    rays (threads x rays a thread), a table of inactive slots only,
    per-slot shutters (1/dt = 0 with motion on a fifth of the slots, 1500
    slots streamed), rays that are strided views, and directions scaled
    by 1e-16 (discriminants near 1e-32, below the root's 2^-100 scaling
    threshold, hits at t ~ 1e16). Skips without a card."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU")
    from raytracingweekend_tpu_torch.ops import intersect as tint
    gen = torch.Generator(device="cuda").manual_seed(7)
    block = tint.k7_consts()
    if case.startswith("random_balls"):
        scene = make_scene(case, 1.5)
        o, d, tm, ds = _k7_rays(scene, 8192 + 77, 3)
        table, moving = ds.sphere_table, scene.has_moving_spheres
        assert table.shape[0] == {"random_balls": 512,
                                  "random_balls_large": 3840,
                                  "random_balls_huge": 14592}[case]
    else:
        scene = make_scene("random_balls", 1.5)
        n = (3 * block["threads"] * block["rays"] + 1 if case == "ragged"
             else 4096)
        o, d, tm, ds = _k7_rays(scene, n, 4)
        table, moving = ds.sphere_table, True
        if case in ("all_inactive", "shutters"):
            table = _k7_table(case, 1500, gen)
            o = (torch.rand((n, 3), device="cuda", generator=gen) - 0.5) * 12
        if case == "tiny_disc":
            d = d * 1e-16
        if case == "strided":
            wide = torch.zeros((n, 8), device="cuda")
            wide[:, 0:3], wide[:, 3:6], wide[:, 6] = o, d, tm
            o, d, tm = wide[:, 0:3], wide[:, 3:6], wide[:, 6]
            assert not o.is_contiguous()
    lay = tint.sphere_layout(table, moving)
    kt, ki = tint.hit_spheres_kernel(o, d, tm, table, moving, layout=lay)
    rt, ri = tint.hit_spheres_reference(o, d, tm, table, moving, layout=lay)
    torch.cuda.synchronize()
    hit = rt < 1e30
    if case == "all_inactive":
        assert not hit.any()
    else:
        assert hit.float().mean().item() > 0.02
    if case == "shutters":
        assert (lay.axes, lay.uniform) == (tint.AXES_ALL, False)
    if case == "tiny_disc":
        assert (kt[hit] > 1e10).all()
    assert torch.equal(kt, rt) and torch.equal(ki, ri)


@pytest.mark.cuda
@pytest.mark.parametrize("mode", ["regen", "tiled", "while"])
def test_wavefront_renders_through_k7_on_card(mode):
    """render() in a wavefront mode on the card launches K7 every
    bounce and gives a finite image near the megakernel's mean."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU")
    from raytracingweekend_tpu_torch import render as trender
    from raytracingweekend_tpu_torch.ops import intersect as tint
    from raytracingweekend_tpu_torch.utils.config import RenderConfig
    scene = make_scene("random_balls", 1.5)
    cfg = RenderConfig(nx=96, ny=64, spp=16, max_depth=20, seed=1,
                       samples_per_launch=16, loop_mode=mode, device="cuda")
    before = tint.KERNEL_LAUNCHES["K7"]
    img = trender.render(scene, cfg)
    assert tint.KERNEL_LAUNCHES["K7"] > before
    import dataclasses
    mega = trender.render(scene, dataclasses.replace(cfg, loop_mode="mega"))
    assert torch.isfinite(img).all()
    assert abs(img.mean().item() - mega.mean().item()) < 0.03 * \
        mega.mean().item()


def _k7_grads(scene, o, d, tm, ds, plain: bool):
    """Gradients of sum(t over hits) w.r.t. (radius, center0, o, d)
    through geometry.HitSpheres, its forward the kernel or (plain) its
    plain version on the same card tensors."""
    from raytracingweekend_tpu_torch.ops import geometry as tgeo
    from raytracingweekend_tpu_torch.ops import intersect as tint
    rad = ds.spheres.radius.clone().requires_grad_()
    c0 = ds.spheres.center0.clone().requires_grad_()
    o, d = o.clone().requires_grad_(), d.clone().requires_grad_()
    orig = tint.hit_spheres_kernel
    if plain:
        tint.hit_spheres_kernel = tint.hit_spheres_reference
    try:
        bt, bi = tgeo.HitSpheres.apply(
            o, d, tm, c0, ds.spheres.center1, ds.spheres.time0,
            ds.spheres.time1, rad, ds.sphere_table, scene.has_moving_spheres,
            0.001)
    finally:
        tint.hit_spheres_kernel = orig
    torch.where(bt < 1e30, bt, 0.0).sum().backward()
    return bi, [x.grad for x in (rad, c0, o, d)]


@pytest.mark.cuda
@pytest.mark.parametrize("name", ["random_balls", "cornell_box"])
def test_k7_function_gradients_on_card(name):
    """K7's VJP on the card: the Function with the kernel forward gives
    the indices and, to rtol 1e-5, the gradients of the same Function with
    the plain forward (cornell_box: one live sphere among padded rows)."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU")
    scene = make_scene(name, 1.5)
    o, d, tm, ds = _k7_rays(scene, 16384, 5)
    bi_k, g_k = _k7_grads(scene, o, d, tm, ds, plain=False)
    bi_p, g_p = _k7_grads(scene, o, d, tm, ds, plain=True)
    assert torch.equal(bi_k, bi_p)
    for a, b in zip(g_k, g_p):
        assert torch.isfinite(a).all()
        assert torch.allclose(a, b, rtol=1e-5, atol=1e-6)
    assert g_k[0].abs().sum() > 0


@pytest.mark.cuda
@pytest.mark.parametrize("name", ["cornell_box", "random_balls"])
def test_replay_matches_kernel_tape_on_card(name):
    """The replay (ops/mega_grad.py) of the CUDA kernel's tape at 32x32x4,
    depth 8, T = 1024 reproduces the kernel's image to the replay gate
    (rtol 1e-3 / atol 5e-5), with a finite texture-colour gradient."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU")
    import dataclasses

    import numpy as np

    from raytracingweekend_tpu_torch.ops import mega_grad as tmg
    from raytracingweekend_tpu_torch.utils import prng
    scene = make_scene(name, 1.0)
    ctx = tmg.plan_tape(scene, 32, 32, 4, max_depth=8, T=1024,
                        device="cuda")
    before = tk.KERNEL_LAUNCHES["K1"] + tk.KERNEL_LAUNCHES["K2+K3"]
    img, tape, seed = tmg.tape_forward(prng.key(2), ctx)
    assert tk.KERNEL_LAUNCHES["K1"] + tk.KERNEL_LAUNCHES["K2+K3"] > before
    col = torch.tensor(np.asarray(scene.textures.color, np.float32),
                       device="cuda", requires_grad=True)
    img2 = tmg.make_replay(ctx)(dataclasses.replace(
        scene, textures=dataclasses.replace(scene.textures, color=col)),
        tape, seed)
    assert torch.allclose(img2.detach(), img, rtol=RTOL, atol=ATOL)
    torch.mean(img2 ** 2).backward()
    assert torch.isfinite(col.grad).all() and col.grad.abs().sum() > 0


@pytest.mark.cuda
@pytest.mark.parametrize("variant", ["quad", "ext"])
def test_sweep_twin_kernel_matches_plain_version_on_card(variant):
    """K8 against its plain version at K = 4 on the book-1 plan (S = 488,
    T = 256, 16 blocks): every iteration count, ox row and (ext) attribute
    row bit for bit; the twin runs all K iterations."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU")
    from raytracingweekend_tpu_torch.tools import sweep_twin as tw
    soa, attr, plan = tw.book1_inputs("cuda")
    assert tk.sweep_axes(plan) == tk.AXIS_Y   # K1's book-1 instantiation
    args = (soa, attr, plan.T, 16, 4, plan.ut_t0, plan.ut_idt,
            variant == "ext")
    before = tw.KERNEL_LAUNCHES["K8"]
    out_k, attrs_k = tw.sweep_twin_kernel(*args)
    assert tw.KERNEL_LAUNCHES["K8"] == before + 1
    out_r, attrs_r = tw.sweep_twin_reference(*args)
    torch.cuda.synchronize()
    assert torch.equal(out_k, out_r)
    assert torch.all(out_k[:, 1] == 4.0)
    if variant == "ext":
        assert torch.equal(attrs_k, attrs_r)
    else:
        assert attrs_k is None


@pytest.mark.cuda
@pytest.mark.parametrize("name,body,unit", [
    ("lane16 f32 default", "lane16", "tf32"),
    ("lane16 f32 HIGHEST", "lane16", "fp32"),
    ("sub16 f32 default", "sub16", "tf32"),
    ("sub16 f32 HIGHEST", "sub16", "fp32"),
    ("extract f32 default", "extract", "tf32"),
    ("extract f32 HIGHEST", "extract", "fp32"),
    ("extract bf16", "extract", "bf16"),
    ("elemq ~25 VPU ops", "elemq", "fp32"),
    ("min+eqmask", "minmask", "fp32")])
@pytest.mark.parametrize("S", [64, 512, 1024, 1152])
def test_microbench_kernel_matches_plain_version_on_card(name, body, unit,
                                                         S):
    """Each K9 row against its plain version at T = 256, 8 steps, at S =
    64 (a row a thread, the FP32 extract's sums 4 rows a warp), 512 (the
    tool's: 8 rows a thread, 32 a warp), 1024 and 1152 (past the rows kept
    in registers: lane16 / sub16 TF32 tiles and minmask elements read from
    shared memory): the FP32 and elementwise
    rows bit for bit (the FP32 extract sums in the plain version's order),
    the tensor-core rows within `plain_tolerance` (the products' sum
    order: (terms + 2) 2^-24 of the absolute terms, twice that for
    extract)."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU")
    from raytracingweekend_tpu_torch.tools import dot_microbench as dm
    assert (name, body, unit) in dm.ROWS
    tab = dm.table_for(body, unit, dm.make_tables(S), "cuda")
    out_k = dm.microbench_kernel(body, unit, tab, S, 256, 8)
    out_r = dm.microbench_reference(body, unit, tab, S, 256, 8)
    torch.cuda.synchronize()
    assert torch.isfinite(out_k).all()
    assert torch.all((out_k - out_r).abs()
                     <= dm.plain_tolerance(body, tab))
    if unit == "fp32":
        assert torch.equal(out_k, out_r)


# the largest S (a multiple of 64) whose block the first K9 design
# launched, by its shared memory (16 columns a block: the accumulator
# 64 S bytes and the body's tables, within 227 KB)
K9_FIRST_VERSION_MAX_S = {("lane16", "tf32"): 1792, ("lane16", "fp32"): 1792,
                          ("sub16", "tf32"): 1792, ("sub16", "fp32"): 1792,
                          ("extract", "tf32"): 832, ("extract", "fp32"): 1152,
                          ("extract", "bf16"): 1344, ("elemq", "fp32"): 2304,
                          ("minmask", "fp32"): 3584}


@pytest.mark.cuda
@pytest.mark.parametrize("body,unit", sorted(K9_FIRST_VERSION_MAX_S))
def test_microbench_kernel_launches_the_first_versions_widths(body, unit):
    """Every K9 row launches at the largest S the first design did, and
    agrees there with its plain version (T = 64, 2 steps)."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU")
    from raytracingweekend_tpu_torch.tools import dot_microbench as dm
    S = K9_FIRST_VERSION_MAX_S[(body, unit)]
    tab = dm.table_for(body, unit, dm.make_tables(S), "cuda")
    out_k = dm.microbench_kernel(body, unit, tab, S, 64, 2)
    out_r = dm.microbench_reference(body, unit, tab, S, 64, 2)
    torch.cuda.synchronize()
    assert torch.isfinite(out_k).all()
    assert torch.all((out_k - out_r).abs()
                     <= dm.plain_tolerance(body, tab))
    if unit == "fp32":
        assert torch.equal(out_k, out_r)


@pytest.mark.cuda
def test_tool_kernels_raise_on_refused_launches():
    """A launch the card refuses raises, and leaves no error behind: K8
    past 1024 lanes a block or with a staged table past a block's 227 KB
    of shared memory (20 bytes x 12000 slots), K9 with a block's rows past
    it (S = 4096: the (4096, 8) accumulator and the (4096, 16) matrix,
    384 KB)."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU")
    from raytracingweekend_tpu_torch.tools import dot_microbench as dm
    from raytracingweekend_tpu_torch.tools import sweep_twin as tw
    soa, attr, plan = tw.book1_inputs("cuda")
    with pytest.raises(RuntimeError, match="launch failed"):
        tw.sweep_twin_kernel(soa, attr, 2048, 1, 1, 0.0, 1.0, False)
    big = torch.ones((9, 12000), device="cuda")
    with pytest.raises(RuntimeError, match="launch failed"):
        tw.sweep_twin_kernel(big, torch.zeros((24, 12000), device="cuda"),
                             64, 1, 1, 0.0, 1.0, True)
    tab = torch.zeros((4096, 16), device="cuda")
    with pytest.raises(RuntimeError, match="launch failed"):
        dm.microbench_kernel("lane16", "fp32", tab, 4096, 256, 1)
    with pytest.raises(ValueError, match="multiple"):
        dm.microbench_kernel("lane16", "fp32", tab[:100], 100, 256, 1)
    out, _ = tw.sweep_twin_kernel(soa, attr, plan.T, 2, 2, plan.ut_t0,
                                  plan.ut_idt, False)
    torch.cuda.synchronize()
    assert torch.all(out[:, 1] == 2.0)


# the Mosaic repros (K10-K14): (repro module, form index) of each of the
# ten formulations
MOSAIC_FORMS = [("repro_f32_iota", 0), ("repro_f32_iota", 1),
                ("repro_slice_broadcast_layout", 0),
                ("repro_slice_broadcast_layout", 1),
                ("repro_scalar_reduce", 0),
                ("repro_dynamic_cull", 0), ("repro_dynamic_cull", 1),
                ("repro_dynamic_cull", 2), ("repro_dynamic_cull", 3),
                ("repro_dot_k3_subslice", 0), ("repro_dot_k3_subslice", 1)]


def _mosaic_pair(mod, form: int):
    """The formulation's kernel output and plain output on the card, the
    tolerance between them, and the kernel's launch count delta."""
    name = mod.__name__.rsplit(".", 1)[1]
    before = sum(mod.KERNEL_LAUNCHES.values())
    if name == "repro_f32_iota":
        fn = (mod.f32_iota_kernel, mod.int_iota_cast_kernel)[form]
        got, want, tol = fn(device="cuda"), mod.iota_reference(
            device="cuda"), 0.0
    elif name == "repro_slice_broadcast_layout":
        row, col = mod.inputs(1, "cuda")
        fn = (mod.reg_slice_kernel, mod.ref_load_kernel)[form]
        got, want, tol = fn(row, col), mod.slice_reference(row, col), 0.0
    elif name == "repro_scalar_reduce":
        x = (mod.repro_input("cuda") - 30.0) * 1.5
        got = mod.scalar_reduce_kernel(x)[:mod.OUT_ROWS]
        want, tol = mod.scalar_reduce_reference(x)[:mod.OUT_ROWS], 0.0
    elif name == "repro_dynamic_cull":
        a = mod.inputs((5, 1, 2, 0), "cuda")
        got, want, tol = mod.probe(form, a), mod.reference(form, a), 0.0
    else:
        tab, rays = mod.inputs(1, "cuda")
        lhs = tab if form == 0 else tab[:, 0:3].contiguous()
        fn = (mod.subslice_kernel, mod.dense_kernel)[form]
        got = fn(lhs, rays)
        want = mod.subslice_reference(tab, rays)
        tol = mod.tolerance(tab, rays)
    torch.cuda.synchronize()
    return got, want, tol, sum(mod.KERNEL_LAUNCHES.values()) - before


@pytest.mark.cuda
@pytest.mark.parametrize("repro,form", MOSAIC_FORMS)
def test_mosaic_repro_kernel_matches_plain_version_on_card(repro, form):
    """Each K10-K14 formulation against its plain version on inputs other
    than the tool's (K11 and K14 seed 1, K12 shifted to negative values,
    K13 the scalars (5, 1, 2, 0)): bit for bit, K14 within 2 ulp of
    sum |a||b|; one kernel launch each."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU")
    import importlib
    mod = importlib.import_module(
        f"raytracingweekend_tpu_torch.tools.mosaic_repros.{repro}")
    got, want, tol, launched = _mosaic_pair(mod, form)
    assert launched == 1
    assert got.shape == want.shape and got.dtype == want.dtype
    if repro == "repro_dot_k3_subslice":
        assert torch.all((got - want).abs() <= tol)
    else:
        assert torch.equal(got, want)


@pytest.mark.cuda
@pytest.mark.parametrize("repro", ["repro_f32_iota",
                                   "repro_slice_broadcast_layout",
                                   "repro_dot_k3_subslice"])
def test_mosaic_repro_pairs_are_equal_on_card(repro):
    """The two forms of each pair give the same bits on the card."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU")
    import importlib
    mod = importlib.import_module(
        f"raytracingweekend_tpu_torch.tools.mosaic_repros.{repro}")
    first, _, _, _ = _mosaic_pair(mod, 0)
    second, _, _, _ = _mosaic_pair(mod, 1)
    assert torch.equal(first, second)


@pytest.mark.cuda
def test_mosaic_repro_kernels_raise_on_refused_launches():
    """K11 with W = 2048 threads a block: the card refuses the launch,
    which raises and leaves no error behind; K11 with W not dividing T and
    K14 with T not a multiple of 16 raise ValueError before launching."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU")
    from raytracingweekend_tpu_torch.tools.mosaic_repros import (
        repro_dot_k3_subslice as k14, repro_slice_broadcast_layout as k11)
    row = torch.ones((1, 4096), device="cuda")
    col = torch.ones((4, 1), device="cuda")
    with pytest.raises(RuntimeError, match="launch failed"):
        k11.reg_slice_kernel(row, col, 2048)
    with pytest.raises(ValueError, match="divide"):
        k11.ref_load_kernel(row[:, :500], col, 256)
    tab, rays = k14.inputs(0, "cuda")
    with pytest.raises(ValueError, match="multiples of 16"):
        k14.dense_kernel(tab[:, 0:3].contiguous(), rays[:, :250].contiguous())
    out = k11.ref_load_kernel(row, col, 1024)
    torch.cuda.synchronize()
    assert torch.equal(out, row * col)


# K10's, K11's, K13's and K14's forms: (repro module, form index)
STREAM_FORMS = [("repro_f32_iota", 0), ("repro_f32_iota", 1),
                ("repro_slice_broadcast_layout", 0),
                ("repro_slice_broadcast_layout", 1),
                ("repro_dynamic_cull", 0), ("repro_dynamic_cull", 1),
                ("repro_dynamic_cull", 2), ("repro_dynamic_cull", 3),
                ("repro_dot_k3_subslice", 0), ("repro_dot_k3_subslice", 1)]


def _iota_on_side_stream(mod, form: int) -> None:
    """K10 has no input: the default stream sleeps while a side stream,
    made current, takes a NaN fill of the output's size (its block, freed,
    is what the wrapper's allocation gets back there), the launch and a
    copy of the output. The launch reads the current stream, so after the
    side stream is synchronised the copy equals the plain version; a
    launch on the default stream would still sit behind the sleep."""
    fn = (mod.f32_iota_kernel, mod.int_iota_cast_kernel)[form]
    want = mod.iota_reference(device="cuda")
    first = fn()
    torch.cuda.synchronize()
    side = torch.cuda.Stream()
    torch.cuda._sleep(20_000_000)
    with torch.cuda.stream(side):
        poison = torch.full_like(want, float("nan"))
        del poison
        got = fn().clone()
    side.synchronize()
    torch.cuda.synchronize()
    assert torch.equal(first, want) and torch.equal(got, want)


@pytest.mark.cuda
@pytest.mark.parametrize("repro,form", STREAM_FORMS)
def test_mosaic_launcher_reads_the_current_stream_on_card(repro, form):
    """A form launched on the default stream, then on a side stream made
    current, whose inputs are written there behind a sleep of the card
    (NaN until then): each launch reads the stream current at its call,
    so after that stream is synchronised the output equals the plain
    version (K10, K11, K13 bit for bit, K14 within 2 ulp of sum |a||b|;
    K10, which has no input, as `_iota_on_side_stream` says)."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU")
    import importlib
    mod = importlib.import_module(
        f"raytracingweekend_tpu_torch.tools.mosaic_repros.{repro}")
    if repro == "repro_f32_iota":
        _iota_on_side_stream(mod, form)
        return
    if repro == "repro_slice_broadcast_layout":
        a, b = mod.inputs(2, "cuda")
        fn = (mod.reg_slice_kernel, mod.ref_load_kernel)[form]
        want, tol = mod.slice_reference(a, b), 0.0
    elif repro == "repro_dynamic_cull":
        inputs = mod.inputs((5, 1, 2, 0), "cuda")
        kern, ref, table = mod.PROBES[form]
        a, b = inputs[table], inputs["s"]
        fn = (lambda t, s: kern(t)) if form == 3 else \
            (lambda t, s: kern(s, t))
        want, tol = (ref(a) if form == 3 else ref(b, a)), 0
    else:
        tab, b = mod.inputs(2, "cuda")
        a = tab if form == 0 else tab[:, 0:3].contiguous()
        fn = (mod.subslice_kernel, mod.dense_kernel)[form]
        want, tol = mod.subslice_reference(tab, b), mod.tolerance(tab, b)
    first = fn(a, b)
    late = torch.full_like(a, float("nan"))
    torch.cuda.synchronize()
    side = torch.cuda.Stream()
    with torch.cuda.stream(side):
        torch.cuda._sleep(20_000_000)
        late.copy_(a)
        got = fn(late, b)
    side.synchronize()
    torch.cuda.synchronize()
    for out in (first, got):
        assert torch.all((out - want).abs() <= tol)


# K13's scalar sets: the repro's, a second in range, starts that wrap in
# int32 (k * 8 = 2^32 + 16, k * 128 = 2^36 + 128: inside the table), starts
# clamped high and low, n = 0, n = 8 (five ids the kernel did not write,
# 0) and negative n
K13_SCALARS = {"repro": (3, 2, 3, 0), "second": (5, 1, 2, 0),
               "wrapped": (2 ** 29 + 2, 2 ** 29 + 1, 3, 0),
               "wrapped negative": (2 ** 28, 2 ** 25, 2, 0),
               "clamped high": (100, 9, 3, 0),
               "clamped low": (-4, -2, 2, 0), "n 0": (3, 2, 0, 0),
               "n 8": (4, -3, 8, 0), "n negative": (3, 2, -5, 0)}
# (tab, att) shapes: the repro's, widths that are not multiples of 4, the
# narrowest tables the probes take, and the repro's shapes in a storage
# one float off 16-byte alignment (the single-float form)
K13_TABLES = {"repro": ((64, 128), (8, 512)), "odd": ((61, 130), (7, 515)),
              "narrow": ((9, 3), (3, 129)),
              "misaligned": ((64, 128), (8, 512))}


def _normal(rng, shape, misaligned: bool):
    """A float32 normal table (numpy rng) on the card, contiguous; one float
    into a larger storage where misaligned."""
    x = torch.from_numpy(rng.standard_normal(shape).astype("float32"))
    if not misaligned:
        return x.cuda()
    flat = torch.empty(x.numel() + 1, device="cuda")
    flat[1:] = x.flatten().cuda()
    return flat[1:].view(shape)


@pytest.mark.cuda
@pytest.mark.parametrize("tables", list(K13_TABLES))
@pytest.mark.parametrize("scalars", list(K13_SCALARS))
def test_k13_probes_match_plain_versions_on_card(scalars, tables):
    """K13's probes A-C against their plain versions on normal tables
    (numpy seed), bit for bit, at every scalar set and table shape: the
    float4 form and the single-float form (widths not a multiple of 4, a
    table off 16-byte alignment); one launch each."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU")
    import numpy as np
    from raytracingweekend_tpu_torch.tools.mosaic_repros import (
        repro_dynamic_cull as k13)
    rng = np.random.default_rng(list(K13_SCALARS).index(scalars))
    tab_shape, att_shape = K13_TABLES[tables]
    odd = tables == "misaligned"
    tab, att = _normal(rng, tab_shape, odd), _normal(rng, att_shape, odd)
    assert (tab.data_ptr() % 16 != 0) == odd
    s = torch.tensor(K13_SCALARS[scalars], dtype=torch.int32, device="cuda")
    before = sum(k13.KERNEL_LAUNCHES.values())
    for k, table in enumerate((tab, att, tab)):
        kern, ref, _ = k13.PROBES[k]
        got, want = kern(s, table), ref(s, table)
        torch.cuda.synchronize()
        assert got.shape == want.shape and torch.equal(got, want), k
    assert sum(k13.KERNEL_LAUNCHES.values()) - before == 3


@pytest.mark.cuda
@pytest.mark.parametrize("rows,cols", [(1, 1), (8, 128), (32, 3),
                                       (17, 130), (32, 1)])
def test_k13_compaction_matches_plain_version_on_card(rows, cols):
    """D against its plain version on vote tables of -1, 0 and 1 (numpy
    seed), up to the warp's 32 rows, widths not a multiple of 4 too."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU")
    import numpy as np
    from raytracingweekend_tpu_torch.tools.mosaic_repros import (
        repro_dynamic_cull as k13)
    rng = np.random.default_rng(rows * 1000 + cols)
    for _ in range(4):
        v = torch.from_numpy(rng.choice([-1.0, 0.0, 1.0], size=(rows, cols))
                             .astype("float32")).cuda()
        got = k13.compaction_kernel(v)
        torch.cuda.synchronize()
        assert torch.equal(got, k13.compaction_reference(v))


@pytest.mark.cuda
@pytest.mark.parametrize("rows,cols", [(1, 1), (24, 256), (24, 257),
                                       (4097, 129), (70000, 4),
                                       ((1 << 23) + 7, 2)])
@pytest.mark.parametrize("form", [0, 1])
def test_k10_forms_match_plain_version_on_card(form, rows, cols):
    """Both K10 forms against the plain version, bit for bit: one element,
    the repro's shape, widths not a multiple of 4, rows past the grid's y
    extent (runs of rows a block) and past 2^23 (the f32 form's bit-23
    row values)."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU")
    from raytracingweekend_tpu_torch.tools.mosaic_repros import (
        repro_f32_iota as k10)
    fn = (k10.f32_iota_kernel, k10.int_iota_cast_kernel)[form]
    got = fn(rows, cols, "cuda")
    torch.cuda.synchronize()
    assert torch.equal(got, k10.iota_reference(rows, cols, "cuda"))


@pytest.mark.cuda
@pytest.mark.parametrize("form", [0, 1])
def test_k10_writes_every_element_past_2_31_on_card(form):
    """(2^24, 129): 2^24 x 129 > 2^31 elements (8.7 GB), which a 32-bit
    element count wraps to 2^24. The output's storage is NaN before the
    launch (a freed NaN fill of its size, which the allocation gets back);
    every element is checked in runs of 2^20 rows against arange, the last
    row and sampled rows once more by value, with no plain copy of the
    whole."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU")
    from raytracingweekend_tpu_torch.tools.mosaic_repros import (
        repro_f32_iota as k10)
    rows, cols = 1 << 24, 129
    assert rows * cols >= 1 << 31
    fn = (k10.f32_iota_kernel, k10.int_iota_cast_kernel)[form]
    poison = torch.full((rows, cols), float("nan"), device="cuda")
    del poison
    out = fn(rows, cols, "cuda")
    torch.cuda.synchronize()
    step = 1 << 20
    for r0 in range(0, rows, step):
        col = torch.arange(r0, r0 + step, dtype=torch.float32,
                           device="cuda")[:, None]
        assert bool((out[r0:r0 + step] == col).all()), r0
    gen = torch.Generator(device="cpu").manual_seed(form)
    sample = torch.cat([torch.randint(0, rows, (64,), generator=gen),
                        torch.tensor([0, (1 << 23) - 1, 1 << 23, rows - 1])])
    got = out[sample.cuda()].cpu()
    assert torch.equal(got, sample.float()[:, None].expand(-1, cols))
    del out
    torch.cuda.empty_cache()


# K12's shapes: the repro's (one warp, float4 loads and stores), widths
# and element counts not a multiple of 4 (single floats), the repro's shape
# one float off 16-byte alignment, the largest one-block input (8192
# elements), the smallest grid input (8193) and grid inputs of 2^22
# elements (float4), of an odd count and one float off alignment
K12_SHAPES = {"repro": (8, 128), "odd": (7, 129), "misaligned": (8, 128),
              "one block": (8, 1024), "grid past one block": (3, 2731),
              "grid": (8, 1 << 19), "grid odd": (9, 100003),
              "grid misaligned": (8, 1 << 19)}


def _on_card(x, misaligned: bool):
    """x on the card, contiguous; one float into a larger storage where
    misaligned."""
    if not misaligned:
        return x.cuda()
    flat = torch.empty(x.numel() + 1, device="cuda")
    flat[1:] = x.flatten().cuda()
    return flat[1:].view(x.shape)


def _k12_rows_agree(k12, got, want) -> None:
    """Rows 0..2: NaN at the same places (torch.equal counts NaN unequal),
    every other element bit for bit, zeros by their sign bit (torch.equal
    counts -0.0 equal to +0.0)."""
    g, w = got[:k12.OUT_ROWS], want[:k12.OUT_ROWS]
    assert torch.equal(g.isnan(), w.isnan())
    num = ~w.isnan()
    assert torch.equal(g[num], w[num])
    assert torch.equal(torch.signbit(g[num]), torch.signbit(w[num]))
    assert k12.rows_equal(got, want)


@pytest.mark.cuda
@pytest.mark.parametrize("shape", list(K12_SHAPES))
@pytest.mark.parametrize("case", ["repro", "seed", "nan first", "nan middle",
                                  "nan last", "inf", "all inf",
                                  "+0 with -0 first", "+0 with -0 last",
                                  "-0 with +0 first", "-0 with +0 last",
                                  "all +0", "all -0"])
def test_k12_matches_plain_version_on_edge_inputs_on_card(case, shape):
    """K12 against its plain version on F6's NaN and infinities and F8's
    signed zeros (the CPU test's edge inputs: NaN first, at (3, 5), last;
    -inf and +inf; all +inf; one zero of the other sign first or last),
    the repro's pattern and normals around -3 (numpy seed), on the
    one-block form and on the grid (the NaN or zero of the other sign in
    its last block where it is last), float4 and single-float loads and
    stores: rows 0..2 as `_k12_rows_agree` compares them; one launch."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU")
    import numpy as np
    from raytracingweekend_tpu_torch.tools.mosaic_repros import (
        repro_scalar_reduce as k12)
    rows, cols = K12_SHAPES[shape]
    if case == "repro":
        x = k12.base_input(rows, cols)
    elif case == "seed":
        rng = np.random.default_rng(rows * cols)
        x = torch.from_numpy((rng.standard_normal((rows, cols)) * 40.0
                              - 3.0).astype("float32"))
    else:
        x = k12.edge_input(case, rows, cols)
    x = _on_card(x, "misaligned" in shape)
    assert (x.data_ptr() % 16 != 0) == ("misaligned" in shape)
    before = k12.KERNEL_LAUNCHES["K12 scalar reduce"]
    got = k12.scalar_reduce_kernel(x)
    torch.cuda.synchronize()
    assert k12.KERNEL_LAUNCHES["K12 scalar reduce"] == before + 1
    _k12_rows_agree(k12, got, k12.scalar_reduce_reference(x))


@pytest.mark.cuda
def test_k12_trip_count_matches_plain_version_on_card():
    """The closed-form trip count against the plain version's count of the
    loop on every span 13 k - 1 ulp, 13 k and 13 k + 1 ulp (k = 0..101;
    13 k - 1 ulp from k = 1: a span is never negative), and on 0, the
    least denormal, 1e30, +inf and NaN: x all 0 but one element, the span,
    at (3, 17); one launch a span, rows 0..2 compared."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU")
    import numpy as np
    from raytracingweekend_tpu_torch.tools.mosaic_repros import (
        repro_scalar_reduce as k12)
    f32 = np.float32
    spans = [f32(0.0), np.nextafter(f32(0), f32(1)), f32(1e30), f32(np.inf),
             f32(np.nan)]
    for k in range(102):
        s = f32(13 * k)
        spans += [s, np.nextafter(s, f32(np.inf))]
        if k:
            spans.append(np.nextafter(s, f32(-np.inf)))
    trips = set()
    for span in spans:
        x = torch.zeros((8, 128), device="cuda")
        x[3, 17] = float(span)
        got = k12.scalar_reduce_kernel(x)
        want = k12.scalar_reduce_reference(x)
        torch.cuda.synchronize()
        _k12_rows_agree(k12, got, want)
        trips.add(got[2, 0].item())
    assert trips == set(range(101))


@pytest.mark.cuda
@pytest.mark.parametrize("rows,cols", [(1 << 24, 129), (3, 715827883)])
def test_k12_reads_every_element_past_2_31_on_card(rows, cols):
    """F7: rows x cols > 2^31 elements (8.7 GB, and as much again for the
    output), which a 32-bit element count wraps negative (the first
    version then read x[0] alone). x is 1.0 but for its max in its last
    row and its min at its last element, element 2^31 or past it; rows
    0..2 = [min, max, trips] are checked
    in runs of 2^26 columns, with no plain copy of the whole. The output's
    storage is NaN before the launch (a freed NaN fill of its size, which
    the allocation gets back). Both are freed after."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU")
    from raytracingweekend_tpu_torch.tools.mosaic_repros import (
        repro_scalar_reduce as k12)
    assert rows * cols > 1 << 31
    lo, hi = -3.0, 40.0                      # span 43: trips ceil(43 / 13)
    x = torch.ones((rows, cols), device="cuda")
    x[-1, -1], x[-1, cols // 3] = lo, hi
    assert rows * cols - 1 >= 1 << 31
    poison = torch.full((rows, cols), float("nan"), device="cuda")
    del poison
    out = k12.scalar_reduce_kernel(x)
    torch.cuda.synchronize()
    step = 1 << 26
    for r, v in enumerate((lo, hi, 4.0)):
        for c0 in range(0, cols, step):
            assert bool((out[r, c0:c0 + step] == v).all()), (r, c0)
    del x, out
    torch.cuda.empty_cache()


@pytest.mark.cuda
def test_k13_compaction_reads_past_2_31_columns_on_card():
    """F7: votes (2, 2^31) (17 GB), row 1 voting: lane 1 reads element
    2^31, which a 32-bit column count wraps to -2^31, before the table.
    ids [1, -1], as the plain version orders them."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU")
    from raytracingweekend_tpu_torch.tools.mosaic_repros import (
        repro_dynamic_cull as k13)
    votes = torch.zeros((2, 1 << 31), device="cuda")
    votes[0, 0], votes[1, 0] = -1.0, 1.0
    got = k13.compaction_kernel(votes)
    torch.cuda.synchronize()
    want = k13.compaction_reference(votes)
    assert torch.equal(got, want)
    assert got.tolist() == [1, -1]
    del votes
    torch.cuda.empty_cache()


@pytest.mark.cuda
def test_launch_floor_empty_kernel_on_card():
    """The empty kernel launches through the repros' launcher, counts, and
    leaves no error behind: the floor's timing and a K11 launch after it
    run."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU")
    from raytracingweekend_tpu_torch.tools.mosaic_repros import (
        launch_floor, repro_slice_broadcast_layout as k11)
    before = launch_floor.KERNEL_LAUNCHES["empty"]
    launch_floor.empty_kernel(torch.cuda.current_device())
    torch.cuda.synchronize()
    assert launch_floor.KERNEL_LAUNCHES["empty"] == before + 1
    assert launch_floor.run("cuda", 5) > 0
    assert launch_floor.KERNEL_LAUNCHES["empty"] == before + 1 + 2 + 5
    row, col = k11.inputs(0, "cuda")
    out = k11.reg_slice_kernel(row, col)
    torch.cuda.synchronize()
    assert torch.equal(out, k11.slice_reference(row, col))
