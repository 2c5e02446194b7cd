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
    if name in ("shutter", "nested", "texture_mix"):
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


@pytest.mark.cuda
@pytest.mark.parametrize("name", ["random_balls_large", "random_balls_huge"])
@pytest.mark.parametrize("exact", [True, False])
def test_culled_kernel_matches_plain_version_on_card(exact, name):
    """The culled kernel (K5) against its plain version on the same
    tensors: tapes, radiance and the swept-block counts of row 6, lane by
    lane. Skips without a card."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU")
    scene = make_scene(name, 1.0)
    _, plan = tk.make_plan(scene, 64, 64, 2, max_depth=8, exact=exact)
    assert plan.cull and plan.dyn_order == (0 if exact else 16)
    args, _ = tk.device_inputs(scene, plan, "cuda")
    valid = args[0][:, 2] > 0
    out_k = tk.mega_kernel(*args, 31337, plan)
    out_r = tk.trace_mega_reference(*args, 31337, plan)
    torch.cuda.synchronize()
    rows = slice(0, None) if exact else slice(0, 7)
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
    radiance and the swept-block counts of row 6, lane by lane, in both
    kTex instantiations. Skips without a card."""
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
    out_r = tk.trace_mega_reference(*args, 31337, plan)
    torch.cuda.synchronize()
    rows = slice(0, None) if exact else slice(0, 7)
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


@pytest.mark.cuda
def test_refused_launch_raises():
    """A dense sweep table past the card's 227 KB of shared memory per
    block (random_balls_huge: 9 lanes x 4 bytes x 14464 slots) is refused
    by CUDA, and the wrapper raises instead of returning an unwritten
    output; `make_plan` refuses such a plan before any launch. A culled
    surfaces plan with a bad C, SB or T raises too."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU")
    import dataclasses
    scene = make_scene("random_balls_huge", 1.0)
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
    tensors: every hitting ray's index equal, t to rtol 1e-4 (both write
    the same FMAs; the plain version's FMA is a float64 product-sum
    rounded once more). Covers the moving table, the hollow sphere's
    negative radius, inactive padding rows and, on random_balls_large
    (3840 slots), the table streamed through shared memory in chunks.
    Skips without a card."""
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
    assert torch.equal(kt < 1e30, hit)
    assert torch.equal(ki[hit], ri[hit])
    assert torch.allclose(kt[hit], rt[hit], rtol=1e-4, atol=0.0)
    # geometry.hit_spheres launches the kernel for CUDA tensors
    from raytracingweekend_tpu_torch.ops import geometry as tgeo
    before = tint.KERNEL_LAUNCHES["K7"]
    gt, gi = tgeo.hit_spheres(o, d, tm, ds)
    assert tint.KERNEL_LAUNCHES["K7"] == before + 1
    assert torch.equal(gt, kt) and torch.equal(gi, ki)


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
def test_microbench_kernel_matches_plain_version_on_card(name, body, unit):
    """Each K9 row against its plain version at S = 512, T = 256, 8 steps:
    within `plain_tolerance` (the products' sum order: (terms + 2) 2^-24
    of the absolute terms, twice that for extract; the elementwise bodies
    bit for bit)."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU")
    from raytracingweekend_tpu_torch.tools import dot_microbench as dm
    assert (name, body, unit) in dm.ROWS
    tab = dm.table_for(body, unit, dm.make_tables(512), "cuda")
    out_k = dm.microbench_kernel(body, unit, tab, 512, 256, 8)
    out_r = dm.microbench_reference(body, unit, tab, 512, 256, 8)
    torch.cuda.synchronize()
    assert torch.isfinite(out_k).all()
    assert torch.all((out_k - out_r).abs()
                     <= dm.plain_tolerance(body, tab))


@pytest.mark.cuda
def test_tool_kernels_raise_on_refused_launches():
    """A launch the card refuses raises, and leaves no error behind: K8
    past 1024 lanes a block or with a table past a block's 227 KB of
    shared memory (9 x 4 x 7000 bytes), K9 with an accumulator past it
    (S = 4096: 256 KB)."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU")
    from raytracingweekend_tpu_torch.tools import dot_microbench as dm
    from raytracingweekend_tpu_torch.tools import sweep_twin as tw
    soa, attr, plan = tw.book1_inputs("cuda")
    with pytest.raises(RuntimeError, match="launch failed"):
        tw.sweep_twin_kernel(soa, attr, 2048, 1, 1, 0.0, 1.0, False)
    big = torch.ones((9, 7000), device="cuda")
    with pytest.raises(RuntimeError, match="launch failed"):
        tw.sweep_twin_kernel(big, torch.zeros((24, 7000), device="cuda"),
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
