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


@pytest.mark.cuda
def test_refused_launch_raises():
    """A dense sweep table past the card's 227 KB of shared memory per
    block (random_balls_huge: 9 lanes x 4 bytes x 14464 slots) is refused
    by CUDA, and the wrapper raises instead of returning an unwritten
    output; `make_plan` refuses such a plan before any launch."""
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
