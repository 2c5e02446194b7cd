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
def test_refused_launch_raises():
    """A sphere table past the card's 227 KB of shared memory per block
    (9 lanes x 4 bytes x 7040 slots) is refused by CUDA, and the wrapper
    raises instead of returning an unwritten output."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU")
    from raytracingweekend_tpu_torch.models.builder import SceneBuilder
    b = SceneBuilder()
    mat = b.lambertian(b.constant((0.5, 0.5, 0.5)))
    for i in range(7000):
        b.sphere((i % 100, 0.0, i // 100), 0.3, mat)
    b.camera((50, 20, -30), (50, 0, 35), (0, 1, 0), 40.0, 1.0, 0.0, 10.0)
    scene = b.build()
    with pytest.raises(RuntimeError, match="launch failed"):
        tk.trace_mega(1, scene, 8, 8, 1, device="cuda")
