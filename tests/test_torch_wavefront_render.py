"""The port's wavefront through render() and its CLI on the CPU: every
loop mode, `auto` routing the scenes the megakernel refuses, the five
historical lambertian strategies against MIS (as in
tests/test_sampling_strategies.py), the light-only stage, the BVH scene,
a checker of non-constant textures, --normals, --debug-ray and --profile.
The port alone: these need no JAX."""
import dataclasses
import gc
import json
import weakref

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from raytracingweekend_tpu_torch import render as trender  # noqa: E402
from raytracingweekend_tpu_torch import wavefront_profile  # noqa: E402
from raytracingweekend_tpu_torch.models import builder as tbuilder  # noqa: E402
from raytracingweekend_tpu_torch.models import scene_types as st  # noqa: E402
from raytracingweekend_tpu_torch.models.scenes import make_scene  # noqa: E402
from raytracingweekend_tpu_torch.ops import integrator as tint  # noqa: E402
from raytracingweekend_tpu_torch.ops import megakernel as tk  # noqa: E402
from raytracingweekend_tpu_torch.ops import packing  # noqa: E402
from raytracingweekend_tpu_torch.ops.syncs import CHECK_EVERY, SYNCS  # noqa: E402
from raytracingweekend_tpu_torch.utils import prng  # noqa: E402
from raytracingweekend_tpu_torch.utils.config import RenderConfig  # noqa: E402

torch.set_num_threads(2)

KEY = prng.key(5)
STRATEGIES = ("mis", "unit_sphere", "unit_vector", "hemisphere", "onb")


def _strategy_scene(strategy):
    b = tbuilder.SceneBuilder()
    b.sphere((0, -100.5, -1), 100.0, b.lambertian(b.constant((0.6, 0.5, 0.4))))
    b.sphere((0, 0, -1), 0.5, b.lambertian(b.constant((0.3, 0.5, 0.7))))
    b.camera((0, 0, 0), (0, 0, -1), (0, 1, 0), 60.0, 1.0, 0.0, 1.0)
    return b.build(background=st.BG_GRADIENT, lambertian_strategy=strategy)


def _chunk(scene, spp, depth, n=16):
    return trender.render_chunk(scene, KEY, n, n, spp, depth,
                                device="cpu").numpy() / spp


@pytest.fixture(scope="module")
def mis_image():
    return _chunk(_strategy_scene("mis"), 192, 12)


@pytest.mark.parametrize("strategy", STRATEGIES[1:])
def test_strategies_agree_with_mis(strategy, mis_image):
    """Same integral, other estimator: scene means within 3%."""
    img = _chunk(_strategy_scene(strategy), 192, 12)
    assert np.isfinite(img).all()
    assert abs(img.mean() - mis_image.mean()) / mis_image.mean() < 0.03
    assert not np.allclose(img, mis_image)


def test_light_only_stage():
    """Sampling the lights alone renders direct light and drops the
    indirect paths (pdf 0 off the lights): below the full estimate."""
    base = make_scene("cornell_box", 1.0)
    mis = _chunk(base, 96, 10)
    lo = _chunk(dataclasses.replace(base, lambertian_strategy="light_only"),
                96, 10)
    assert np.isfinite(lo).all()
    assert 0.15 * mis.mean() < lo.mean() < mis.mean()


@pytest.mark.parametrize("mode", ["regen", "tiled", "while", "scan"])
def test_render_modes_agree(mode):
    """Every wavefront mode renders the same scene to the same mean (the
    megakernel too). tiled is driven through render_chunk_tiled with 1024
    slots: render()'s 2^19 would pad this frame to 2^18 pixels a tile."""
    scene = make_scene("cornell_smoke", 1.0)
    cfg = RenderConfig(nx=16, ny=16, spp=32, max_depth=20,
                       samples_per_launch=16, seed=3, loop_mode=mode,
                       device="cpu")
    if mode == "tiled":
        part, segs, iters = trender.render_chunk_tiled(
            scene, prng.key(3), 16, 16, 32, 20, n_slots=1024, device="cpu")
        img, spp_done = part / 32, 32
    else:
        stats = trender.RenderStats()
        img = trender.render(scene, cfg, stats=stats)
        spp_done, segs, iters = (stats.spp_done, stats.segments,
                                 stats.iterations)
    mega = trender.render(scene, dataclasses.replace(cfg, loop_mode="mega"))
    assert img.shape == (16, 16, 3) and torch.isfinite(img).all()
    assert abs(img.mean() - mega.mean()) / mega.mean() < 0.05
    assert spp_done == 32 and float(segs) >= 16 * 16 * 32
    assert (iters > 0) == (mode in ("regen", "tiled"))


def test_auto_routes_refused_scenes_to_regen():
    """auto takes the megakernel where it applies and regen for the BVH,
    normal, non-MIS and nested-checker scenes; mega refuses those by
    name, without naming a missing slice."""
    assert trender.RenderConfig().loop_mode == "regen"
    box = make_scene("cornell_box", 1.0)
    assert trender.resolve_mode(box, "auto") == "mega"
    refused = [
        make_scene("random_balls_large", 1.0, n=10, use_bvh=True),
        dataclasses.replace(box, render_type=st.RENDER_NORMAL),
        dataclasses.replace(box, lambertian_strategy="hemisphere"),
        _nested_checker()]
    for scene in refused:
        assert trender.resolve_mode(scene, "auto") == "regen"
        reason = tk.unsupported_reason(scene)
        assert "wavefront" in reason and "item 6" not in reason
        with pytest.raises(NotImplementedError, match="wavefront"):
            trender.render(scene, RenderConfig(nx=4, ny=4, spp=1,
                                               loop_mode="mega",
                                               device="cpu"))


def _nested_checker():
    b = tbuilder.SceneBuilder()
    b.sphere((0, 0, -1), 0.5, b.lambertian(b.checker(
        b.constant((0.2, 0.3, 0.1)), b.noise(4.0))))
    b.sphere((0, -100.5, -1), 100.0, b.lambertian(b.checker(
        b.noise(2.0), b.constant((0.9, 0.9, 0.9)))))
    b.camera((0, 0, 1), (0, 0, -1), (0, 1, 0), 60.0, 1.0, 0.0, 2.0)
    return b.build(background=st.BG_GRADIENT, name="nested_checker")


def test_nested_checker_renders_through_auto():
    scene = _nested_checker()
    assert scene.needs_legacy_textures
    img = trender.render(scene, RenderConfig(nx=12, ny=12, spp=8,
                                             max_depth=8, loop_mode="auto",
                                             device="cpu"))
    assert torch.isfinite(img).all() and 0.05 < float(img.mean()) < 2.0


def test_bvh_scene_renders_like_the_flat_table():
    """random_balls_large(n=10) with its BVH and without: the same keys,
    the same closest hits, so the same regen image up to round-off."""
    cfg = RenderConfig(nx=12, ny=8, spp=4, max_depth=6, seed=2,
                       loop_mode="auto", device="cpu")
    flat = make_scene("random_balls_large", 1.5, n=10)
    tree = make_scene("random_balls_large", 1.5, n=10, use_bvh=True)
    before = SYNCS["bvh"]
    a = trender.render(tree, cfg)
    assert SYNCS["bvh"] > before
    b = trender.render(flat, dataclasses.replace(cfg, loop_mode="regen"))
    close = torch.isclose(a, b, rtol=1e-3, atol=5e-5).all(dim=-1)
    assert close.float().mean().item() >= 0.95


def test_integrator_counts_host_syncs():
    """The loop condition is read every CHECK_EVERY iterations, so the
    loop ends on a read: iterations / CHECK_EVERY + 1 reads."""
    scene = make_scene("dielectric", 1.0)
    before = dict(SYNCS)
    _, _, iters = tint.trace_regenerative(KEY, scene, 8, 8, 2, max_depth=10,
                                          device="cpu")
    reads = SYNCS["regen"] - before["regen"]
    assert iters % CHECK_EVERY == 0
    assert reads == iters // CHECK_EVERY + 1


def test_device_scene_cache_releases_collected_scenes():
    """device_scene makes one DeviceScene per scene object and keeps no
    reference to the scene: once the scene is collected, its cache entry
    and its tensors go with it."""
    scene = make_scene("cornell_box", 1.0)
    ds = packing.device_scene(scene, "cpu")
    assert packing.device_scene(scene, "cpu") is ds
    assert ds.scene.lambertian_strategy == scene.lambertian_strategy
    key, ref = (id(scene), "cpu"), weakref.ref(scene)
    assert key in packing._CACHE
    del scene
    gc.collect()
    assert ref() is None and key not in packing._CACHE
    entry = weakref.ref(ds)
    del ds
    gc.collect()
    assert entry() is None


@pytest.mark.parametrize("mode", ["regen", "tiled", "while", "scan"])
def test_cli_modes(tmp_path, capsys, mode):
    out = tmp_path / "w.png"
    trender.main(["--scene", "dielectric", "--mode", mode, "--nx", "8",
                  "--ny", "6", "--spp", "2", "--samples-per-launch", "1",
                  "--max-depth", "3", "--device", "cpu", "--stats",
                  "--out", str(out)])
    assert out.read_bytes()[:8] == b"\x89PNG\r\n\x1a\n"
    assert "(dielectric, 8x6, 2 spp)" in capsys.readouterr().out


def test_cli_normals_debug_ray_and_profile(tmp_path, capsys):
    out = tmp_path / "n.png"
    metrics = tmp_path / "m.jsonl"
    trender.main(["--scene", "random_balls", "--normals", "--nx", "8",
                  "--ny", "6", "--spp", "2", "--device", "cpu",
                  "--metrics", str(metrics), "--profile", str(tmp_path / "p"),
                  "--out", str(out)])
    assert out.exists() and (tmp_path / "p" / "trace.json").exists()
    line = json.loads(metrics.read_text().splitlines()[0])
    assert line["mode"] == "regen"
    trender.main(["--scene", "cornell_box", "--debug-ray", "--device", "cpu"])
    text = capsys.readouterr().out
    assert "debug ray: origin=" in text and "radiance=" in text


@pytest.mark.parametrize("full,short", [
    ("void at::native::vectorized_elementwise_kernel<4, at::native::"
     "BitwiseAndFunctor<long>, std::array<char*, 3ul> >(int, "
     "at::native::BitwiseAndFunctor<long>, std::array<char*, 3ul>)",
     "vectorized_elementwise_kernel BitwiseAndFunctor<long>"),
    ("void hit_spheres_kernel<true>(float const*, int, float*, int*)",
     "hit_spheres_kernel"),
    ("void at::native::(anonymous namespace)::indexFuncLargeIndex<float, "
     "long, unsigned int, 2, 2, -2, true>(at::cuda::detail::TensorInfo)",
     "indexFuncLargeIndex")])
def test_profile_kernel_names(full, short):
    assert wavefront_profile.short_kernel_name(full) == short


def test_profile_needs_a_card(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    assert wavefront_profile.main(["--nx", "4", "--ny", "4"]) == 1
