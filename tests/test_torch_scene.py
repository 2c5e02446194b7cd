"""The port's scene model and megakernel host plan against the JAX package:
scenes, converted scene leaves, packed tables and pixel layouts must be
bitwise equal."""
import dataclasses
import os

import numpy as np
import pytest

pytest.importorskip("torch")
import jax  # noqa: E402

from raytracingweekend_tpu.models import builder as jbuilder  # noqa: E402
from raytracingweekend_tpu.models import scene_types as jst  # noqa: E402
from raytracingweekend_tpu.models import scenes as jscenes  # noqa: E402
from raytracingweekend_tpu.ops import megakernel as mk  # noqa: E402
from raytracingweekend_tpu_torch.models import builder as tbuilder  # noqa: E402
from raytracingweekend_tpu_torch.models import scene_types as tst  # noqa: E402
from raytracingweekend_tpu_torch.models.convert import (  # noqa: E402
    scene_from_arrays)
from raytracingweekend_tpu_torch.models.probe_scenes import (  # noqa: E402
    nested_scene, shutter_scene, texture_mix_scene)
from raytracingweekend_tpu_torch.models import scenes as tscenes  # noqa: E402
from raytracingweekend_tpu_torch.models.scenes import make_scene  # noqa: E402
from raytracingweekend_tpu_torch.ops import megakernel as tk  # noqa: E402
from raytracingweekend_tpu_torch.utils.image import load_image  # noqa: E402
from test_torch_kernel_card import CORNELL  # noqa: E402

SCENES = ["random_balls", "dielectric"]
# the texture scenes (K4); the earth scenes on the JAX package's stand-in
# texels, as both packages build them by default here
TEXTURED = ["light_sample", "two_perlin_spheres", "checker_spheres",
            "earth", "earth_rect"]
RTWI = os.path.join(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))), "tools", "reference_oracle", "earth.rtwi")


def _pair(name, aspect):
    """The JAX package's scene and the port's, by name or Cornell variant."""
    base, kw = CORNELL.get(name, (name, {}))
    return (jscenes.make_scene(base, aspect, **kw),
            make_scene(base, aspect, **kw))


def _assert_same(a, b, path="scene"):
    """Field-by-field equality of a JAX scene node and a port one: arrays
    bitwise (dtype, shape and bytes), static values by ==."""
    if dataclasses.is_dataclass(b):
        for f in dataclasses.fields(b):
            _assert_same(getattr(a, f.name), getattr(b, f.name),
                         f"{path}.{f.name}")
        return
    if b is None or isinstance(b, (bool, int, float, str, tuple)):
        assert a == b, (path, a, b)
        return
    a, b = np.asarray(a), np.asarray(b)
    assert (a.dtype, a.shape) == (b.dtype, b.shape), (path, a.dtype, b.dtype,
                                                      a.shape, b.shape)
    assert a.tobytes() == b.tobytes(), path


def _leaves(jax_scene):
    """A JAX Scene flattened as the port's converter takes it."""
    flat = jax.tree_util.tree_flatten_with_path(jax_scene)[0]
    arrays = {".".join(k.name for k in path): np.asarray(leaf)
              for path, leaf in flat}
    static = {f: getattr(jax_scene, f) for f in tst.STATIC_FIELDS}
    static["lights.num"] = jax_scene.lights.num
    return arrays, static


@pytest.mark.parametrize("aspect", [1.0, 1.5])
@pytest.mark.parametrize("name", SCENES + list(CORNELL) + TEXTURED)
def test_make_scene_bitwise(name, aspect):
    _assert_same(*_pair(name, aspect))


@pytest.mark.parametrize("name", ["earth", "earth_rect"])
def test_earth_on_oracle_texels_bitwise(name, monkeypatch):
    """The earth scenes on the oracle's texels: the port loads them through
    `image_path`; the JAX package, which reads no RTWI, is handed the same
    pixels in place of its `_earth_pixels`."""
    pixels = load_image(RTWI)
    monkeypatch.setattr(jscenes, "_earth_pixels", lambda path=None: pixels)
    js = jscenes.make_scene(name, 1.5)
    ts = make_scene(name, 1.5, image_path=RTWI)
    _assert_same(js, ts)
    assert ts.textures.images.shape == (1, 256, 256, 3)
    _assert_tables(js, ts, 8)


def test_load_image_rtwi():
    """The RTWI loader returns the texel bytes bottom row first, over 255,
    and refuses the formats the port does not read."""
    with open(RTWI, "rb") as f:
        assert f.readline() == b"RTWI 256 256\n"
        raw = np.frombuffer(f.read(), np.uint8).reshape(256, 256, 3)
    img = load_image(RTWI)
    assert img.shape == (256, 256, 3) and img.dtype == np.float64
    assert np.array_equal(img, raw[::-1] / 255.0)
    with pytest.raises(ValueError, match="unsupported image format"):
        load_image("earth.jpg")


@pytest.mark.parametrize("name", SCENES + list(CORNELL) + TEXTURED)
def test_scene_from_arrays_bitwise(name):
    js, ts = _pair(name, 1.5)
    ported = scene_from_arrays(*_leaves(js))
    _assert_same(js, ported)
    _assert_same(ts, ported)


def _nested_checker(bm, st):
    """A checker whose odd child is a noise texture: the JAX package's
    `needs_legacy_textures`, which only the wavefront path renders."""
    b = bm.SceneBuilder()
    b.sphere((0, 0, -1), 0.5, b.lambertian(b.checker(
        b.constant((0.2, 0.3, 0.1)), b.noise(4.0))))
    b.camera((0, 0, 1), (0, 0, -1), (0, 1, 0), 60.0, 1.0, 0.0, 2.0)
    return b.build(background=st.BG_GRADIENT, name="nested_checker")


def test_scene_from_arrays_carries_unported_scenes_and_rejects_them():
    """A checker of a noise texture (`needs_legacy_textures`, the wavefront
    path) converts field for field, and the slice's host plan refuses it
    by name instead of rendering it wrong."""
    js = _nested_checker(jbuilder, jst)
    assert js.needs_legacy_textures
    ported = scene_from_arrays(*_leaves(js))
    _assert_same(js, ported)
    _assert_same(_nested_checker(tbuilder, tst), ported)
    assert not tk.supports_scene(ported)
    with pytest.raises(NotImplementedError, match="ROADMAP Queue 1 item 6"):
        tk.make_plan(ported, 8, 8, 1)


def test_scene_from_arrays_rejects_unknown_leaves():
    arrays, static = _leaves(jscenes.make_scene("dielectric", 1.0))
    with pytest.raises(ValueError, match="unknown"):
        scene_from_arrays(dict(arrays, **{"spheres.colour": np.zeros(3)}),
                          static)
    arrays.pop("camera.origin")
    with pytest.raises(ValueError, match="missing"):
        scene_from_arrays(arrays, static)


def test_every_jax_scene_is_ported_but_the_k5_ones():
    """Every scene of the JAX library is ported, the two large-S stress
    scenes (K5) included: none is left for a later slice."""
    assert set(SCENES + list(TEXTURED) + STRESS
               + ["cornell_box", "cornell_smoke"]) == set(tscenes.SCENES)
    assert set(tscenes.SCENES) == set(jscenes.SCENES)
    assert not tscenes.LATER_SCENES


STRESS = ["random_balls_large", "random_balls_huge"]


@pytest.mark.parametrize("name,kw", [
    ("random_balls_large", {}), ("random_balls_large", {"n": 30}),
    ("random_balls_huge", {}), ("random_balls_large", {"use_bvh": True})])
def test_stress_scenes_bitwise(name, kw):
    """The large-S stress scenes (3604 and 14404 live spheres at their
    defaults) are built bitwise JAX's; their sphere BVH comes with the
    wavefront path."""
    if kw.get("use_bvh"):
        with pytest.raises(NotImplementedError,
                           match="ROADMAP Queue 1 item 6"):
            make_scene(name, 1.5, **kw)
        return
    js, ts = jscenes.make_scene(name, 1.5, **kw), make_scene(name, 1.5, **kw)
    _assert_same(js, ts)
    n = kw.get("n", 120 if name == "random_balls_huge" else 60)
    assert int(np.sum(np.asarray(ts.spheres.active))) == n * n + 4


# meta fields of the JAX tables that the port's plan reads
META_KEYS = ("S", "C", "SB", "uniform_time", "ut_t0", "ut_idt", "moving",
             "lens", "bg_gradient", "has_spheres", "has_light", "has_iso",
             "has_metal", "has_dielectric", "R", "rect_axes", "rect_rot",
             "rect_trans", "rect_tf", "rect_rows", "L", "light_kinds",
             "light_axes", "light_rot", "light_trans", "light_rows", "V",
             "med_kinds", "med_rot", "med_trans", "med_rows",
             "has_checker", "has_noise", "noise_modes", "has_image", "n_img",
             "img_hw")


def _assert_tables(js, ts, SB):
    (sph_j, attr_j, _, rect_j, light_j, med_j, _, cam_j,
     meta_j) = mk.build_tables(js, SB)
    sph_t, attr_t, rect_t, light_t, med_t, cam_t, meta_t = tk.build_tables(
        ts, SB)
    for label, a, b in (("sph", sph_j, sph_t), ("attr", attr_j, attr_t),
                        ("rect", rect_j, rect_t), ("light", light_j, light_t),
                        ("med", med_j, med_t), ("cam", cam_j, cam_t)):
        a = np.asarray(a)
        assert (a.dtype, a.shape) == (b.dtype, b.shape), label
        assert a.tobytes() == b.tobytes(), label
    for key in META_KEYS:
        assert meta_j[key] == meta_t[key], key
    assert np.array_equal(meta_j["slot_ext"], meta_t["slot_ext"])
    # per-axis motion: the union over the JAX per-cluster flags
    assert meta_t["moving_axes"] == tuple(
        any(c[ax] for c in meta_j["clus_moving"]) for ax in range(3))
    return meta_t


@pytest.mark.parametrize("SB", [64, 512])
@pytest.mark.parametrize("name", SCENES + ["shutter"] + list(CORNELL)
                         + TEXTURED)
def test_build_tables_bitwise(name, SB):
    """The sphere, attribute, rect, light, medium and camera tables, the
    slot order and the meta the kernel reads. SB=64 exercises the
    multi-cluster kd order and the biggest-radius cluster reordering on
    random_balls; the shutter scene's spheres do not share one shutter, so
    its plan is not uniform_time."""
    if name == "shutter":
        js = shutter_scene(jbuilder, jst)
        ts = shutter_scene(tbuilder, tst)
    else:
        js, ts = _pair(name, 1.5)
    meta_t = _assert_tables(js, ts, SB)
    if name in SCENES + ["shutter"]:
        assert meta_t["uniform_time"] == (name != "shutter")


def test_builder_texture_mix_bitwise():
    """Checker, noise and image textures on spheres, rects and media: the
    scene, its texture lanes and the texture meta."""
    js = texture_mix_scene(jbuilder, jst)
    ts = texture_mix_scene(tbuilder, tst)
    _assert_same(js, ts)
    meta = _assert_tables(js, ts, 8)
    assert meta["noise_modes"] == (tst.NOISE_MARBLE, tst.NOISE_SMOOTH,
                                   tst.NOISE_TURB)
    assert meta["has_checker"] and meta["img_hw"] == ((16, 32),)
    _, plan = tk.make_plan(ts, 8, 8, 1)
    assert plan.textures and plan.surfaces


@pytest.mark.parametrize("name", TEXTURED)
def test_make_plan_textures(name):
    """Texture scenes take the surfaces kernel with its textures, even with
    spheres only, and their plans carry the JAX plan's texture flags."""
    js, ts = _pair(name, 1.0)
    _, plan = tk.make_plan(ts, 16, 16, 4, max_depth=5, exact=True)
    cfg = mk.make_plan(js, 16, 16, 4, max_depth=5, T=256, tape=True)[1]
    assert plan.textures and plan.surfaces
    assert plan.has_checker == cfg.has_checker
    assert plan.noise_modes == cfg.noise_modes
    assert plan.img_hw == cfg.img_hw and len(plan.img_hw) == cfg.n_img
    assert (plan.R, plan.L, plan.V, plan.has_light) == (
        cfg.R, cfg.L, cfg.V, cfg.has_light)


def test_builder_nested_transform_and_sphere_medium_bitwise():
    js = nested_scene(jbuilder, jst)
    ts = nested_scene(tbuilder, tst)
    _assert_same(js, ts)
    meta = _assert_tables(js, ts, 8)
    assert (meta["R"], meta["L"], meta["V"]) == (8, 2, 2)
    assert meta["med_kinds"] == (tst.MEDIUM_SPHERE, tst.MEDIUM_BOX)
    assert meta["med_rot"] == (True, False)
    assert meta["rect_rot"] == (False,) + (True,) * 7
    assert tk.supports_scene(ts)


@pytest.mark.parametrize("nx,ny,T", [(16, 16, 512), (37, 23, 128),
                                     (1200, 800, 256)])
def test_pixel_layout_bitwise(nx, ny, T):
    pixf_j, inv_j = mk._pixel_layout(nx, ny, T)
    pixf_t, inv_t = tk._pixel_layout(nx, ny, T)
    pixf_j = np.asarray(pixf_j)
    assert pixf_j.shape == pixf_t.shape and pixf_j.tobytes() == pixf_t.tobytes()
    assert np.array_equal(np.asarray(inv_j), inv_t)


def test_make_plan_book1_defaults():
    """The main path's plan: one dense cluster of the ~485 live spheres,
    T = 256 lanes (no TPU 128-lane rounding or 512-lane floor)."""
    tabs, plan = tk.make_plan(make_scene("random_balls", 1.5), 1200, 800, 64)
    meta = tabs[-1]
    assert meta["C"] == 1 and plan.S == meta["S"] == plan.SB <= 512
    assert plan.T == 256 and plan.rr_depth == 4 and not plan.exact
    assert plan.moving and plan.uniform_time and not plan.lens
    assert not plan.surfaces and (plan.R, plan.L, plan.V) == (0, 0, 0)
    _, small = tk.make_plan(make_scene("dielectric", 1.0), 8, 8, 2, T=64,
                            exact=True)
    assert small.T == 64 and small.n_iters == 2 * 50
    with pytest.raises(ValueError):
        tk.make_plan(make_scene("dielectric", 1.0), 8, 8, 2, T=2048)


@pytest.mark.parametrize("name", list(CORNELL))
def test_make_plan_cornell(name):
    """The Cornell plans: S = 8 slots whether or not a sphere is live (the
    JAX plan's S, so tape codes match), and the per-row codes decode to the
    JAX tables' static metadata."""
    js, ts = _pair(name, 1.0)
    tabs, plan = tk.make_plan(ts, 16, 16, 4, max_depth=5, T=512,
                              exact=True)
    meta = tabs[-1]
    cfg = mk.make_plan(js, 16, 16, 4, max_depth=5, T=256, tape=True)[1]
    assert plan.surfaces and plan.S == cfg.S == 8
    assert plan.has_spheres == cfg.has_spheres == (name in (
        "cornell_box", "cornell_box_aluminum"))
    assert (plan.R, plan.L, plan.V) == (cfg.R, cfg.L, cfg.V)
    assert plan.has_light == cfg.has_light
    assert tuple(c & 3 for c in plan.rect_codes) == cfg.rect_axes
    assert tuple(bool(c >> 2 & 1) for c in plan.rect_codes) == cfg.rect_rot
    assert tuple(bool(c >> 3 & 1) for c in plan.rect_codes) == cfg.rect_trans
    assert tuple(c >> 4 for c in plan.rect_codes) == meta["rect_tf"]
    assert tuple(c & 1 for c in plan.light_codes) == cfg.light_kinds
    assert tuple(c & 1 for c in plan.med_codes) == cfg.med_kinds
    assert tuple(bool(c >> 1 & 1) for c in plan.med_codes) == cfg.med_rot
