"""The port's scene model and megakernel host plan against the JAX package:
scenes, converted scene leaves, packed tables and pixel layouts must be
bitwise equal."""
import dataclasses

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
from raytracingweekend_tpu_torch.models.scenes import make_scene  # noqa: E402
from raytracingweekend_tpu_torch.ops import megakernel as tk  # noqa: E402
from test_torch_kernel_card import shutter_scene  # noqa: E402

SCENES = ["random_balls", "dielectric"]


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
@pytest.mark.parametrize("name", SCENES)
def test_make_scene_bitwise(name, aspect):
    _assert_same(jscenes.make_scene(name, aspect), make_scene(name, aspect))


@pytest.mark.parametrize("name", SCENES)
def test_scene_from_arrays_bitwise(name):
    js = jscenes.make_scene(name, 1.5)
    ported = scene_from_arrays(*_leaves(js))
    _assert_same(js, ported)
    _assert_same(make_scene(name, 1.5), ported)


def test_scene_from_arrays_carries_unported_scenes_and_rejects_them():
    """A rect/light scene converts field for field, and the slice's host
    plan refuses it by name instead of rendering it wrong."""
    js = jscenes.make_scene("cornell_box", 1.0)
    ported = scene_from_arrays(*_leaves(js))
    _assert_same(js, ported)
    assert not tk.supports_scene(ported)
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        tk.make_plan(ported, 8, 8, 1)


def test_scene_from_arrays_rejects_unknown_leaves():
    arrays, static = _leaves(jscenes.make_scene("dielectric", 1.0))
    with pytest.raises(ValueError, match="unknown"):
        scene_from_arrays(dict(arrays, **{"spheres.colour": np.zeros(3)}),
                          static)
    arrays.pop("camera.origin")
    with pytest.raises(ValueError, match="missing"):
        scene_from_arrays(arrays, static)


@pytest.mark.parametrize("name", ["cornell_box", "earth", "cornell_smoke"])
def test_unported_scene_names_raise(name):
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        make_scene(name, 1.0)


@pytest.mark.parametrize("SB", [64, 512])
@pytest.mark.parametrize("name", SCENES + ["shutter"])
def test_build_tables_bitwise(name, SB):
    """The sphere and camera tables, the slot order and the meta the
    kernel reads. SB=64 exercises the multi-cluster kd order and the
    biggest-radius cluster reordering on random_balls; the shutter scene's
    spheres do not share one shutter, so its plan is not uniform_time."""
    if name == "shutter":
        js = shutter_scene(jbuilder.SceneBuilder, jst)
        ts = shutter_scene(tbuilder.SceneBuilder, tst)
    else:
        js, ts = jscenes.make_scene(name, 1.5), make_scene(name, 1.5)
    (sph_j, attr_j, clus_j, _, _, _, _, cam_j, meta_j) = mk.build_tables(js, SB)
    sph_t, attr_t, cam_t, meta_t = tk.build_tables(ts, SB)
    for label, a, b in (("sph", sph_j, sph_t), ("attr", attr_j, attr_t),
                        ("cam", cam_j, cam_t)):
        a = np.asarray(a)
        assert (a.dtype, a.shape) == (b.dtype, b.shape), label
        assert a.tobytes() == b.tobytes(), label
    for key in ("S", "C", "SB", "uniform_time", "ut_t0", "ut_idt", "moving",
                "lens", "bg_gradient"):
        assert meta_j[key] == meta_t[key], key
    assert np.array_equal(meta_j["slot_ext"], meta_t["slot_ext"])
    assert meta_t["uniform_time"] == (name != "shutter")
    # per-axis motion: the union over the JAX per-cluster flags
    assert meta_t["moving_axes"] == tuple(
        any(c[ax] for c in meta_j["clus_moving"]) for ax in range(3))


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
    _, small = tk.make_plan(make_scene("dielectric", 1.0), 8, 8, 2, T=64,
                            exact=True)
    assert small.T == 64 and small.n_iters == 2 * 50
    with pytest.raises(ValueError):
        tk.make_plan(make_scene("dielectric", 1.0), 8, 8, 2, T=2048)
