"""The surfaces kernels' plan-side design, on the CPU: which compiled form
(feature set) `make_plan` picks for each scene, the refusal of a form the
library does not build, the rect runs the kernels test the rects in
(`megakernel.rect_runs`), staged from tables bitwise equal to the JAX
package's, and the winner rule that keeps the run order's winner the row
loop's: on an equal t the lower row, also in a scene whose tied rects
fall in different runs, where the port's tape is held to JAX's."""

import numpy as np
import pytest

torch = pytest.importorskip("torch")
import jax  # noqa: E402

from raytracingweekend_tpu.models import builder as jbuilder  # noqa: E402
from raytracingweekend_tpu.models import scene_types as jst  # noqa: E402
from raytracingweekend_tpu.models import scenes as jscenes  # noqa: E402
from raytracingweekend_tpu.ops import mega_grad as mg  # noqa: E402
from raytracingweekend_tpu.ops import megakernel as mk  # noqa: E402
from raytracingweekend_tpu_torch.models import builder as tbuilder  # noqa: E402
from raytracingweekend_tpu_torch.models import probe_scenes  # noqa: E402
from raytracingweekend_tpu_torch.models import scene_types as tst  # noqa: E402
from raytracingweekend_tpu_torch.models.scenes import make_scene  # noqa: E402
from raytracingweekend_tpu_torch.ops import megakernel as tk  # noqa: E402

RTWI = "tools/reference_oracle/earth.rtwi"
R, L, V = tk.F_RECTS, tk.F_LIGHTS, tk.F_MEDIA
IMG, CHK, NOI = tk.F_IMAGE, tk.F_CHECKER, tk.F_NOISE
# each scene's form: (builder or make_scene name, keywords, features)
FORMS = {"earth": ("earth", {"image_path": RTWI}, IMG),
         "earth_rect": ("earth_rect", {"image_path": RTWI}, R | IMG),
         "two_perlin_spheres": ("two_perlin_spheres", {}, NOI),
         "light_sample": ("light_sample", {}, R | NOI),
         "checker_spheres": ("checker_spheres", {}, CHK),
         "cornell_box": ("cornell_box", {}, R | L),
         "cornell_box_aluminum": ("cornell_box", {"aluminum_box": True},
                                  R | L),
         "cornell_smoke": ("cornell_smoke", {}, R | L | V),
         "nested": ("nested", {}, R | L | V),
         "texture_mix": ("texture_mix", {}, tk.F_ALL),
         "rect_tie": ("rect_tie", {}, R | L)}


def _scene(name, bm=tbuilder, st=tst):
    base, kw, _ = FORMS[name]
    if base in ("nested", "texture_mix", "rect_tie"):
        return getattr(probe_scenes, f"{base}_scene")(bm, st)
    if bm is jbuilder:
        return jscenes.make_scene(base, 1.0, **kw)
    return make_scene(base, 1.0, **kw)


@pytest.mark.parametrize("name", list(FORMS))
@pytest.mark.parametrize("exact", [False, True])
def test_make_plan_picks_each_surface_form(name, exact):
    """Every surfaces scene of the library and the probes plans its own
    static form, which holds the features its rows use and textures
    exactly when it has them; the form is one the library builds."""
    _, plan = tk.make_plan(_scene(name), 16, 16, 2, exact=exact)
    feat = FORMS[name][2]
    assert plan.surfaces and not plan.cull
    assert plan.feat == feat
    assert plan.feat & plan.needs == plan.needs
    assert bool(plan.feat & tk.F_TEX) == plan.textures
    assert (tk.AXES_STATIC, False, feat) in tk.SURFACE_FORMS


def test_moving_and_culled_plans_take_the_general_forms():
    """Surfaces with moving spheres take a moving form's general features
    (every untextured one, or every one); a culled plan names the
    features its culled instantiation compiles; a sphere-only plan has
    none."""
    moving = probe_scenes.large_mixed_scene(tbuilder, tst, n=60,
                                            textured=False, moving=True)
    _, plan = tk.make_plan(moving, 16, 16, 2, cull=False)
    assert (tk.sweep_axes(plan), plan.uniform_time) == (tk.AXIS_Y, True)
    assert plan.feat == tk.F_SURF
    mixed = probe_scenes.large_mixed_scene(tbuilder, tst, n=60)
    _, culled = tk.make_plan(mixed, 16, 16, 2)
    _, dense = tk.make_plan(mixed, 16, 16, 2, cull=False)
    assert culled.cull and culled.feat == tk.F_ALL
    assert not dense.cull and dense.feat == tk.F_ALL
    _, spheres = tk.make_plan(make_scene("random_balls", 1.0), 16, 16, 2)
    assert not spheres.surfaces and spheres.feat == 0


def test_surface_forms_serve_every_feature_set():
    """Each dense (axes, shutter) form has the two general surfaces forms,
    so every set of features has a form, with or without textures."""
    for axes, uniform in tk.DENSE_FORMS:
        feats = [f for a, u, f in tk.SURFACE_FORMS if (a, u) == (axes,
                                                                 uniform)]
        assert tk.F_SURF in feats and tk.F_ALL in feats
        for need in range(tk.F_ALL + 1):
            tex = bool(need & tk.F_TEX)
            assert any(f & need == need and bool(f & tk.F_TEX) == tex
                       for f in feats), (axes, uniform, need)
    assert len(set(tk.SURFACE_FORMS)) == len(tk.SURFACE_FORMS)


def test_make_plan_refuses_a_form_not_built(monkeypatch):
    """A plan whose features no built form of its (axes, shutter) holds
    is refused before any launch: here earth without the image forms."""
    scene = _scene("earth")
    _, plan = tk.make_plan(scene, 16, 16, 2)
    built = tuple(f for f in tk.SURFACE_FORMS if not f[2] & tk.F_IMAGE)
    with pytest.raises(ValueError, match="no surfaces form"):
        tk.surface_form(plan, built)
    monkeypatch.setattr(tk, "SURFACE_FORMS", built)
    with pytest.raises(ValueError, match="no surfaces form"):
        tk.make_plan(scene, 16, 16, 2)
    # an untextured form never serves a textured scene, nor the reverse
    with pytest.raises(ValueError):
        tk.surface_form(plan, ((tk.AXES_STATIC, False, tk.F_SURF),))
    _, cornell = tk.make_plan(_scene("cornell_box"), 16, 16, 2)
    with pytest.raises(ValueError):
        tk.surface_form(cornell, ((tk.AXES_STATIC, False, tk.F_ALL),))


@pytest.mark.parametrize("name", ["cornell_box", "cornell_box_aluminum",
                                  "cornell_smoke", "nested", "texture_mix",
                                  "rect_tie"])
def test_rect_runs_group_by_transform_and_axis(name):
    """The runs hold every rect once, by (group, axis, row); each group's
    header names its first row, its rotation and translation and its
    rows along each axis."""
    _, plan = tk.make_plan(_scene(name), 16, 16, 2)
    codes = plan.rect_codes
    runs = tk.rect_runs(codes)
    G = runs[0]
    order = runs[1:1 + plan.R]
    heads = np.asarray(runs[1 + plan.R:]).reshape(G, 4)
    assert len(runs) == 1 + plan.R + 4 * G
    assert sorted(order) == list(range(plan.R))
    keys = [(codes[r] >> 4, codes[r] & 3, r) for r in order]
    assert keys == sorted(keys)
    pos = 0
    for g, (first, n0, n1, n2) in enumerate(heads):
        rows = [r for r in range(plan.R) if codes[r] >> 4 == g]
        assert first & 0xFFFFFF == rows[0]
        assert first >> 24 == (codes[rows[0]] >> 2) & 3
        assert all((codes[r] >> 2) & 3 == first >> 24 for r in rows)
        for ax, n in enumerate((n0, n1, n2)):
            assert [r for r in order[pos:pos + n]] == [
                r for r in rows if codes[r] & 3 == ax]
            pos += n
    assert pos == plan.R
    assert tk.rect_runs(()) == ()


@pytest.mark.parametrize("name", ["cornell_box", "nested", "texture_mix",
                                  "rect_tie"])
def test_rect_run_rows_come_from_the_jax_tables(name):
    """The lanes a run row stages (k, a0, a1, b0, b1, 1 / extents) and a
    group's transform lanes, taken from the port's rect table in run
    order, equal the JAX package's table bitwise; the codes the runs are
    derived from are JAX's rect axes, transforms and groups."""
    js, ts = _scene(name, jbuilder, jst), _scene(name)
    tabs_j = mk.build_tables(js, 8)
    rect_j, meta_j = np.asarray(tabs_j[3]), tabs_j[-1]
    tabs_t, plan = tk.make_plan(ts, 16, 16, 2)
    rect_t = tabs_t[2]
    codes_j = tuple(a | r << 2 | t << 3 | g << 4 for a, r, t, g in zip(
        meta_j["rect_axes"], meta_j["rect_rot"], meta_j["rect_trans"],
        meta_j["rect_tf"]))
    assert codes_j == plan.rect_codes
    runs = tk.rect_runs(plan.rect_codes)
    order = list(runs[1:1 + plan.R])
    lanes = [tk.RT_K, tk.RT_A0, tk.RT_A1, tk.RT_B0, tk.RT_B1, tk.RT_IDA,
             tk.RT_IDB]
    assert rect_t[order][:, lanes].tobytes() == rect_j[order][:,
                                                              lanes].tobytes()
    tf = [tk.RT_COS, tk.RT_SIN, tk.RT_OFFX, tk.RT_OFFY, tk.RT_OFFZ]
    for first in runs[1 + plan.R::4]:
        r0 = first & 0xFFFFFF
        group = [r for r in range(plan.R)
                 if plan.rect_codes[r] >> 4 == plan.rect_codes[r0] >> 4]
        # one transform a group: every row's lanes are its first row's
        assert rect_t[group][:, tf].tobytes() == np.repeat(
            rect_j[r0:r0 + 1, tf], len(group), 0).tobytes()


def _row_loop(t, ok):
    """The first row with the strictly smallest t among those that pass
    (t > t_min and in bounds: ok), as the kernels' row loop took it."""
    best, win = np.float32(3.0e37), -1
    for r in range(t.size):
        if ok[r] and t[r] > 0.001 and t[r] < best:
            best, win = t[r], r
    return win


def _run_merge(t, ok, order):
    """The same rows in run order, merged as csrc/megakernel.cu rect_run
    merges them: a smaller t, or an equal t of a lower row."""
    best, win = np.float32(3.0e37), -1
    for r in order:
        hit = (ok[r] and t[r] > 0.001
               and (t[r] < best or (t[r] == best and r < win)))
        best, win = (t[r], r) if hit else (best, win)
    return win


def test_run_merge_keeps_the_row_loops_winner():
    """Over random t (many ties, inf, -inf, NaN, t below t_min) and
    random in-bounds flags, the run order's merge picks the row loop's
    winner, for every order the runs can take."""
    rng = np.random.default_rng(13)
    codes_sets = [(1, 2, 2, 1, 1, 0, 28, 28, 29, 29, 30, 30),
                  (1, 24, 0), (0, 18, 33, 17, 2, 50, 49, 48)]
    pool = np.array([0.5, 0.5, 1.0, 2.0, np.inf, -np.inf, np.nan, 0.0005,
                     3.0e37], np.float32)
    for codes in codes_sets:
        order = tk.rect_runs(codes)[1:1 + len(codes)]
        for _ in range(400):
            t = rng.choice(pool, len(codes)).astype(np.float32)
            ok = rng.random(len(codes)) < 0.7
            assert _run_merge(t, ok, order) == _row_loop(t, ok)


def test_rect_tie_keeps_the_lower_row_on_the_jax_tape():
    """rect_tie: two coplanar rects cover one square, row 1 in transform
    group 1 and row 2 in group 0, which the kernels test first. Every ray
    that reaches the square ties; the plain version's tape names row 1,
    never row 2, and equals the JAX kernel's tape (interpret mode) lane
    by lane, with JAX's seed and tile width."""
    js, ts = _scene("rect_tie", jbuilder, jst), _scene("rect_tie")
    ctx = mg.plan_tape(js, 16, 16, 4, max_depth=5, T=256)
    _, tape_j, seed = mg.tape_forward(jax.random.key(3), ctx,
                                      interpret=True)
    seed = int(np.asarray(seed)[0, 0])
    res = tk.trace_mega(seed, ts, 16, 16, 4, max_depth=5, rr_depth=None,
                        T=ctx["T"], exact=True, device="cpu")
    tape_t = res.tape.numpy()
    _, plan = tk.make_plan(ts, 16, 16, 4, max_depth=5, rr_depth=None,
                           T=ctx["T"], exact=True)
    S = plan.S
    assert plan.rect_codes == (1, 24, 0)      # row 1 alone in group 1
    assert (tape_t == S + 1).sum() > 100      # the tie, won by row 1
    assert (tape_t == S + 2).sum() == 0
    same = (tape_t == np.asarray(tape_j)).all(axis=1)
    assert same.mean() >= 0.99
    assert (np.asarray(tape_j) == S + 1).sum() == (tape_t == S + 1).sum()


def test_dense_surfaces_launches_order_their_blocks_longest_first():
    """A dense surfaces overdraw plan gets its scene's own copy of the
    pixel layout (JAX's, its pad row 0: blocks in tile order); after a
    launch `_longest_first` writes 1 + the tile of each block into the
    pad row's lane 0, most bounce iterations first (ties in tile order).
    Exact, culled and sphere-only plans keep the shared layout."""
    cornell = _scene("cornell_box")
    _, plan = tk.make_plan(cornell, 32, 32, 2, max_depth=4)
    args, _ = tk.device_inputs(cornell, plan, "cpu")
    again, _ = tk.device_inputs(cornell, plan, "cpu")
    layout = tk._device_layout(32, 32, plan.T, "cpu")[0]
    assert args[0] is again[0] and args[0] is not layout
    assert torch.equal(args[0], layout) and not layout[:, 3].any()
    out = torch.zeros((4, tk.OUT_ROWS, plan.T))
    out[:, 4, :] = torch.tensor([3.0, 9.0, 1.0, 9.0])[:, None]
    tk._longest_first(args[0], out)
    assert args[0][:, 3, 0].tolist() == [2.0, 4.0, 1.0, 3.0]
    assert not args[0][:, 3, 1:].any() and not layout[:, 3].any()
    for scene, kw in ((cornell, dict(exact=True)),
                      (make_scene("random_balls", 1.0), {})):
        _, other = tk.make_plan(scene, 32, 32, 2, max_depth=4, **kw)
        assert not tk._orders_tiles(other)
        got, _ = tk.device_inputs(scene, other, "cpu")
        assert got[0] is tk._device_layout(32, 32, other.T, "cpu")[0]
