"""The dense sphere sweep's host side (K1-K4's slot loop and the twin K8):
its hit test, its staged shared-memory layout, its moving-axis masks and
the dense kernels' tile widths, on the CPU.

- The slot loop's hit test `t = tn > t_min ? tn : tf`, taken when
  `tf > t_min && t < best`, is the old select chain (`t = tn > t_min ? tn
  : (tf > t_min ? tf : BIG)`, taken when `t < best`) bit for bit: on the
  edge cases one at a time, through the quadratic's root, and over seeded
  random sweeps.
- `shared_bytes` counts the staged layout of csrc/sweep.cuh: 16 B a
  static slot, 20 y only (one shutter window), 32 (36) all axes, the
  second without a uniform shutter.
- `make_plan` refuses an overdraw tile past DENSE_MAX_T (ROADMAP F3) for
  the sphere and the surfaces kernels before any launch; exact mode runs
  blocks of 256 and takes T = 1024.
- `sweep_axes` maps a plan's moving axes to the instantiation's mask, and
  a library whose dense forms, staged words or block limits differ from
  the plan's is refused.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from raytracingweekend_tpu_torch.models import builder  # noqa: E402
from raytracingweekend_tpu_torch.models import probe_scenes  # noqa: E402
from raytracingweekend_tpu_torch.models import scene_types  # noqa: E402
from raytracingweekend_tpu_torch.models.scenes import make_scene  # noqa: E402
from raytracingweekend_tpu_torch.ops import megakernel as tk  # noqa: E402
from raytracingweekend_tpu_torch.tools import sweep_twin as tw  # noqa: E402

F32 = np.float32
BIG = F32(tk.BIG)
T_MIN = F32(0.001)
INF, NAN = F32(np.inf), F32(np.nan)
SUB = F32(1e-39)            # a positive subnormal float32


def _old_hit(tn, tf, best, t_min):
    """The parent's select chain: (new best, taken)."""
    big = torch.full_like(tn, float(BIG))
    t = torch.where(tn > t_min, tn, torch.where(tf > t_min, tf, big))
    take = t < best
    return torch.where(take, t, best), take


def _new_hit(tn, tf, best, t_min):
    """csrc/sweep.cuh sweep_slots' hit test: (new best, taken)."""
    t = torch.where(tn > t_min, tn, tf)
    take = (tf > t_min) & (t < best)
    return torch.where(take, t, best), take


def _assert_same(tn, tf, best, t_min=T_MIN):
    args = [torch.tensor(np.asarray(v, F32)) for v in (tn, tf, best)]
    b0, k0 = _old_hit(*args, float(t_min))
    b1, k1 = _new_hit(*args, float(t_min))
    assert torch.equal(k0, k1)
    # bitwise, signed zeros included
    assert torch.equal(b0.view(torch.int32), b1.view(torch.int32))
    return bool(k1.all())


@pytest.mark.parametrize("tn,tf,best,taken", [
    (NAN, NAN, BIG, False),                 # disc < 0 or == 0: NaN root
    (NAN, NAN, F32(2.0), False),
    (F32(-0.0), F32(0.0), BIG, False),      # signed zeros below t_min
    (F32(0.0), F32(-0.0), BIG, False),
    (F32(-0.0), F32(3.0), BIG, True),
    (T_MIN, F32(5.0), BIG, True),           # tn exactly t_min: far root
    (F32(-1.0), T_MIN, BIG, False),         # tf exactly t_min: a miss
    (T_MIN, T_MIN, BIG, False),
    (F32(-1.0), F32(3.0), BIG, True),       # tn < t_min < tf
    (F32(-3.0), F32(-1.0), BIG, False),     # both roots below t_min
    (F32(-3.0), F32(-1.0), F32(0.5), False),
    (F32(2.0), F32(5.0), F32(2.0), False),  # near root ties the best
    (F32(-1.0), F32(2.0), F32(2.0), False),  # far root ties the best
    (F32(2.0), F32(5.0), np.nextafter(F32(2.0), F32(3.0)), True),
    (BIG, BIG, BIG, False),                 # kBig against the initial best
    (F32(-1.0), BIG, BIG, False),
    (F32(3e38), F32(3e38), BIG, False),     # past kBig
    (-INF, INF, BIG, False),                # a flushed subnormal disc
    (-INF, INF, F32(2.0), False),
    (F32(0.5), INF, BIG, True),
])
def test_hit_test_equals_old_select_chain(tn, tf, best, taken):
    """One slot: the same new best and decision, bit for bit, with the
    decision expected."""
    assert _assert_same([tn], [tf], [best]) == taken


@pytest.mark.parametrize("nb,disc", [
    (F32(5.0), F32(-1.0)), (F32(5.0), F32(0.0)), (F32(5.0), F32(-0.0)),
    (F32(5.0), SUB), (F32(5.0), -SUB), (F32(0.0), F32(1.0)),
    (F32(-0.0), F32(1.0)), (F32(1.0), F32(1.0)), (F32(-1.0), F32(1.0)),
    (F32(1.0005), F32(0.00000025)), (F32(0.001), F32(1e-12)),
    (F32(3.0), F32(4.0)), (F32(-5.0), F32(4.0)), (INF, INF),
    (F32(1e19), F32(1e38)), (NAN, F32(1.0))])
@pytest.mark.parametrize("best", [BIG, F32(2.0), F32(1.0), F32(1e-3)])
def test_hit_test_equal_through_the_root(nb, disc, best):
    """(tn, tf) from the quadratic's root as the loop takes it (sq = disc *
    rsqrt(disc), a subnormal disc flushed): the two chains agree, and a
    NaN, zero or subnormal disc is a miss."""
    n, d = torch.tensor([nb]), torch.tensor([disc])
    sq = d * tk._rsqrt_ftz(d)
    taken = _assert_same((n - sq).numpy(), (n + sq).numpy(), [best])
    if not float(disc) > float(tk._F32_MIN_NORMAL):
        assert not taken


def test_hit_test_equal_over_random_sweeps():
    """Seeded random sweeps of 512 slots over 256 rays, roots from random
    discriminants (negative, zero, subnormal and normal) with ties: the
    running best and the winner slot, the first with the smallest t, are
    the same."""
    rng = np.random.default_rng(11)
    n, S = 256, 512
    nb = rng.choice([-2.0, 0.0, 0.001, 1.0, 2.0, 3.5], (S, n)).astype(F32)
    nb += rng.normal(0, 1, (S, n)).astype(F32) * (rng.random((S, n)) < 0.5)
    disc = rng.choice([-1.0, 0.0, 1e-39, 1e-6, 0.25, 1.0, 4.0], (S, n))
    disc = (disc * (1 + 0.1 * rng.random((S, n)))).astype(F32)
    disc[:, :16] = -np.abs(disc[:, :16]) - 1   # rays missing every slot
    d = torch.from_numpy(disc)
    sq = d * tk._rsqrt_ftz(d)
    nbt = torch.from_numpy(nb)
    tn, tf = nbt - sq, nbt + sq
    best = {k: torch.full((n,), float(BIG)) for k in ("old", "new")}
    slot = {k: torch.full((n,), S) for k in ("old", "new")}
    for s in range(S):
        for k, hit in (("old", _old_hit), ("new", _new_hit)):
            best[k], take = hit(tn[s], tf[s], best[k], float(T_MIN))
            slot[k] = torch.where(take, s, slot[k])
    assert torch.equal(best["old"].view(torch.int32),
                       best["new"].view(torch.int32))
    assert torch.equal(slot["old"], slot["new"])
    assert 0 < (slot["new"] < S).sum() < n


def _moving_scene(axes: str, uniform: bool):
    """Sphere-only builder scene: a static ground and ball, and two balls
    moving along `axes`, over [0, 1] (uniform) or over two windows."""
    b = builder.SceneBuilder()
    lam = b.lambertian(b.constant((0.5, 0.5, 0.5)))
    b.sphere((0, -1000, 0), 1000.0, lam)
    b.sphere((0, 1, 0), 1.0, lam)
    for k, (t0, t1) in enumerate(((0.0, 1.0), (0.0, 1.0) if uniform
                                  else (0.25, 0.75))):
        c0 = (2.0 * k, 0.5, 1.0)
        c1 = tuple(c + (0.4 if "xyz"[a] in axes else 0.0)
                   for a, c in enumerate(c0))
        b.sphere(c0, 0.5, lam, center1=c1, time0=t0, time1=t1)
    b.camera((13, 2, 3), (0, 0, 0), (0, 1, 0), 20.0, 1.0, 0.0, 10.0,
             0.0, 1.0)
    return b.build(background=scene_types.BG_GRADIENT, name=f"move_{axes}")


# (scene, the plan's mask, uniform shutter, bytes a staged slot)
LAYOUTS = {
    "static": (lambda: make_scene("dielectric", 1.0), tk.AXES_STATIC,
               True, 16),
    "static_large": (lambda: make_scene("random_balls_large", 1.0, n=16),
                     tk.AXES_STATIC, True, 16),
    "y_only": (lambda: make_scene("random_balls", 1.0), tk.AXIS_Y, True,
               20),
    "y_only_shutter": (lambda: _moving_scene("y", False), tk.AXES_ALL,
                       False, 36),
    "x_only": (lambda: _moving_scene("x", True), tk.AXES_ALL, True, 32),
    "all_axes": (lambda: _moving_scene("xyz", True), tk.AXES_ALL, True, 32),
    "all_axes_shutter": (lambda: probe_scenes.shutter_scene(builder,
                                                            scene_types),
                         tk.AXES_ALL, False, 36)}


@pytest.mark.parametrize("name", list(LAYOUTS))
def test_shared_bytes_count_the_staged_layout(name):
    """A dense sphere plan's shared memory is its staged slots: a 16-byte
    (cx, cy, cz, nr2) quad a slot, then dcy (4 B, y only under one
    shutter window) or (dcx, dcy, dcz, t0) (16 B, all axes) and, without
    a uniform shutter, 1/dt (4 B); `sweep_axes` gives the mask the kernel
    is instantiated for (a y-only plan with per-slot shutters takes the
    all-axes form)."""
    build, axes, uniform, per_slot = LAYOUTS[name]
    _, plan = tk.make_plan(build(), 32, 32, 2, cull=False)
    assert not plan.surfaces and plan.uniform_time == uniform
    assert tk.sweep_axes(plan) == axes
    assert tk.shared_bytes(plan) == per_slot * plan.S
    assert 4 * tk.slot_words(axes, uniform) == per_slot
    # the culled layout is unchanged: moving plans stage nothing
    if plan.C > 1:
        _, culled = tk.make_plan(build(), 32, 32, 2)
        warps = culled.T // 32
        stage = 0 if axes else warps * 2 * culled.SB * 16
        assert tk.shared_bytes(culled) == stage + 4 * culled.C * (
            6 + (warps if culled.dyn_order else 0))


def test_shared_bytes_add_the_surfaces_tables_after_the_slots():
    """A dense surfaces plan stages its slots first, then the rect runs
    (two float4 a rect) and their group headers (an int4 a rect at most),
    the camera vector, the rect, light and medium rows and their codes
    (cornell_box: 8 static slots, 12 rects of 19 lanes, two lights of 15,
    no medium)."""
    _, plan = tk.make_plan(make_scene("cornell_box", 1.0), 32, 32, 2)
    assert plan.surfaces and tk.sweep_axes(plan) == tk.AXES_STATIC
    words = (4 * plan.S + plan.R * (8 + 4) + (tk.CAM_T1 + 1)
             + plan.R * (tk.RT_RIDX + 1)
             + plan.L * (tk.LT_RAD + 1) + plan.V * (tk.MD_ALBZ + 1)
             + plan.R + plan.L + plan.V)
    assert tk.shared_bytes(plan) == 4 * words


@pytest.mark.parametrize("name,kind", [
    ("random_balls", "spheres"), ("dielectric", "spheres"),
    ("cornell_box", "surfaces"), ("cornell_smoke", "surfaces"),
    ("earth", "surfaces")])
def test_make_plan_refuses_dense_tiles_past_the_launch_bounds(name, kind):
    """ROADMAP F3: the dense kernels, the sphere kernel and the surfaces
    one, launch blocks of at most DENSE_MAX_T = 512 lanes, so make_plan
    and trace_mega refuse a wider overdraw tile with ValueError before
    any launch; the widest accepted tile plans, and exact mode (blocks of
    256, T only the RNG key's width) takes T = 1024."""
    scene = make_scene(name, 1.0)
    top = tk.DENSE_MAX_T
    assert top == 512
    _, plan = tk.make_plan(scene, 32, 32, 2, T=top)
    assert not plan.cull and plan.surfaces == (kind == "surfaces")
    for T in (top + 32, 1024):
        with pytest.raises(ValueError, match=f"at most {top} lanes"):
            tk.make_plan(scene, 32, 32, 2, T=T)
        with pytest.raises(ValueError, match=f"at most {top} lanes"):
            tk.trace_mega(1, scene, 8, 8, 1, max_depth=2, T=T,
                          device="cpu")
    assert tk.make_plan(scene, 32, 32, 2, T=1024, exact=True)[1].T == 1024


def test_dense_width_reaches_the_cli_help():
    """The CLI and RenderConfig state the real widths."""
    import inspect
    from raytracingweekend_tpu_torch import render
    from raytracingweekend_tpu_torch.utils import config
    text = inspect.getsource(render.main)
    assert "at most 512" in text and "at most 1024" not in text
    cfg = inspect.getsource(config)
    assert "at most\n    # 512" in cfg


@pytest.mark.parametrize("name,axes", [
    ("static", tk.AXES_STATIC), ("y_only", tk.AXIS_Y),
    ("y_only_shutter", tk.AXES_ALL), ("x_only", tk.AXES_ALL),
    ("all_axes", tk.AXES_ALL), ("all_axes_shutter", tk.AXES_ALL)])
def test_sweep_axes_dispatch(name, axes):
    """moving_axes to the instantiation's mask: none -> static, y alone
    under one shutter window -> y only, any other -> all axes; the (mask,
    shutter) form is one the kernels are instantiated for (DENSE_FORMS,
    the static form whatever the shutter)."""
    _, plan = tk.make_plan(LAYOUTS[name][0](), 16, 16, 1, cull=False)
    assert tk.sweep_axes(plan) == axes
    form = (axes, plan.uniform_time if axes else False)
    assert form in tk.DENSE_FORMS
    # a scene marked moving whose centres stay put keeps the moving form
    import dataclasses
    still = dataclasses.replace(plan, moving=True,
                                moving_axes=(False, False, False))
    assert tk.sweep_axes(still) == tk.AXES_ALL


class _DenseLib:
    """A stand-in for the kernel library's rtw_dense_consts: `rows` of
    (axes, uniform, slot words, sphere / surfaces / textured block
    limits)."""

    def __init__(self, rows):
        self.rows = rows

    def rtw_dense_consts(self, out, n):
        for i, row in enumerate(self.rows[:n]):
            out[6 * i:6 * i + 6] = list(row)
        return len(self.rows)


def _dense_rows(**change):
    rows = [[a, int(u), tk.slot_words(a, u)] + [tk.DENSE_MAX_T] * 3
            for a, u in tk.DENSE_FORMS]
    for (i, k), v in change.get("set", {}).items():
        rows[i][k] = v
    return rows[::-1] if change.get("reverse") else rows


@pytest.mark.parametrize("change,ok", [
    ({}, True),
    ({"reverse": True}, False),                 # forms in another order
    ({"set": {(1, 2): 9}}, False),              # the y form's slot words
    ({"set": {(0, 3): 1024}}, False),           # a sphere block limit
    ({"set": {(3, 5): 256}}, False)])           # a textured block limit
def test_dense_consts_are_the_kernels(change, ok):
    """Plans count the shared memory and refuse the tiles the kernels do:
    loading a library whose exported dense forms (rtw_dense_consts: mask,
    shutter, staged words a slot, block limits) differ from DENSE_FORMS,
    `slot_words` and DENSE_MAX_T raises; one form too few raises too."""
    lib = _DenseLib(_dense_rows(**change))
    if ok:
        tk.check_dense_consts(lib)
        assert tk.dense_max_threads(lib) == {
            "spheres": [tk.DENSE_MAX_T] * len(tk.DENSE_FORMS),
            "surfaces": [tk.DENSE_MAX_T] * 2 * len(tk.DENSE_FORMS)}
    else:
        with pytest.raises(RuntimeError, match="kernel library's dense"):
            tk.check_dense_consts(lib)
    with pytest.raises(RuntimeError, match="not 4 forms"):
        tk.check_dense_consts(_DenseLib(_dense_rows()[:3]))


def test_plain_root_flushes_subnormal_discriminants():
    """The plain version's root takes a subnormal disc as zero of its
    sign (the kernel's rsqrt.approx.ftz): sq = +inf, a miss; normal
    inputs keep `_rsqrt`."""
    d = torch.tensor([1e-39, -1e-39, 0.0, 4.0, 1.5e-38, -1.0],
                     dtype=torch.float32)
    got = tk._rsqrt_ftz(d)
    assert got[0] == np.inf and got[1] == -np.inf and got[2] == np.inf
    assert torch.equal(got[3:5], tk._rsqrt(d[3:5]))
    assert torch.isnan(got[5])
    sq = d * got
    assert sq[0] == np.inf and sq[1] == np.inf


def test_twin_plain_version_lerps_y_only_as_k1_book1():
    """The twin's plain slot test lerps y alone, as K1's book-1
    instantiation, and gives the all-axes lerp's bits on the book-1
    table, whose x and z deltas are zero."""
    soa, _, plan = tw.book1_inputs("cpu")
    assert tk.sweep_axes(plan) == tk.AXIS_Y
    assert not soa[3].any() and not soa[5].any() and soa[4].any()
    rays = tuple(r[:64, None] for r in tw.initial_rays(256, "cpu"))
    fr = (rays[6] - plan.ut_t0) * plan.ut_idt
    t_y = tw.slot_t(soa, rays, fr)
    full = list(soa)      # x and z lerped per ray, as the old loop did
    full[0] = tw._fma(fr, soa[3], soa[0])
    full[2] = tw._fma(fr, soa[5], soa[2])
    t_all = tw.slot_t(full, rays, fr)
    assert torch.equal(t_y.view(torch.int32), t_all.view(torch.int32))
    assert (t_y < tw.BIG).any()


LISTING = """
\tFunction : _ZN12_GLOBAL__N_111mega_kernelILi2ELb1EEEvNS_6ParamsE
        /*0000*/                   MOV R1, c[0x0][0x28] ;
        /*0010*/                   LDS.128 R4, [R2] ;
        /*0020*/                   LDS R8, [R3] ;
        /*0030*/                   FFMA R5, R9, R8, R5 ;
        /*0040*/                   FADD R4, R4, -R10 ;
        /*0050*/                   FMUL R6, R5, R11 ;
        /*0060*/                   MUFU.RSQ R7, R6 ;
        /*0070*/                   LDS.128 R12, [R2+0x10] ;
        /*0080*/                   MUFU.RSQ R13, R12 ;
        /*0090*/               @P0 BRA 0x10 ;
        /*00a0*/                   EXIT ;
\tFunction : _ZN12_GLOBAL__N_117microbench_kernelILi1ELi2EEEvv
        /*0000*/                   EXIT ;
"""


def test_sass_names_instantiations_and_counts_slot_loops():
    """tools/sass.py (chip_smoke.py phase 2, culled_ab.py's build rows):
    the instantiation names of the dense kernels' (mask, shutter[, tex])
    templates and the culled kernels' (moving, shutter[, tex]), and a
    slot loop's instructions, slots (MUFU.RSQ), FFMA, FMUL, FADD and
    shared loads."""
    from raytracingweekend_tpu_torch.tools import sass
    names = {
        "_ZN12_GLOBAL__N_111mega_kernelILi2ELb1EEEvNS_6ParamsE": "<2,1>",
        "_ZN12_GLOBAL__N_120mega_kernel_surfacesILi7ELb0ELb1EEEvNS_6Par":
            "surfaces<7,0,1>",
        "_ZN12_GLOBAL__N_118mega_kernel_culledILb1ELb1EEEvNS_6ParamsE":
            "culled<1,1>",
        "_ZN12_GLOBAL__N_127mega_kernel_culled_surfacesILb0ELb0ELb1EEEv":
            "culled_surfaces<0,0,1>",
        "_ZN12_GLOBAL__N_117sweep_twin_kernelILb0EEEvPKfS2_PfS3_iiffff":
            "twin<0>",
        "_ZN12_GLOBAL__N_117microbench_kernelILi1ELi2EEEvv": "k9<1,2>"}
    for mangled, name in names.items():
        assert sass.kernel_name(mangled) == name
    assert sass.slot_loops(LISTING) == {"<2,1>": (9, 2, 1, 1, 1, 3)}
    log = ("ptxas info    : Compiling entry function "
           "'_ZN12_GLOBAL__N_111mega_kernelILi0ELb0EEEvNS_6ParamsE' for "
           "'sm_90a'\nptxas info    : Function properties for x\n"
           "    16 bytes stack frame, 4 bytes spill stores, 4 bytes spill "
           "loads\nptxas info    : Used 80 registers, used 1 barriers")
    assert sass.registers(log) == {"<0,0>": (80, 4, 16)}
