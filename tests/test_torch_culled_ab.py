"""The host side of the kernels' A/B tool
(raytracingweekend_tpu_torch/tools/culled_ab.py) and of the measurement
builds it names (ops/_build.py): the tool times the dense (K1-K4, K8) and
culled (K5 / K5s) kernels, K7 and K9 on the card only, so here it is held
to its builds, its cells, its split's parts and grid tail, the loop
counts of tools/sass.py (K7's slot loop, the surfaces kernels' rect and
light loops) and its refusal without a card."""
from pathlib import Path

import pytest

torch = pytest.importorskip("torch")

from raytracingweekend_tpu_torch.ops import _build  # noqa: E402
from raytracingweekend_tpu_torch.tools import culled_ab, sass  # noqa: E402

# a K7 slot loop as cuobjdump lists it: two ray-slot pairs an iteration
LISTING = """
\tFunction : _ZN12_GLOBAL__N_118hit_spheres_kernelILi2ELb1EEEvNS_4RaysE
        /*0000*/                   MOV R1, c[0x0][0x28] ;
        /*0010*/                   LDS.128 R4, [R2] ;
        /*0020*/                   FFMA R5, R4, R4, R3 ;
        /*0030*/                   MUFU.RSQ R6, R5 ;
        /*0040*/              @P0   BRA 0x100 ;
        /*0050*/                   FMUL R7, R5, R6 ;
        /*0060*/                   MUFU.RSQ R6, R5 ;
        /*0070*/              @P1   BRA 0x10 ;
        /*0080*/                   EXIT ;
\tFunction : _ZN12_GLOBAL__N_118hit_spheres_kernelILi0ELb1EEEvNS_4RaysE
        /*0000*/                   MUFU.RSQ R6, R5 ;
        /*0010*/                   FADD R7, R5, R6 ;
        /*0020*/                   BRA 0x0 ;
"""
# a surfaces kernel as cuobjdump lists it: a rect row loop (bounds tests,
# no MUFU), a light loop (a root and a division), a slab loop (min / max:
# not a rect loop) and the loads
SURFACES = r"""
\tFunction : _ZN12_GLOBAL__N_120mega_kernel_surfacesILi0ELb0ELi3EEEv6Params8Surfaces6Texels
        /*0000*/                   LDS.128 R20, [R24] ;
        /*0010*/                   LDS.128 R24, [R24+0x10] ;
        /*0020*/                   FADD R25, R20, -R70 ;
        /*0030*/                   FMUL R20, R25, R16 ;
        /*0040*/                   FSETP.GT.AND P0, PT, R20, R69, PT ;
        /*0050*/                   FSETP.GE.AND P0, PT, R67, R21, P0 ;
        /*0060*/                   FSETP.LE.AND P0, PT, R67, R22, P0 ;
        /*0070*/                   FSETP.GE.AND P0, PT, R68, R23, P0 ;
        /*0080*/                   FSEL R64, R20, R64, P0 ;
        /*0090*/              @P1   BRA 0x0 ;
        /*00a0*/                   LDS R16, [R72] ;
        /*00b0*/                   MUFU.RSQ R19, R20 ;
        /*00c0*/                   MUFU.RCP R17, R21 ;
        /*00d0*/                   FADD R66, R17, R66 ;
        /*00e0*/              @!P4  BRA 0xa0 ;
        /*00f0*/                   LDS R16, [R72] ;
        /*0100*/                   FMNMX R1, R2, R3, !PT ;
        /*0110*/                   FSETP.GT.AND P0, PT, R20, R69, PT ;
        /*0120*/                   FSETP.GE.AND P0, PT, R67, R21, P0 ;
        /*0130*/                   FSETP.LE.AND P0, PT, R67, R22, P0 ;
        /*0140*/                   FSETP.GE.AND P0, PT, R68, R23, P0 ;
        /*0150*/              @P2   BRA 0xf0 ;
        /*0160*/                   LDG.E.CONSTANT R2, [R4.64] ;
        /*0170*/                   LD.E R3, [R6.64] ;
        /*0180*/                   EXIT ;
""".replace("\\t", "\t")


def test_variant_defines():
    """The instrumented build is megakernel.cu and sweep_twin.cu alone
    with -DRTW_SPLIT; the kernels' build is every source with no
    define."""
    assert culled_ab.SPLIT == ("RTW_SPLIT",)
    assert "-DRTW_SPLIT" in _build._flags(culled_ab.SPLIT)
    assert not any(f.startswith("-D") for f in _build._flags(()))
    assert _build._sources((), _build.CSRC) == sorted(
        _build.CSRC.glob("*.cu"))
    assert _build._sources(culled_ab.SPLIT, _build.CSRC) == [
        _build.CSRC / "megakernel.cu", _build.CSRC / "sweep_twin.cu"]


def test_measurement_builds_are_libraries_of_their_own(tmp_path):
    """Each build (defines, or another checkout's csrc/) hashes to its
    own library; another checkout builds every source of its csrc/ (the
    megakernels and K8, K7, K9 and the rest)."""
    other = tmp_path / "csrc"
    other.mkdir()
    for name in ("sweep_twin.cu", "megakernel.cu", "intersect.cu",
                 "sweep.cuh"):
        (other / name).write_text(f"// another checkout's {name}\n")
    paths = {_build.library_path(d, c) for d, c in [
        ((), _build.CSRC), (culled_ab.SPLIT, _build.CSRC), ((), other)]}
    assert len(paths) == 3
    assert _build._sources((), other) == [Path(other) / "intersect.cu",
                                          Path(other) / "megakernel.cu",
                                          Path(other) / "sweep_twin.cu"]


def test_k7_sass_names_and_slot_loop():
    """K7's instantiations are named by form, and its slot loop is
    counted a ray-slot pair."""
    assert sass.kernel_name(
        "_ZN12_GLOBAL__N_118hit_spheres_kernelILi7ELb0EEEvNS_4RaysE") == \
        "k7<7,0>"
    got = sass.k7_loops(LISTING)
    assert got["k7<2,1>"] == dict(sass_per_pair=3.5, pairs_an_iteration=2,
                                  FFMA=0.5, FMUL=0.5, FADD=0.0, LDS=0.5,
                                  BRA=1.0)
    assert got["k7<0,1>"]["sass_per_pair"] == 3.0
    # the megakernels' slot loop report leaves K7 out
    assert sass.slot_loops(LISTING) == {}


def test_surface_loops_count_rect_and_light_loops():
    """A surfaces instantiation's rect row loop (bounds tests, no MUFU),
    its light loop (a root and a division) and its loads by kind; a slab
    loop (min / max) is no rect loop."""
    assert sass.kernel_name(
        "_ZN12_GLOBAL__N_120mega_kernel_surfacesILi0ELb0ELi3EEEv6Params8"
        "Surfaces6Texels") == "surfaces<0,0,3>"
    got = sass.surface_loops(SURFACES)["surfaces<0,0,3>"]
    assert got["rect_loops"] == [10] and got["light_loops"] == [5]
    assert got["MUFU"] == {"RCP": 1, "RSQ": 1}
    assert (got["LDS"], got["LD"], got["LDG"], got["LDL"]) == (4, 1, 1, 0)
    assert got["instructions"] == 25
    assert sass.surface_loops(LISTING) == {}


def test_bind_binds_every_kernel():
    """A build is bound to every interface the tool calls: the
    megakernel's launch (46 arguments), K7's (19), K8's and K9's."""
    from types import SimpleNamespace

    class Lib:
        """Every entry point a build exports."""

        def __getattr__(self, name):
            setattr(self, name, SimpleNamespace())
            return getattr(self, name)

    lib = culled_ab.bind(Lib())
    assert len(lib.rtw_mega_launch.argtypes) == 46
    assert len(lib.rtw_hit_spheres_launch.argtypes) == 19
    assert lib.rtw_sweep_twin_launch.argtypes
    assert lib.rtw_microbench_launch.argtypes


def test_grid_tail_is_the_share_with_an_idle_sm():
    """grid_tail: the share of the launch during which fewer than all SMs
    hold a block, with an SM's back-to-back blocks one busy stretch, and
    the most blocks an SM held at once."""
    rec = [[0, 100, 0], [0, 100, 1], [100, 150, 0], [0, 50, 1],
           [50, 100, 1]]
    got = culled_ab.grid_tail(rec, 2)
    assert got["tail_share"] == pytest.approx(50 / 150)
    assert got["most_blocks_an_sm"] == 2
    assert (got["blocks"], got["sms"]) == (5, 2)
    assert got["longest_block_ms"] == 100 / 1e6
    assert got["mean_block_ms"] == pytest.approx(70 / 1e6)
    # three SMs, one never used: the whole launch is tail
    assert culled_ab.grid_tail(rec, 3)["tail_share"] == 1.0


def test_surface_split_parts_are_the_kernels():
    """The split's part names follow csrc/megakernel.cu's kSs* parts, in
    order."""
    src = (_build.CSRC / "megakernel.cu").read_text()
    enum = src[src.index("enum { kSsTotal"):]
    parts = enum[:enum.index("kSurfParts")].replace("enum {", "")
    names = [p.strip() for p in parts.split(",") if p.strip()]
    assert len(names) == len(culled_ab.SURF_KEYS)
    assert [n[3:].lower() for n in names] == [
        k.replace("_", "") for k in culled_ab.SURF_KEYS]


def test_k7_and_k9_cells_are_cells(monkeypatch):
    """The K7 cells name the three K7 scenes, the K9 cell its nine rows,
    the K11 and K14 cells their repros' two forms; all are taken by --cells
    and run by default."""
    assert set(culled_ab.K7_CELLS.values()) == {
        "random_balls", "random_balls_large", "random_balls_huge"}
    assert set(culled_ab.ALL_CELLS) == {*culled_ab.CELLS,
                                        *culled_ab.K7_CELLS, "k9", "k11",
                                        "k14"}
    seen = {}
    monkeypatch.setattr(culled_ab, "run", lambda *a: seen.update(args=a))
    culled_ab.main(["--cells", "k7_huge,k9"])
    assert seen["args"][0] == ("k7_huge", "k9")
    culled_ab.main([])
    assert seen["args"][0] == culled_ab.ALL_CELLS


@pytest.mark.parametrize("cell,surfaces,exact,moving,dyn_order", [
    ("large", False, False, False, 16), ("mixed60", True, False, False, 16),
    ("exact", False, True, False, 0), ("moving", True, False, True, 16),
    ("book1", False, False, True, 0)])
def test_cells_plan_the_culled_kernels(cell, surfaces, exact, moving,
                                       dyn_order):
    """A cell's launch at a small size plans the culled (surfaces) kernel
    with its spp a launch, its mode, its motion and its visit order."""
    name, args, plan = culled_ab.cell_inputs(cell, 32, 32, 4, device="cpu")
    assert name.startswith(culled_ab.CELLS[cell][0])
    assert plan.cull and plan.surfaces == surfaces
    assert plan.exact == exact and plan.moving == moving
    assert plan.dyn_order == dyn_order
    assert plan.spp == culled_ab.CELLS[cell][2]
    assert args[0].device.type == "cpu"


@pytest.mark.parametrize("cell,surfaces,exact,axes,uniform_time", [
    ("dense_book1", False, False, 2, True),
    ("dense_shutter", False, False, 7, False),
    ("dense_static", False, False, 0, True),
    ("dense_exact", False, True, 2, True),
    ("cornell", True, False, 0, True), ("earth", True, False, 0, True),
    ("cornell_smoke", True, False, 0, False),
    ("cornell_exact", True, True, 0, True),
    ("perlin", True, False, 0, True), ("checker", True, False, 0, True)])
def test_cells_plan_the_dense_kernels(cell, surfaces, exact, axes,
                                      uniform_time):
    """A dense cell's launch at a small size plans a dense kernel (K1, or
    K2-K4 with surfaces) with its spp a launch, its mode and its slot
    loop's moving-axis mask; the surfaces cells are the ones --split
    takes, cornell_exact the gradient path's tape plan (T = 1024, no
    roulette, depth 8)."""
    name, args, plan = culled_ab.cell_inputs(cell, 32, 32, 4, device="cpu")
    assert (cell in culled_ab.SURFACE_CELLS) == surfaces
    if cell == "cornell_exact":
        assert (plan.T, plan.rr_depth, culled_ab.DEPTHS[cell]) == (1024,
                                                                   None, 8)
    assert name.startswith(culled_ab.CELLS[cell][0])
    assert not plan.cull and plan.surfaces == surfaces
    assert plan.exact == exact and plan.uniform_time == uniform_time
    assert culled_ab.mk.sweep_axes(plan) == axes
    assert plan.spp == culled_ab.CELLS[cell][2]
    assert (plan.nx, plan.ny) == (32, 32)


def test_parents_are_repeatable(monkeypatch):
    """--parent takes several checkouts, each timed in turns; an unknown
    cell is refused."""
    seen = {}
    monkeypatch.setattr(culled_ab, "run", lambda *a: seen.update(args=a))
    culled_ab.main(["--cells", "twin,dense_book1", "--parent", "a",
                    "--parent", "b"])
    assert seen["args"] == (("twin", "dense_book1"), 3, ["a", "b"], False)
    with pytest.raises(SystemExit):
        culled_ab.main(["--cells", "nope"])


def test_run_refuses_without_a_card():
    if torch.cuda.is_available():
        pytest.skip("a card is present")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        culled_ab.run(cells=("large",))


class _ReproLib:
    """A stub build: `entries` are the symbols it exports."""

    def __init__(self, entries):
        self.entries = {n: type("Fn", (), {})() for n in entries}

    def __getattr__(self, name):
        if name == "entries" or name not in self.entries:
            raise AttributeError(name)
        return self.entries[name]


def test_repro_cells_launch_old_builds_positionally():
    """A build older than the argument block (no rtw_repro_empty_launch)
    gets its K11 / K14 entry typed positionally, the stream last; a newer
    one launches through the repros' launcher, bound at its first call."""
    c_int, c_void_p = culled_ab.ctypes.c_int, culled_ab.ctypes.c_void_p
    for cell, types in (("k11", [c_int, c_void_p, c_void_p, c_void_p, c_int,
                                 c_int, c_int]),
                        ("k14", [c_int, c_void_p, c_void_p, c_void_p, c_int,
                                 c_int])):
        _, name, slots, old = culled_ab.REPRO_CELLS[cell]
        assert len(old) == slots
        lib = _ReproLib([name])
        culled_ab._repro_launcher(lib, name, slots, old)
        fn = lib.entries[name]
        assert fn.argtypes == types + [c_void_p] and fn.restype is c_int
        new = _ReproLib([name, "rtw_repro_empty_launch"])
        culled_ab._repro_launcher(new, name, slots, old)
        assert not hasattr(new.entries[name], "argtypes")
