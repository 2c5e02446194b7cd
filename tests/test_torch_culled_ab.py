"""The host side of the kernels' A/B tool
(raytracingweekend_tpu_torch/tools/culled_ab.py) and of the measurement
builds it names (ops/_build.py): the tool times the dense (K1-K4, K8) and
culled (K5 / K5s) kernels, K7 and K9 on the card only, so here it is held
to its builds, its cells, K7's slot loop count (tools/sass.py), its
interface test and its refusal without a card."""
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
\tFunction : _ZN12_GLOBAL__N_118hit_spheres_kernelILb1EEEvPKfPK6float4iifPfPi
        /*0000*/                   MUFU.RSQ R6, R5 ;
        /*0010*/                   FADD R7, R5, R6 ;
        /*0020*/                   BRA 0x0 ;
"""


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
    """K7's instantiations are named by form (first version: by its
    moving flag), and its slot loop is counted a ray-slot pair."""
    assert sass.kernel_name(
        "_ZN12_GLOBAL__N_118hit_spheres_kernelILi7ELb0EEEvNS_4RaysE") == \
        "k7<7,0>"
    got = sass.k7_loops(LISTING)
    assert got["k7<2,1>"] == dict(sass_per_pair=3.5, pairs_an_iteration=2,
                                  FFMA=0.5, FMUL=0.5, FADD=0.0, LDS=0.5,
                                  BRA=1.0)
    assert got["k7<1>"]["sass_per_pair"] == 3.0
    # the megakernels' slot loop report leaves K7 out
    assert sass.slot_loops(LISTING) == {}


def test_k7_first_version_is_told_by_its_exports():
    """A build without `rtw_k7_consts` is K7's first version's
    interface."""
    class Lib:
        rtw_k7_consts = object()

    assert not culled_ab._k7_first_version(Lib())
    assert culled_ab._k7_first_version(object())


def test_bind_gives_each_k7_interface_its_own_argtypes():
    """A build is bound to the K7 interface it exports: the shipped one
    (19 arguments, with `rtw_k7_consts`) or the first version's (9), so no
    build is called through the other's signature."""
    from types import SimpleNamespace

    class Lib:
        """Every entry point a build exports, `rtw_k7_consts` if asked."""

        def __init__(self, consts):
            if consts:
                self.rtw_k7_consts = SimpleNamespace()

        def __getattr__(self, name):
            if name == "rtw_k7_consts":
                raise AttributeError(name)
            setattr(self, name, SimpleNamespace())
            return getattr(self, name)

    new = culled_ab.bind(Lib(True))
    first = culled_ab.bind(Lib(False))
    assert len(new.rtw_hit_spheres_launch.argtypes) == 19
    assert len(first.rtw_hit_spheres_launch.argtypes) == 9


def test_k7_and_k9_cells_are_cells(monkeypatch):
    """The K7 cells name the three K7 scenes, the K9 cell its nine rows;
    all are taken by --cells and run by default."""
    assert set(culled_ab.K7_CELLS.values()) == {
        "random_balls", "random_balls_large", "random_balls_huge"}
    assert set(culled_ab.ALL_CELLS) == {*culled_ab.CELLS,
                                        *culled_ab.K7_CELLS, "k9"}
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
    ("cornell", True, False, 0, True), ("earth", True, False, 0, True)])
def test_cells_plan_the_dense_kernels(cell, surfaces, exact, axes,
                                      uniform_time):
    """A dense cell's launch at a small size plans a dense kernel (K1, or
    K2-K4 with surfaces) with its spp a launch, its mode and its slot
    loop's moving-axis mask."""
    name, args, plan = culled_ab.cell_inputs(cell, 32, 32, 4, device="cpu")
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
