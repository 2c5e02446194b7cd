"""The host side of the sweeps' A/B tool
(raytracingweekend_tpu_torch/tools/culled_ab.py) and of the measurement
builds it names (ops/_build.py): the tool times the dense (K1-K4, K8) and
culled (K5 / K5s) kernels on the card only, so here it is held to its
builds, its cells and its refusal without a card."""
from pathlib import Path

import pytest

torch = pytest.importorskip("torch")

from raytracingweekend_tpu_torch.ops import _build  # noqa: E402
from raytracingweekend_tpu_torch.tools import culled_ab  # noqa: E402


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
    own library; another checkout builds its megakernel.cu and
    sweep_twin.cu (the kernels that share the dense slot loop) alone."""
    other = tmp_path / "csrc"
    other.mkdir()
    (other / "megakernel.cu").write_text("// another checkout\n")
    (other / "sweep_twin.cu").write_text("// its sweep twin\n")
    paths = {_build.library_path(d, c) for d, c in [
        ((), _build.CSRC), (culled_ab.SPLIT, _build.CSRC), ((), other)]}
    assert len(paths) == 3
    assert _build._sources((), other) == [Path(other) / "megakernel.cu",
                                          Path(other) / "sweep_twin.cu"]


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
