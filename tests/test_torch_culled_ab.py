"""The host side of the culled sweep's A/B tool
(raytracingweekend_tpu_torch/tools/culled_ab.py) and of the measurement
builds it names (ops/_build.py): the tool times K5 / K5s on the card only,
so here it is held to its builds, its cells and its refusal without a
card."""
from pathlib import Path

import pytest

torch = pytest.importorskip("torch")

from raytracingweekend_tpu_torch.ops import _build  # noqa: E402
from raytracingweekend_tpu_torch.tools import culled_ab  # noqa: E402


def test_variant_defines():
    """The instrumented build is megakernel.cu alone with -DRTW_SPLIT;
    the kernels' build is every source with no define."""
    assert culled_ab.SPLIT == ("RTW_SPLIT",)
    assert "-DRTW_SPLIT" in _build._flags(culled_ab.SPLIT)
    assert not any(f.startswith("-D") for f in _build._flags(()))
    assert _build._sources((), _build.CSRC) == sorted(
        _build.CSRC.glob("*.cu"))
    assert _build._sources(culled_ab.SPLIT, _build.CSRC) == [
        _build.CSRC / "megakernel.cu"]


def test_measurement_builds_are_libraries_of_their_own(tmp_path):
    """Each build (defines, or another checkout's csrc/) hashes to its
    own library; another checkout builds its megakernel.cu alone."""
    other = tmp_path / "csrc"
    other.mkdir()
    (other / "megakernel.cu").write_text("// another checkout\n")
    paths = {_build.library_path(d, c) for d, c in [
        ((), _build.CSRC), (culled_ab.SPLIT, _build.CSRC), ((), other)]}
    assert len(paths) == 3
    assert _build._sources((), other) == [Path(other) / "megakernel.cu"]


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


def test_run_refuses_without_a_card():
    if torch.cuda.is_available():
        pytest.skip("a card is present")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        culled_ab.run(cells=("large",))
