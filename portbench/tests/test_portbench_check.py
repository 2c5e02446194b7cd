"""The output check decides: a sound run is correct, and a run with the
timed path broken underneath, or with the control in the program's
place, is not. The runs here are the harness's own on the CPU (the
program's plain versions), with the look for a card skipped."""
import pytest
import torch
from conftest import tiny_cell

from portbench import check, control, harness
from portbench.reference import render as rrender
from raytracingweekend_tpu_torch import render as prender

CELLS = [w["name"] for w in harness.load_spec()["workloads"]]


def _run(cell, seed=2 ** 31 + 101, render_fn=None):
    return harness.run_cell(cell, seed, 0.01, False, device="cpu",
                            render_fn=render_fn, log=lambda *a: None)


@pytest.mark.parametrize("name", CELLS)
def test_sound_run_is_correct(name):
    res = _run(tiny_cell(name))
    assert res["correct"]
    assert res["checks"]["mismatch_share"]["value"] == 0.0


def _unchanged(orig, per_image):
    """The first launch of each image (of `per_image` launches) returns
    the canvas unchanged."""
    def fn(scene, seed, nx, ny, chunk_spp, *a, **kw):
        part, segs = orig(scene, seed, nx, ny, chunk_spp, *a, **kw)
        if fn.calls % per_image == 0:
            part = torch.zeros_like(part)
        fn.calls += 1
        return part, segs
    fn.calls = 0
    return fn


def _half(orig, per_image):
    """Each launch traces half its samples and scales their sum up."""
    def fn(scene, seed, nx, ny, chunk_spp, *a, **kw):
        half = max(chunk_spp // 2, 1)
        part, segs = orig(scene, seed, nx, ny, half, *a, **kw)
        return part * (chunk_spp / half), segs
    return fn


def _altered(orig, per_image):
    """Each launch's radiance sums altered by a thousandth."""
    def fn(*a, **kw):
        part, segs = orig(*a, **kw)
        return part * 1.001, segs
    return fn


@pytest.mark.parametrize("name", CELLS)
@pytest.mark.parametrize("fault", [_unchanged, _half, _altered])
def test_fault_in_the_timed_path_is_not_correct(name, fault, monkeypatch):
    cell = tiny_cell(name)
    mix = cell["traffic"]
    per_image = len(rrender.launches(mix.get("spp", cell["config"]["spp"]),
                                     mix["samples_per_launch"]))
    monkeypatch.setattr(prender, "render_chunk_mega",
                        fault(prender.render_chunk_mega, per_image))
    res = _run(cell)
    assert not res["correct"]
    assert res["checks"]["mismatch_share"]["value"] > 0.5


@pytest.mark.parametrize("name", CELLS)
def test_control_in_the_program_place_is_not_correct(name):
    cell = tiny_cell(name)
    seed = 2 ** 31 + 202
    ccell = dict(cell, traffic=dict(cell["traffic"], warmup_images=0))
    res = harness.run_cell(ccell, seed, 1e-3, False, device="cpu",
                           render_fn=control.control_render(cell, seed,
                                                            "cpu"),
                           log=lambda *a: None)
    assert res["attempted"] == 1
    assert not res["correct"]
    assert res["checks"]["mismatch_share"]["value"] > 0.5


def test_judge_holds_each_number_to_its_limit():
    ok, lines = check.judge({"mismatch_share": 0.0},
                            {"mismatch_share": 0.02})
    assert ok and lines == ["mismatch_share 0.0 limit 0.02"]
    assert not check.judge({"mismatch_share": 0.03},
                           {"mismatch_share": 0.02})[0]
    assert not check.judge({}, {"mismatch_share": 0.02})[0]


def test_mismatches_counts_channels_and_non_finite_values():
    a = torch.zeros((2, 2, 3))
    b = a.clone()
    b[0, 0, 0] = 1.0
    a[1, 1, 2] = float("nan")
    assert check.mismatches(a, b, torch.arange(4)) == (2, 12)
    assert check.mismatches(a, b, torch.tensor([1, 2])) == (0, 6)
