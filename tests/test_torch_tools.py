"""The port's golden, A/B and timing tools (raytracingweekend_tpu_torch/
tools/) on the CPU, at tiny shapes, against the port itself: the golden
gate against tests/test_golden.py's formula on both sides of each
threshold, every golden reached (the earth ones on the oracle's texels),
the dense-vs-culled check (and that a perturbed variant fails it), and
the timers' rows, seeds, refusals and outputs. The tests that hold the
tools against the JAX package are in tests/test_torch_tools_jax.py."""
import json
import os

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from raytracingweekend_tpu_torch.models import scenes as tscenes  # noqa: E402
from raytracingweekend_tpu_torch.ops import megakernel as mk  # noqa: E402
from raytracingweekend_tpu_torch.render import launch_seed  # noqa: E402
from raytracingweekend_tpu_torch.tools import (  # noqa: E402
    RTWI, bench_all, cull_sweep, dyn_ab_check, golden_report, mega_perf,
    tool_scene)

torch.set_num_threads(2)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CPU = ["--device", "cpu"]
TINY = ["--nx", "16", "--ny", "16", "--spp", "2", "--max-depth", "3",
        "--launches", "1"]


def _rows(capsys):
    return [json.loads(x) for x in capsys.readouterr().out.splitlines()
            if x.startswith("{")]


def _reference_gate(o, g, spp):
    """tests/test_golden.py::test_golden_pixelwise's two asserts."""
    mean_ok = abs(o.mean() - g.mean()) / max(g.mean(), 1e-6) < 0.02
    err = np.abs(o - g)
    tol = 0.05 + 4.0 * np.sqrt(np.maximum(g, 0.0) / spp)
    return bool(mean_ok and (err <= tol).mean() > 0.995)


# a 32x32 golden has 3072 values; > 99.5% within tolerance is at most 15
# outside it. Cases straddle each threshold: the mean at rel 0.0199 /
# 0.0201, 15 / 16 values outside, and a pixel error inside the tolerance
# at spp 64 and outside it at spp 4096
@pytest.mark.parametrize("scale, n_bad, err, spp", [
    (1.0199, 0, 0.0, 1024), (1.0201, 0, 0.0, 1024),
    (0.9801, 0, 0.0, 1024), (0.9799, 0, 0.0, 1024),
    (1.0, 15, 1.0, 1024), (1.0, 16, 1.0, 1024),
    (1.0, 15, -1.0, 1024), (1.0, 16, -1.0, 1024),
    (1.0, 40, 0.2, 64), (1.0, 40, 0.2, 4096),
    (1.0199, 15, 1.0, 1024), (1.0, 0, 0.0, 1)])
def test_gate_is_test_goldens_formula(scale, n_bad, err, spp):
    rng = np.random.default_rng(n_bad + int(spp))
    g = rng.uniform(0.2, 0.8, (32, 32, 3))
    o = g * scale
    flat = o.reshape(-1)
    idx = rng.choice(flat.size, n_bad, replace=False)
    flat[idx] += err
    row = golden_report.gate(o, g, spp)
    assert row["passed"] == _reference_gate(o, g, spp)
    tol = 0.05 + 4.0 * np.sqrt(g / spp)
    assert row["frac_ok"] == float((np.abs(o - g) <= tol).mean())
    assert row["mean_rel"] == pytest.approx(
        abs(o.mean() - g.mean()) / g.mean(), rel=1e-12)


def test_gate_fails_a_non_finite_image():
    g = np.full((4, 4, 3), 0.5)
    o = g.copy()
    o[0, 0, 0] = np.nan
    assert not golden_report.gate(o, g, 64)["passed"]


def test_golden_spp_from_file_names():
    assert {n: golden_report.golden_spp(f)
            for n, f in golden_report.GOLDENS.items()} == {
        "dielectric": 4096, "light_sample": 4096, "cornell_box": 8192,
        "random_balls": 2048, "cornell_smoke": 8192, "earth": 4096,
        "earth_rect": 4096}
    for f in list(golden_report.GOLDENS.values()) + list(
            golden_report.GOLDENS_MULTITILE.values()):
        g = golden_report.load_golden(f)
        assert g.ndim == 3 and g.shape[2] == 3 and np.isfinite(g).all()


def test_golden_report_reaches_every_golden_on_the_oracle_texels(
        monkeypatch, capsys, tmp_path):
    """The JAX tool's spp table has no earth rows, so its loop stops with
    a KeyError at the fourth golden (R8); the port takes each golden's spp
    from its file name, renders the earth scenes on earth.rtwi, and
    writes the report only where --out names it."""
    loaded = []
    real = tscenes.image_mod.load_image
    monkeypatch.setattr(tscenes.image_mod, "load_image",
                        lambda p: loaded.append(p) or real(p))
    monkeypatch.chdir(tmp_path)
    rc = golden_report.main(CPU + ["--mode", "while", "--max-spp", "1",
                                   "--max-depth", "2"])
    rows = _rows(capsys)
    assert [r["scene"] for r in rows] == sorted(golden_report.GOLDENS)
    assert all(r["spp"] == 1 for r in rows)
    assert rc == (0 if all(r["passed"] for r in rows) else 1)
    assert loaded.count(RTWI) >= 2
    assert os.listdir(tmp_path) == []
    out = tmp_path / "report.md"
    golden_report.main(CPU + ["--mode", "while", "--max-spp", "1",
                              "--max-depth", "2", "--scenes", "earth",
                              "--out", str(out)])
    assert "| earth | 32x32 | 1 |" in out.read_text()


def test_golden_tools_refuse_unknown_scenes():
    with pytest.raises(SystemExit, match="choices"):
        golden_report.main(CPU + ["--scenes", "nope"])
    with pytest.raises(SystemExit, match="choices"):
        bench_all.main(CPU + ["--scenes", "random_balls,nope"])


def _dyn_ab(extra=()):
    return dyn_ab_check.main(CPU + ["--nx", "8", "--ny", "8", "--spp", "2",
                                    "--max-depth", "3", "--scenes",
                                    "random_balls_large", *extra])


def test_dyn_ab_check_passes_bitwise(capsys):
    assert _dyn_ab() == 0
    rows = _rows(capsys)
    assert [r["variant"] for r in rows] == ["ascending", "auto", "dord4"]
    assert all(r["bitwise_equal"] and r["n_diff"] == 0 and r["C"] == 29
               and r["cull"] for r in rows)
    assert [r["dyn_order"] for r in rows] == [0, 16, 4]


def test_dyn_ab_check_fails_a_perturbed_variant(monkeypatch, capsys):
    """The check checks: one ulp on one value of dord4's image fails it."""
    real = dyn_ab_check._launch

    def launch(scene, nx, ny, spp, max_depth, device, kw):
        img, segs = real(scene, nx, ny, spp, max_depth, device, kw)
        if kw.get("dyn_order") == 4:
            img = img.copy()
            img[3, 5, 1] = np.nextafter(img[3, 5, 1], np.float32(np.inf))
        return img, segs

    monkeypatch.setattr(dyn_ab_check, "_launch", launch)
    assert _dyn_ab() == 1
    out = capsys.readouterr().out
    assert "dense-vs-dord4: bitwise=DIFF" in out
    assert "n_diff=1/192" in out
    assert "dense-vs-auto: bitwise=EQUAL" in out


def test_dyn_ab_check_fails_a_refused_plan(monkeypatch, capsys):
    """A refused dense plan is a failed row, not a skipped scene."""
    real = mk.make_plan

    def make_plan(*a, **kw):
        if kw.get("cull") is False:
            raise ValueError("too many bytes of shared memory")
        return real(*a, **kw)

    monkeypatch.setattr(mk, "make_plan", make_plan)
    assert _dyn_ab() == 1
    rows = _rows(capsys)
    assert len(rows) == 3
    assert all("shared memory" in r["error"] for r in rows)


def _segments(name, **kw):
    res = mk.trace_mega(launch_seed(0, 0), tool_scene(name, 1.0), 16, 16, 2,
                        max_depth=3, device="cpu", **kw)
    return float(res.segments)


def _docs_state():
    docs = os.path.join(REPO, "docs")
    return sorted((f, os.path.getsize(os.path.join(docs, f)),
                   os.path.getmtime(os.path.join(docs, f)))
                  for f in os.listdir(docs))


BENCH_ALL_KEYS = {"scene", "nx", "ny", "spp", "launches",
                  "rays_per_s_median", "rays_per_s_min", "rays_per_s_max",
                  "rays_per_s_all"}
# tools/mega_perf.py's printed fields but --chunks and --idx
MEGA_PERF_KEYS = {"scene", "nx", "ny", "spp", "T", "SB", "segments",
                  "seconds", "m_seg_per_s", "util", "cull_survival", "C"}
# tools/cull_sweep.py's JSON keys but chunks, idx, eb and dyn
CULL_SWEEP_KEYS = {"scene", "nx", "ny", "spp", "SB", "cull", "T", "C",
                   "m_seg_per_s", "util", "cull_survival"}


def test_bench_all_rows(capsys, monkeypatch, tmp_path):
    before = _docs_state()
    monkeypatch.chdir(tmp_path)
    names = ["random_balls", "cornell_box", "earth", "random_balls_large"]
    assert bench_all.main(CPU + TINY + ["--scenes", ",".join(names)]) == 0
    rows = _rows(capsys)
    assert [r["scene"] for r in rows] == names
    for r in rows:
        assert set(r) == BENCH_ALL_KEYS | {"device", "segments_all"}
        assert r["device"] == "cpu (plain version)"
        assert (r["nx"], r["ny"], r["spp"], r["launches"]) == (16, 16, 2, 1)
        assert r["segments_all"] == [_segments(r["scene"])]
    assert os.listdir(tmp_path) == [] and _docs_state() == before
    out = tmp_path / "rows.jsonl"
    bench_all.main(CPU + TINY + ["--scenes", "cornell_box", "--out",
                                 str(out)])
    assert [json.loads(x)["scene"] for x in out.read_text().splitlines()] \
        == ["cornell_box"]


def test_bench_all_needs_the_whole_shape():
    with pytest.raises(SystemExit, match="together"):
        bench_all.main(CPU + ["--nx", "16"])


@pytest.mark.parametrize("scene, flags, kw", [
    ("cornell_box", [], {}),
    ("random_balls_large", ["--dord", "0", "--T", "64"],
     dict(dyn_order=0, T=64)),
    ("random_balls_large", ["--cull", "0", "--SB", "256"],
     dict(cull=False, SB=256))])
def test_mega_perf_row(capsys, monkeypatch, tmp_path, scene, flags, kw):
    monkeypatch.chdir(tmp_path)
    assert mega_perf.main(CPU + TINY + ["--scene", scene, "--stats"]
                          + flags) == 0
    (row,) = _rows(capsys)
    assert set(row) == MEGA_PERF_KEYS | {"max_depth", "launches", "cull",
                                         "dyn_order", "lane_survival",
                                         "device"}
    assert row["segments"] == _segments(scene, **kw)
    _, plan = mk.make_plan(tool_scene(scene, 1.0), 16, 16, 2, max_depth=3,
                           **kw)
    assert (row["T"], row["SB"], row["C"], row["cull"], row["dyn_order"]) \
        == (plan.T, plan.SB, plan.C, plan.cull, plan.dyn_order)
    assert 0 < row["lane_survival"] <= row["cull_survival"] <= 1
    assert os.listdir(tmp_path) == []
    mega_perf.main(CPU + TINY + ["--scene", scene] + flags)
    (row,) = _rows(capsys)
    assert "util" not in row and "cull_survival" not in row


def test_cull_sweep_rows(capsys, monkeypatch, tmp_path):
    monkeypatch.chdir(tmp_path)
    specs = ["128:64::0", "128:64::16", "256:32:1", ":64:0"]
    assert cull_sweep.main(CPU + TINY + ["--scene", "random_balls_large",
                                         "--configs", *specs]) == 0
    rows = _rows(capsys)
    assert [r["spec"] for r in rows] == specs
    assert os.listdir(tmp_path) == []
    for r, spec in zip(rows, specs):
        assert set(r) == CULL_SWEEP_KEYS | {
            "spec", "dyn_order", "lane_survival", "segments", "warm_s",
            "timed_s", "device"}
        kw = cull_sweep.parse_spec(spec)
        assert r["segments"] == _segments("random_balls_large", **kw)
        _, plan = mk.make_plan(tool_scene("random_balls_large", 1.0), 16, 16,
                               2, max_depth=3, **kw)
        assert (r["SB"], r["T"], r["C"], r["cull"], r["dyn_order"]) == (
            plan.SB, plan.T, plan.C, plan.cull, plan.dyn_order)
    assert [r["cull"] for r in rows] == [True, True, True, False]
    out = tmp_path / "sweep.jsonl"
    for _ in range(2):
        cull_sweep.main(CPU + TINY + ["--scene", "dielectric", "--configs",
                                      ":64", "--json", str(out)])
    assert len(out.read_text().splitlines()) == 2


@pytest.mark.parametrize("spec, want", [
    ("128", dict(SB=128, T=None, cull=None, dyn_order=None)),
    (":256", dict(SB=None, T=256, cull=None, dyn_order=None)),
    ("128:512::16", dict(SB=128, T=512, cull=None, dyn_order=16)),
    ("64:128:0", dict(SB=64, T=128, cull=False, dyn_order=None)),
    ("", dict(SB=None, T=None, cull=None, dyn_order=None))])
def test_cull_sweep_spec(spec, want):
    assert cull_sweep.parse_spec(spec) == want


@pytest.mark.parametrize("spec", ["512:1:1:2048:0", "64:8:1:4096:1:512",
                                  "512:1:1:2048:0:512:1", "a:1"])
def test_cull_sweep_refuses_tpu_specs(spec, capsys):
    with pytest.raises(SystemExit, match=r"SB\[:T\[:cull\[:dord\]\]\]"):
        cull_sweep.main(CPU + ["--configs", "128", spec])
    assert capsys.readouterr().out == ""      # refused before any launch


def test_cull_sweep_raises_on_a_refused_plan():
    """T = 48 is no whole number of warps: make_plan refuses the culled
    config and the sweep raises, not skips."""
    with pytest.raises(ValueError, match="multiple of 32"):
        cull_sweep.main(CPU + TINY + ["--scene", "random_balls_large",
                                      "--configs", "128:48:1"])


@pytest.mark.parametrize("tool", [bench_all, mega_perf, cull_sweep,
                                  dyn_ab_check, golden_report])
def test_tools_need_a_card_by_default(tool, monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        tool.main([])
