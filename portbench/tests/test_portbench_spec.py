"""BENCHMARK.json against the benchmark's contract, and every cell,
configuration, traffic mix and metric reader found by name."""
import json
import re
import shutil

import pytest
from conftest import ROOT

from portbench import harness

SPEC = json.loads((ROOT / "BENCHMARK.json").read_text())
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")


def test_top_level_keys_and_paths():
    assert set(SPEC) == {"command", "paths", "run_seconds", "configs",
                         "workloads", "end_to_end", "per_layer"}
    assert SPEC["paths"] == ["portbench"]
    assert 1 <= SPEC["run_seconds"] <= 51
    assert all(not w.startswith("/") and ".." not in w
               for w in SPEC["command"])


@pytest.mark.parametrize("kind", ["configs", "workloads", "end_to_end",
                                  "per_layer"])
def test_names_units_and_keys(kind):
    names = [e["name"] for e in SPEC[kind]]
    assert len(names) == len(set(names))
    for e in SPEC[kind]:
        assert NAME.match(e["name"]), e["name"]
        if "unit" in e:
            assert UNIT.match(e["unit"]), e["unit"]
            assert e["better"] in ("lower", "higher")
    keys = {"configs": {"name", "source", "file", "reduced", "why"},
            "workloads": {"name", "config", "traffic", "chips", "why"},
            "end_to_end": {"name", "unit", "better", "bound", "source"},
            "per_layer": {"name", "unit", "better", "source", "layer",
                          "moves"}}[kind]
    for e in SPEC[kind]:
        assert set(e) - {"workloads"} == keys, e


def test_bounds_and_metric_sources():
    for m in SPEC["end_to_end"]:
        assert 0.01 <= m["bound"] <= 0.25
        assert m["source"] in ("host_clock", "device_trace")
    assert "setup_s" in {m["name"] for m in SPEC["end_to_end"]}
    e2e = {m["name"] for m in SPEC["end_to_end"]}
    for m in SPEC["per_layer"]:
        assert m["moves"] in e2e
        assert m["source"] in ("device_trace", "program_span",
                               "program_counter", "host_clock")
        if m["name"].endswith("_roofline"):
            assert m["unit"] == "%"
        moved = next(e for e in SPEC["end_to_end"] if e["name"] == m["moves"])
        for cell in m["workloads"]:
            assert cell in moved.get("workloads", [cell]), (m["name"], cell)


@pytest.mark.parametrize("cell", [w["name"] for w in SPEC["workloads"]])
def test_cell_found_by_name(cell):
    found = harness.find_cell(SPEC, cell, ROOT)
    conf = found["config"]
    assert conf["name"] == found["workload"]["config"]
    for key in ("scene", "nx", "ny", "spp", "max_depth", "check",
                "cpu_case"):
        assert key in conf
    assert found["traffic"]["samples_per_launch"] > 0
    names = {m["name"] for m in found["end_to_end"]}
    assert "setup_s" in names and len(names) >= 2
    assert found["per_layer"]
    for m in found["per_layer"]:
        assert callable(harness.metric_reader(m["name"], found["pkg"]))
        assert m["moves"] in names


def test_every_config_is_used_and_lies_under_paths():
    used = {w["config"] for w in SPEC["workloads"]}
    for c in SPEC["configs"]:
        assert c["name"] in used
        assert c["file"].startswith("portbench/")
        assert json.loads((ROOT / c["file"]).read_text())["name"] == \
            c["name"]


@pytest.mark.parametrize("entry", SPEC["configs"],
                         ids=lambda c: c["name"])
def test_every_config_scene_resolves_and_brings_its_cpu_case(entry):
    """A configuration's scene resolves as its cells build it: a
    generator of the reference's scenes.py, or a scene file of its own
    under portbench/reference/ that imports only what a scene of the
    reference may; its `cpu_case` sizes the reference's CPU test."""
    cell = next(w["name"] for w in SPEC["workloads"]
                if w["config"] == entry["name"])
    found = harness.find_cell(SPEC, cell, ROOT)
    assert harness.make_scene(found, 1.5).spheres.radius.size > 0
    case = found["config"]["cpu_case"]
    assert set(case) == {"nx", "ny", "spp", "max_depth"}
    assert all(isinstance(v, int) and v > 0 for v in case.values())


# the keys of a traffic mix that run_cell reads, and "why"
MIX_KEYS = {"spp", "samples_per_launch", "warmup_images", "warmup_seconds",
            "why"}


@pytest.mark.parametrize("mix", sorted({w["traffic"]
                                        for w in SPEC["workloads"]}))
def test_traffic_mix_has_the_keys_run_cell_reads(mix):
    data = json.loads((ROOT / "portbench/traffic" / f"{mix}.json")
                      .read_text())
    assert set(data) <= MIX_KEYS, set(data) - MIX_KEYS
    assert isinstance(data["samples_per_launch"], int)
    assert data["samples_per_launch"] > 0
    assert isinstance(data.get("spp", 1), int) and data.get("spp", 1) > 0
    assert data.get("warmup_images", 1) >= 1
    assert data.get("warmup_seconds", 0.0) >= 0.0


def test_preview_is_one_launch_of_4_spp_an_image():
    data = json.loads((ROOT / "portbench/traffic/preview.json")
                      .read_text())
    assert data["spp"] == data["samples_per_launch"] == 4


def test_new_config_mix_and_metric_are_files_and_entries(tmp_path):
    """A configuration, a traffic mix and a per-layer metric added as new
    files and new entries in a copy of the benchmark run with no
    existing file of the folder edited."""
    shutil.copytree(ROOT / "portbench", tmp_path / "portbench",
                    ignore=shutil.ignore_patterns("__pycache__"))
    before = {p: p.read_bytes()
              for p in (tmp_path / "portbench").rglob("*") if p.is_file()}
    (tmp_path / "portbench/configs/tiny_balls.json").write_text(json.dumps(
        {"name": "tiny_balls", "scene": "random_balls", "nx": 16,
         "ny": 12, "spp": 3, "max_depth": 4, "reduced": [],
         "check": {"images": 1, "tiles": 1,
                   "limits": {"mismatch_share": 0.01}}}))
    (tmp_path / "portbench/traffic/short.json").write_text(json.dumps(
        {"samples_per_launch": 2, "warmup_images": 1}))
    (tmp_path / "portbench/metrics/images_seen.py").write_text(
        "def read(ctx):\n    return float(ctx['images'])\n")
    spec = json.loads(json.dumps(SPEC))
    spec["configs"].append({"name": "tiny_balls", "source": "x",
                            "file": "portbench/configs/tiny_balls.json",
                            "reduced": [], "why": "test"})
    spec["workloads"].append({"name": "tiny_balls.short",
                              "config": "tiny_balls", "traffic": "short",
                              "chips": 1, "why": "test"})
    for m in spec["end_to_end"]:
        if m["name"] == "pixel_samples_per_s":
            m["workloads"].append("tiny_balls.short")
    spec["per_layer"].append({"name": "images_seen", "unit": "images",
                              "better": "higher", "source": "host_clock",
                              "layer": "render loop", "moves": "setup_s",
                              "workloads": ["tiny_balls.short"]})
    (tmp_path / "BENCHMARK.json").write_text(json.dumps(spec))
    cell = harness.find_cell(harness.load_spec(tmp_path),
                             "tiny_balls.short", tmp_path)
    assert [m["name"] for m in cell["per_layer"]] == ["images_seen"]
    res = harness.run_cell(cell, 7, 0.01, True, device="cpu",
                           log=lambda *a: None)
    assert res["correct"] and res["metrics"]["images_seen"]["value"] >= 1
    untraced = harness.run_cell(cell, 8, 0.01, False, device="cpu",
                                log=lambda *a: None)
    assert set(untraced["metrics"]) == {"pixel_samples_per_s", "setup_s"}
    for p, data in before.items():
        assert p.read_bytes() == data, p
