"""The plain reference against the program's plain version on the CPU,
and the benchmark's imports: nothing a run imports is JAX or the JAX
package, and the reference imports nothing of the program."""
import ast
import dataclasses
import json
import subprocess
import sys

import numpy as np
import pytest
import torch
from conftest import ROOT

from portbench import harness
from portbench.reference import render as rrender
from portbench.reference import scenes as rscenes

FORBIDDEN = {"jax", "jaxlib", "flax", "raytracingweekend_tpu"}
SPEC = json.loads((ROOT / "BENCHMARK.json").read_text())
CONFIGS = [json.loads((ROOT / c["file"]).read_text())
           for c in SPEC["configs"]]
# the configurations whose scene is a generator of the reference's
# scenes.py (a copy of the program's), not a scene file of their own
BUILT_IN = [c for c in CONFIGS if "scene_file" not in c]


def _scene(conf, aspect):
    """The scene of configuration `conf`, as a run of its cells builds
    it."""
    return harness.make_scene({"config": conf, "pkg": ROOT / "portbench"},
                              aspect)


def _assert_tables_equal(a, b, what):
    for tab in ("spheres", "rects", "media", "materials", "textures",
                "camera"):
        ta, tb = getattr(a, tab), getattr(b, tab)
        for f in dataclasses.fields(ta):
            x, y = getattr(ta, f.name), getattr(tb, f.name)
            if x is None or isinstance(x, (int, float)):
                assert x == y, (what, tab, f.name)
            else:
                assert np.array_equal(np.asarray(x), np.asarray(y)), \
                    (what, tab, f.name)


def _imports(path) -> set:
    """Top-level names of the modules a file imports (absolute imports
    only; relative ones stay inside the benchmark)."""
    tree = ast.parse(path.read_text())
    names = set()
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            names |= {a.name.split(".")[0] for a in node.names}
        elif isinstance(node, ast.ImportFrom) and not node.level:
            names.add(node.module.split(".")[0])
    return names


@pytest.mark.parametrize("path", sorted(
    p.relative_to(ROOT).as_posix()
    for p in (ROOT / "portbench").rglob("*.py")))
def test_no_file_imports_jax_or_the_jax_package(path):
    assert not _imports(ROOT / path) & FORBIDDEN


@pytest.mark.parametrize("path", sorted(
    p.relative_to(ROOT).as_posix()
    for p in (ROOT / "portbench/reference").rglob("*.py")))
def test_reference_imports_nothing_of_the_program(path):
    assert "raytracingweekend_tpu_torch" not in _imports(ROOT / path)


def test_a_run_holds_no_jax_module():
    code = ("import sys; sys.path.insert(0, '.');"
            "from conftest import tiny_cell;"
            "from portbench import harness;"
            "r = harness.run_cell(tiny_cell('cornell_box.converge'), 3, "
            "0.01, False, device='cpu', log=lambda *a: None);"
            "print(r['correct'], harness.forbidden_modules())")
    p = subprocess.run([sys.executable, "-c", code], capture_output=True,
                       text=True, cwd=ROOT / "portbench/tests", timeout=300,
                       env={"PYTHONPATH": str(ROOT), "PATH": "/usr/bin:/bin",
                            "HOME": "/nonexistent"})
    assert p.returncode == 0, p.stderr[-2000:]
    assert p.stdout.split()[-2:] == ["True", "[]"], p.stdout


@pytest.mark.parametrize("conf", BUILT_IN, ids=lambda c: c["name"])
def test_reference_scenes_equal_the_program_scenes(conf):
    from raytracingweekend_tpu_torch.models import scenes as pscenes
    args = conf.get("scene_args", {})
    _assert_tables_equal(_scene(conf, 1.5),
                         pscenes.make_scene(conf["scene"], 1.5, **args),
                         conf["name"])


@pytest.mark.parametrize("conf", BUILT_IN, ids=lambda c: c["name"])
def test_config_builds_the_built_in_generator_scene(conf):
    """A configuration without a scene file of its own builds, through
    the harness, the very tables of the reference's generator called
    directly, at its own aspect."""
    aspect = conf["nx"] / conf["ny"]
    _assert_tables_equal(_scene(conf, aspect),
                         rscenes.SCENES[conf["scene"]](aspect),
                         conf["name"])


@pytest.mark.parametrize("conf", CONFIGS, ids=lambda c: c["name"])
def test_reference_equals_the_program_plain_version(conf):
    """render() on the CPU (the kernels' plain versions) and the
    reference's render agree bit for bit at the configuration's
    `cpu_case`, launches of 4 and a last one of the rest included: on
    every tile, and on one tile of a second render traced in the same
    calls."""
    from portbench import adapter
    nx, ny, spp, depth = (conf["cpu_case"][k]
                          for k in ("nx", "ny", "spp", "max_depth"))
    scene = _scene(conf, nx / ny)
    cfg = adapter.render_config(nx, ny, spp, depth, 4, 77, device="cpu")
    img = adapter.render(scene, cfg)
    knobs = adapter.plan_knobs(scene, cfg)
    n_tiles = -(-nx * ny // knobs["T"])
    ref, part = rrender.render_tiles(
        scene, nx, ny, spp, depth, 4,
        [(77, torch.arange(n_tiles)), (78, torch.tensor([1]))], knobs, "cpu")
    assert torch.equal(img, ref)
    img78 = adapter.render(scene, dataclasses.replace(cfg, seed=78))
    pix = rrender.tile_pixels(scene, nx, ny, 4, torch.tensor([1]), knobs)
    flat = img78.reshape(-1, 3)
    assert torch.equal(flat[pix], part.reshape(-1, 3)[pix])
    assert part.reshape(-1, 3)[pix].abs().sum() > 0
    assert rrender.launch_seed(77, 2) == __import__(
        "raytracingweekend_tpu_torch.render", fromlist=["x"]).launch_seed(
            77, 2)


def test_tile_sample_covers_its_tiles_only():
    scene = rscenes.make_scene("random_balls", 1.5)
    tiles = torch.tensor([0, 3])
    pix = rrender.tile_pixels(scene, 48, 32, 4, tiles, {"T": 256})
    ref, = rrender.render_tiles(scene, 48, 32, 4, 3, 4, [(5, tiles)],
                                {"T": 256}, "cpu")
    lit = torch.nonzero(ref.reshape(-1, 3).abs().sum(1) > 0).flatten()
    assert set(lit.tolist()) <= set(pix.tolist())
    assert len(pix) == 2 * 256


def test_launches_split_the_samples():
    assert rrender.launches(500, 64) == [64] * 7 + [52]
    assert rrender.launches(64, 64) == [64]
    assert rrender.launches(3, 8) == [3]
