"""A configuration that brings its own scene: a scene file under the
benchmark's `reference/`, named by the configuration with its keyword
arguments, found and run by the harness with no file of the benchmark
edited; and a scene file that imports the program or JAX, refused before
it runs."""
import json

import pytest
from conftest import ROOT

from portbench import harness

SCENE = '''"""Three spheres on a ground sphere under one rect light."""
from . import scene_types as st
from .builder import SceneBuilder


def make_scene(aspect, radius=0.5):
    b = SceneBuilder()
    b.sphere((0, -100.5, -1), 100.0, b.lambertian(b.constant((0.5, 0.5,
                                                               0.5))))
    b.sphere((0, 0, -1), radius, b.lambertian(b.constant((0.7, 0.3, 0.3))))
    b.sphere((-1.1, 0, -1), radius, b.metal((0.8, 0.8, 0.8), 0.1))
    b.sphere((1.1, 0, -1), radius, b.dielectric(1.5))
    b.add_light(b.rect("xz", -1.0, 1.0, -2.0, 0.0, 2.0,
                       b.diffuse_light((4.0, 4.0, 4.0))))
    b.camera((0, 0.5, 2), (0, 0, -1), (0, 1, 0), 40.0, aspect, 0.0, 3.0,
             0.0, 1.0)
    return b.build(background=st.BG_GRADIENT, name="lit_trio")
'''


def _snapshot(folder):
    return {p: p.read_bytes() for p in folder.rglob("*")
            if p.is_file() and "__pycache__" not in p.parts}


def _root(tmp, source, scene_file="portbench/reference/lit_trio.py"):
    """A checkout of a benchmark that holds one configuration with a
    scene of its own, one mix and one cell, made of new files alone."""
    pkg = tmp / "portbench"
    for sub in ("reference", "configs", "traffic"):
        (pkg / sub).mkdir(parents=True)
    (pkg / "reference/lit_trio.py").write_text(source)
    (pkg / "configs/lit_trio.json").write_text(json.dumps(
        {"name": "lit_trio", "scene": "lit_trio", "scene_file": scene_file,
         "scene_args": {"radius": 0.4}, "nx": 24, "ny": 16, "spp": 6,
         "max_depth": 5, "precision": "float32", "reduced": [],
         "check": {"images": 1, "tiles": 2,
                   "limits": {"mismatch_share": 0.02}},
         "cpu_case": {"nx": 24, "ny": 16, "spp": 6, "max_depth": 5}}))
    (pkg / "traffic/short.json").write_text(json.dumps(
        {"samples_per_launch": 4, "warmup_images": 1}))
    (tmp / "BENCHMARK.json").write_text(json.dumps({
        "command": ["python3", "-m", "portbench.run"],
        "paths": ["portbench"], "run_seconds": 10,
        "configs": [{"name": "lit_trio", "source": "test",
                     "file": "portbench/configs/lit_trio.json",
                     "reduced": [], "why": "test"}],
        "workloads": [{"name": "lit_trio.short", "config": "lit_trio",
                       "traffic": "short", "chips": 1, "why": "test"}],
        "end_to_end": [
            {"name": "image_p95_ms", "unit": "ms", "better": "lower",
             "bound": 0.15, "source": "host_clock"},
            {"name": "setup_s", "unit": "s", "better": "lower",
             "bound": 0.25, "source": "host_clock"}],
        "per_layer": []}))
    return harness.find_cell(harness.load_spec(tmp), "lit_trio.short", tmp)


def test_config_with_its_own_scene_file_runs_correct(tmp_path):
    before = _snapshot(ROOT / "portbench")
    cell = _root(tmp_path, SCENE)
    scene = harness.make_scene(cell, 1.5)
    assert scene.name == "lit_trio"
    radii = scene.spheres.radius[scene.spheres.active]
    assert sorted(radii.tolist()) == pytest.approx([0.4, 0.4, 0.4, 100.0])
    assert int(scene.rects.active.sum()) == 1 and scene.lights.num == 1
    res = harness.run_cell(cell, 2 ** 31 + 55, 0.01, False, device="cpu",
                           log=lambda *a: None)
    assert res["correct"]
    assert res["checks"]["mismatch_share"]["value"] == 0.0
    assert set(res["metrics"]) == {"image_p95_ms", "setup_s"}
    assert _snapshot(ROOT / "portbench") == before


@pytest.mark.parametrize("line", [
    "import raytracingweekend_tpu_torch",
    "from raytracingweekend_tpu_torch.models import scenes",
    "import jax.numpy as jnp",
    "from jax import numpy",
    "from raytracingweekend_tpu.models import builder",
    "from . import megakernel",
    "from .. import adapter",
    "import os"])
def test_scene_file_importing_what_it_may_not_is_refused(tmp_path, line):
    marker = tmp_path / "ran"
    source = SCENE.replace(
        "from .builder import SceneBuilder\n",
        f"from .builder import SceneBuilder\n{line}\n"
        f"open({str(marker)!r}, 'w').close()\n")
    cell = _root(tmp_path, source)
    with pytest.raises(harness.BenchError, match="may not"):
        harness.run_cell(cell, 3, 0.01, False, device="cpu",
                         log=lambda *a: None)
    assert not marker.exists()


@pytest.mark.parametrize("scene_file", [
    "portbench/configs/lit_trio.py", "portbench/reference/absent.py",
    "portbench/reference/../../lit_trio.py"])
def test_scene_file_outside_the_reference_is_refused(tmp_path, scene_file):
    cell = _root(tmp_path, SCENE, scene_file=scene_file)
    (tmp_path / "portbench/configs/lit_trio.py").write_text(SCENE)
    (tmp_path / "lit_trio.py").write_text(SCENE)
    with pytest.raises(harness.BenchError, match="no Python file"):
        harness.make_scene(cell, 1.5)


def test_scene_imports_of_the_reference_are_allowed(tmp_path):
    path = tmp_path / "s.py"
    path.write_text("from __future__ import annotations\nimport math\n"
                    "import numpy as np\nfrom pathlib import Path\n"
                    "from . import builder, detrng, scene_types\n"
                    "from portbench.reference import builder as b2\n"
                    "import portbench.reference.detrng\n")
    assert harness.scene_imports_refused(path) == []
