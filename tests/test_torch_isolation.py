"""The PyTorch/CUDA port stands alone: importing every one of its modules
(and chip_smoke.py) pulls in neither JAX nor the JAX package."""
import os
import pkgutil
import subprocess
import sys

import pytest

pytest.importorskip("torch")

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PKG = "raytracingweekend_tpu_torch"


def _port_modules():
    pkg_dir = os.path.join(REPO, PKG)
    mods = [PKG]
    for info in pkgutil.walk_packages([pkg_dir], prefix=PKG + "."):
        mods.append(info.name)
    return sorted(mods)


def test_port_module_list_is_complete():
    mods = _port_modules()
    for expected in ("grad", "models.builder", "models.convert",
                     "models.probe_scenes", "models.scenes",
                     "models.scene_types", "ops._build", "ops.bvh",
                     "ops.camera", "ops.geometry", "ops.integrator",
                     "ops.intersect", "ops.linalg", "ops.materials",
                     "ops.mega_grad", "ops.megakernel", "ops.noise", "ops.packing",
                     "ops.pdfs", "ops.rounding", "ops.sampling",
                     "ops.syncs", "ops.textures", "parallel",
                     "parallel.distributed", "parallel.dryrun",
                     "parallel.emulate", "parallel.mesh",
                     "parallel.scaling", "render", "tools",
                     "tools.bench_all", "tools.bvh_bench",
                     "tools.coherence_sweep", "tools.cull_sweep",
                     "tools.culled_ab", "tools.dot_microbench",
                     "tools.dyn_ab_check", "tools.export_texture_raw",
                     "tools.golden_report", "tools.grad_bench",
                     "tools.inverse_render_bench", "tools.mega_golden_check",
                     "tools.mega_perf", "tools.sampling_gallery",
                     "tools.scaling_report", "tools.sweep_twin",
                     "tools.mosaic_repros", "tools.mosaic_repros.__main__",
                     "tools.mosaic_repros._common",
                     "tools.mosaic_repros.repro_dot_k3_subslice",
                     "tools.mosaic_repros.repro_dynamic_cull",
                     "tools.mosaic_repros.repro_f32_iota",
                     "tools.mosaic_repros.repro_scalar_reduce",
                     "tools.mosaic_repros.repro_slice_broadcast_layout",
                     "tools.mosaic_repros.tile_32768",
                     "utils.config",
                     "utils.detrng", "utils.image", "utils.prng",
                     "wavefront_profile"):
        assert f"{PKG}.{expected}" in mods, mods


def test_port_imports_no_jax():
    code = (
        "import importlib, sys\n"
        f"mods = {_port_modules()!r} + ['chip_smoke']\n"
        "for m in mods:\n"
        "    importlib.import_module(m)\n"
        "bad = sorted(m for m in sys.modules\n"
        "             if m.split('.')[0] in ('jax', 'jaxlib', 'flax',\n"
        "                                    'raytracingweekend_tpu'))\n"
        "print(bad)\n"
        "sys.exit(1 if bad else 0)\n")
    env = dict(os.environ, PYTHONPATH=REPO)
    proc = subprocess.run([sys.executable, "-c", code], cwd=REPO, env=env,
                          capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stdout + proc.stderr
