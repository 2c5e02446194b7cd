"""The port's path-regenerative wavefront (render(loop_mode="regen"), the
JAX package's default integrator) against the reference oracle's goldens,
with tests/test_golden.py's criteria: the scene mean at 16x16x48, depth 20,
within 5%, and 8x8 blocks of 4x4-pixel means at 32x32x96, depth 50, within
0.03 + 4 sqrt(g / (16 * 96)). The earth golden renders on the oracle's own
texels (tools/reference_oracle/earth.rtwi). random_balls takes the mean
test only: its 512-sphere closest hit is the slow part of the plain
version on the CPU."""
import os
import re

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from raytracingweekend_tpu_torch.models.scenes import make_scene  # noqa: E402
from raytracingweekend_tpu_torch.render import RenderStats, render  # noqa: E402
from raytracingweekend_tpu_torch.utils.config import RenderConfig  # noqa: E402

torch.set_num_threads(2)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
GOLDEN_DIR = os.path.join(REPO, "tests", "goldens")
RTWI = os.path.join(REPO, "tools", "reference_oracle", "earth.rtwi")
GOLDENS = {"dielectric": "dielectric_32x32_4096spp.bin",
           "light_sample": "light_sample_32x32_4096spp.bin",
           "cornell_box": "cornell_box_32x32_8192spp.bin",
           "cornell_smoke": "cornell_smoke_32x32_8192spp.bin",
           "earth": "earth_32x32_4096spp.bin",
           "random_balls": "random_balls_32x32_2048spp.bin"}


def _golden(name):
    with open(os.path.join(GOLDEN_DIR, GOLDENS[name]), "rb") as f:
        m = re.match(r"RTWO (\d+) (\d+)", f.readline().decode())
        nx, ny = int(m.group(1)), int(m.group(2))
        return np.frombuffer(f.read(), dtype="<f8").reshape(ny, nx, 3)


def _render(name, n, spp, depth, stats=None):
    kw = {"image_path": RTWI} if name == "earth" else {}
    cfg = RenderConfig(nx=n, ny=n, spp=spp, max_depth=depth,
                       samples_per_launch=min(spp, 64), seed=7,
                       loop_mode="regen", device="cpu")
    return render(make_scene(name, 1.0, **kw), cfg, stats=stats)


@pytest.mark.parametrize("name", sorted(GOLDENS))
def test_regen_golden_mean_radiance(name):
    g = float(_golden(name).mean())
    o = float(_render(name, 16, 48, 20).mean())
    assert abs(o - g) / max(g, 1e-6) < 0.05, (o, g)


@pytest.mark.parametrize("name", sorted(set(GOLDENS) - {"random_balls"}))
def test_regen_golden_blockwise(name):
    golden = _golden(name)
    stats = RenderStats()
    ours = _render(name, 32, 96, 50, stats)
    assert ours.shape == (32, 32, 3) and ours.device.type == "cpu"
    ours = ours.double().numpy()

    def blk(a):
        return a.reshape(8, 4, 8, 4, 3).mean(axis=(1, 3))

    gb, ob = blk(golden), blk(ours)
    err = np.abs(ob - gb)
    tol = 0.03 + 4.0 * np.sqrt(np.maximum(gb, 0.0) / (16 * 96))
    assert (err <= tol).all(), (
        f"{(err > tol).sum()} blocks out of tolerance; "
        f"worst ratio {(err / tol).max():.2f}")
    assert stats.spp_done == 96 and stats.segments >= 32 * 32 * 96
    assert stats.iterations > 0
