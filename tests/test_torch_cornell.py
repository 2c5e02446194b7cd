"""The port's Cornell path (rects, lights with one-sample MIS, emission and
constant media) against the reference, statistically.

- render() in overdraw mode on the CPU passes the blockwise golden gate of
  tests/test_golden.py against the oracle's 8192 spp renders.
- Overdraw launches agree with the JAX kernel's in mean radiance within 4
  standard deviations of the launch mean, the deviation measured over
  launches of the port with other seeds (the glass ball's caustics give
  cornell_box a heavy-tailed estimate: its launch mean at 16x16, 8 spp
  spreads by ~9%, hence 24x24 at 16 spp there), and in lane utilisation.
"""
import os
import re

import numpy as np
import pytest

torch = pytest.importorskip("torch")
import jax  # noqa: E402

from raytracingweekend_tpu.models import scenes as jscenes  # noqa: E402
from raytracingweekend_tpu.ops import megakernel as mk  # noqa: E402
from raytracingweekend_tpu_torch import render as trender  # noqa: E402
from raytracingweekend_tpu_torch.models.scenes import make_scene  # noqa: E402
from raytracingweekend_tpu_torch.ops import megakernel as tk  # noqa: E402
from raytracingweekend_tpu_torch.utils.config import RenderConfig  # noqa: E402

# two intra-op threads per xdist worker (see test_torch_megakernel.py)
torch.set_num_threads(2)

GOLDEN_DIR = os.path.join(os.path.dirname(__file__), "goldens")


def _load_golden(name):
    with open(os.path.join(GOLDEN_DIR, name), "rb") as f:
        m = re.match(r"RTWO (\d+) (\d+)", f.readline().decode())
        nx, ny = int(m.group(1)), int(m.group(2))
        data = np.frombuffer(f.read(), dtype="<f8")
    return data.reshape(ny, nx, 3)


@pytest.mark.parametrize("name", ["cornell_box", "cornell_smoke"])
def test_cornell_render_golden_blockwise(name):
    """The blockwise gate of tests/test_golden.py through the port's
    render() (overdraw mode, two launches of 64 + 32 samples)."""
    g = _load_golden(f"{name}_32x32_8192spp.bin")
    cfg = RenderConfig(nx=32, ny=32, spp=96, max_depth=50,
                       samples_per_launch=64, seed=7, device="cpu")
    stats = trender.RenderStats()
    ours = trender.render(make_scene(name, 1.0), cfg, stats=stats)
    assert ours.shape == (32, 32, 3) and ours.device.type == "cpu"
    ours = ours.numpy().astype(np.float64)

    def blk(a):
        return a.reshape(8, 4, 8, 4, 3).mean(axis=(1, 3))

    gb, ob = blk(g), blk(ours)
    err = np.abs(ob - gb)
    tol = 0.03 + 4.0 * np.sqrt(np.maximum(gb, 0.0) / (16 * 96))
    assert (err <= tol).all(), (
        f"{(err > tol).sum()} blocks out of tolerance; "
        f"worst ratio {(err / tol).max():.2f}")
    assert stats.spp_done == 96 and stats.segments >= 32 * 32 * 96


@pytest.mark.parametrize("name,size,spp", [("cornell_box", 24, 16),
                                           ("cornell_smoke", 16, 8)])
def test_cornell_overdraw_matches_jax_statistically(name, size, spp):
    depth = 8
    js, ts = jscenes.make_scene(name, 1.0), make_scene(name, 1.0)
    T = mk.make_plan(js, size, size, spp, max_depth=depth, T=256)[2]
    img_j, segs_j, iters_j, _ = mk.trace_mega(
        jax.random.key(11), js, size, size, spp, max_depth=depth, T=256,
        interpret=True, return_stats=True)
    mean_j = float(np.asarray(img_j).mean()) / spp
    runs = [tk.trace_mega(seed, ts, size, size, spp, max_depth=depth, T=T,
                          device="cpu") for seed in range(2024, 2030)]
    means = np.array([float(r.image.mean()) / spp for r in runs])
    sigma = means.std(ddof=1)
    tol = 4.0 * sigma * np.sqrt(1.0 + 1.0 / len(means))
    assert abs(means.mean() - mean_j) <= tol, (means.mean(), mean_j, tol)
    util_j = float(segs_j) / float(iters_j)
    util_t = float(runs[0].segments) / float(runs[0].lane_iters)
    assert abs(util_t - util_j) <= 0.10 * util_j, (util_t, util_j)
    # overdraw: every valid lane traces at least spp samples
    assert all(float(r.segments) >= size * size * spp for r in runs)
