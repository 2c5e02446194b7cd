"""The port's golden, closest-hit and gallery tools against the JAX
package on the same inputs, on the CPU at tiny shapes.

`while` is the loop mode in which the port's render() meets JAX's lane by
lane (tests/test_torch_wavefront.py): radiance to rtol 1e-3, atol 5e-5 on
>= 99.8% of pixels, held here (measured: 100% of pixels on dielectric
32x32x4 at depth 4 and on every sampling strategy at 8x8x2, depth 3). The
megakernel's launch seeds are JAX's draws exactly. The closest-hit paths
take the same numpy inputs: the BVH traversal against JAX's, and K7's
plain version against JAX's `_hit_spheres_xla`, which rounds otherwise
than the Pallas kernel K7 reproduces (ROADMAP R6), so neither pair is
bit-equal: the best index on >= 99.9% of rays, and t to rtol 1e-4 where
the index agrees on >= 99.9% of rays (bvh_bench's own gate, T_RTOL and
AGREE_MIN), max |dt| / t <= 1e-3 (measured at N = 4096, S = 64 and 600:
every index the same, max |dt| / t 2.6e-5 to 4.0e-5).
"""
import json

import numpy as np
import pytest

torch = pytest.importorskip("torch")
import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from raytracingweekend_tpu.models import scene_types as jst  # noqa: E402
from raytracingweekend_tpu.models.scenes import make_scene as jscene  # noqa: E402
from raytracingweekend_tpu.ops import bvh as jbvh  # noqa: E402
from raytracingweekend_tpu.ops import geometry as jgeometry  # noqa: E402
from raytracingweekend_tpu.render import render as jrender  # noqa: E402
from raytracingweekend_tpu.utils.config import RenderConfig as JConfig  # noqa: E402
from raytracingweekend_tpu_torch.ops import megakernel as mk  # noqa: E402
from raytracingweekend_tpu_torch.tools import (  # noqa: E402
    bvh_bench, golden_report, mega_golden_check, sampling_gallery,
    tool_scene)

torch.set_num_threads(2)

RTOL, ATOL, MIN_SAME = 1e-3, 5e-5, 0.998
CPU = ["--device", "cpu"]


def _same(ours, ref):
    return np.isclose(ours, ref, rtol=RTOL, atol=ATOL).all(axis=-1).mean()


def _capture(monkeypatch, module):
    """Every canvas `module.render` returns, in order."""
    out = []
    real = module.render

    def render(scene, cfg):
        canvas = real(scene, cfg)
        out.append(canvas.cpu().numpy())
        return canvas

    monkeypatch.setattr(module, "render", render)
    return out


def test_golden_report_while_matches_jax_render(monkeypatch, capsys):
    canvases = _capture(monkeypatch, golden_report)
    golden_report.main(CPU + ["--mode", "while", "--max-spp", "4",
                              "--max-depth", "4", "--scenes", "dielectric"])
    row = json.loads(capsys.readouterr().out.splitlines()[-1])
    (ours,) = canvases
    ref = np.asarray(jrender(jscene("dielectric", 1.0), JConfig(
        nx=32, ny=32, spp=4, max_depth=4, samples_per_launch=4, seed=7,
        loop_mode="while")))
    assert _same(ours, ref) >= MIN_SAME
    g = golden_report.load_golden(golden_report.GOLDENS["dielectric"])
    jrow = golden_report.gate(ref, g, 4)
    assert row["spp"] == 4
    assert row["frac_ok"] == pytest.approx(jrow["frac_ok"], abs=1.0 / g.size)
    assert row["mean_rel"] == pytest.approx(jrow["mean_rel"],
                                            abs=RTOL * float(g.mean()))


def test_mega_golden_check_seeds_are_jax_draws():
    seeds = mega_golden_check.launch_seeds(1300, 512)
    assert [s for _, s in seeds] == [512, 512, 276]
    for (seed, _), done in zip(seeds, (0, 512, 1024)):
        k = jax.random.fold_in(jax.random.key(7), done)
        want = jax.random.randint(k, (1, 1), 0, np.int32(2 ** 31 - 1),
                                  dtype=jnp.int32)
        assert seed == int(np.asarray(want)[0, 0])


def test_mega_golden_check_image_is_trace_mega_on_those_seeds():
    scene = tool_scene("dielectric", 1.0)
    ours = mega_golden_check.render_mega(scene, 8, 8, 3, 2, max_depth=3,
                                         device="cpu")
    acc = np.zeros((8, 8, 3), np.float64)
    for seed, step in mega_golden_check.launch_seeds(3, 2):
        acc += mk.trace_mega(seed, scene, 8, 8, step, max_depth=3,
                             device="cpu").image.double().numpy()
    assert np.array_equal(ours, acc / 3)


def _jax_spheres(s):
    return jst.Spheres(center0=jnp.asarray(s.center0),
                       center1=jnp.asarray(s.center1),
                       time0=jnp.asarray(s.time0), time1=jnp.asarray(s.time1),
                       radius=jnp.asarray(s.radius), mat=jnp.asarray(s.mat),
                       active=jnp.asarray(s.active))


def test_bvh_bench_inputs_are_the_jax_tools():
    o, _, _ = bvh_bench.rays(64, "cpu")
    ko, _, ks = jax.random.split(jax.random.key(0), 3)
    want = jax.random.uniform(ko, (64, 3), jnp.float32, -20.0, 20.0)
    assert np.array_equal(o.numpy(), np.asarray(want))
    s = bvh_bench.spheres_of(600)
    kc, kr = jax.random.split(jax.random.fold_in(ks, 600))
    assert np.array_equal(s.center0, np.asarray(jax.random.uniform(
        kc, (600, 3), jnp.float32, -20.0, 20.0)))
    assert np.array_equal(s.radius, np.asarray(jax.random.uniform(
        kr, (600,), jnp.float32, 0.2, 1.0)))


@pytest.mark.parametrize("S", [64, 600])
def test_bvh_bench_paths_match_jax(S):
    n = 4096
    spheres = bvh_bench.spheres_of(S)
    paths = bvh_bench.paths(spheres, n, "cpu")
    o, d, tm = (jnp.asarray(x.numpy()) for x in bvh_bench.rays(n, "cpu"))
    js = _jax_spheres(spheres)
    jtree = jbvh.build_sphere_bvh(js)
    jax_bvh = jbvh.hit_spheres_bvh(o, d, tm, bvh_bench.T_MIN, js, jtree,
                                   False)
    # one block over all S (the scan form wants S % 256 == 0)
    jax_brute = jgeometry._hit_spheres_xla(o, d, tm, bvh_bench.T_MIN, js,
                                           False, block=1024)
    for label, ref in (("bvh-skiplink", jax_bvh), ("plain-brute", jax_brute)):
        ours = paths[label]()
        t, i = (torch.from_numpy(np.array(x)) for x in ref)
        a = bvh_bench.agreement(ours, (t, i.to(torch.int64)))
        assert a["same_index"] >= 0.999, (label, a)
        assert a["agree"] >= bvh_bench.AGREE_MIN, (label, a)
        assert a["max_rel_dt"] <= 1e-3, (label, a)
    # and the port's own gate between its paths
    k7, bvh = paths["k7"](), paths["bvh-skiplink"]()
    assert bvh_bench.agreement(bvh, k7)["agree"] >= bvh_bench.AGREE_MIN


def test_sampling_gallery_matches_jax_render(monkeypatch, capsys, tmp_path):
    canvases = _capture(monkeypatch, sampling_gallery)
    assert sampling_gallery.main(CPU + [
        "--out", str(tmp_path), "--nx", "8", "--spp", "2", "--max-depth",
        "3", "--mode", "while"]) == 0
    rows = [json.loads(x) for x in capsys.readouterr().out.splitlines()
            if x.startswith("{")]
    assert [r["strategy"] for r in rows] == list(sampling_gallery.STRATEGIES)
    assert sorted(p.name for p in tmp_path.iterdir()) == [
        f"sampling_{i}_{s}.png"
        for i, s in enumerate(sampling_gallery.STRATEGIES)]
    for strategy, ours in zip(sampling_gallery.STRATEGIES, canvases):
        scene = jscene("cornell_box", 1.0).replace(
            lambertian_strategy=strategy)
        ref = np.asarray(jrender(scene, JConfig(
            nx=8, ny=8, spp=2, max_depth=3, samples_per_launch=2, seed=5,
            loop_mode="while")))
        assert _same(ours, ref) >= MIN_SAME, strategy


def test_sampling_gallery_needs_out():
    with pytest.raises(SystemExit):
        sampling_gallery.main(CPU)

