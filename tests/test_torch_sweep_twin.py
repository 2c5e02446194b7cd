"""The sweep twin's plain version (kernel K8) against the JAX tool.

K8 (raytracingweekend_tpu_torch/tools/sweep_twin.py, csrc/sweep_twin.cu)
replaces tools/sweep_twin.py's Pallas kernel. Its plain version runs here
on the CPU and is held

- to the JAX tool itself, run in interpret mode in a subprocess (K = 4,
  G = 1, the JAX package's book-1 plan: S = 512, T = 4096), fed the same
  tables: iterations exactly, the checksum to rtol 1e-5 (a float32 sum of
  8192 values ~10; the two versions' rsqrt can differ by an ulp, N3);
- to `raytracingweekend_tpu.ops.geometry.hit_spheres` (its XLA path) on
  the twin's first rays: hit or miss on every lane; t to rtol 1e-4 on
  >= 99.9% of hitting lanes and to 1e-3 on all (the two formulations
  round differently, R6; the r = 1000 ground sphere's root is fragile in
  float32, N2; and a grazing hit, disc near 0, amplifies a rounding
  difference through the square root: 1.4e-4 on one lane of 4096); the
  winner's scene row on >= 99.9% of hitting lanes;
- and `ext`'s attribute rows to a numpy gather at the argmin slot, where
  no lane has a tie.
"""
import json
import os
import subprocess
import sys

import numpy as np
import pytest

torch = pytest.importorskip("torch")
import jax.numpy as jnp  # noqa: E402

from raytracingweekend_tpu.models import scenes as jscenes  # noqa: E402
from raytracingweekend_tpu.ops import geometry as jgeo  # noqa: E402
from raytracingweekend_tpu.ops import megakernel as jmk  # noqa: E402
from raytracingweekend_tpu_torch.models.scenes import make_scene  # noqa: E402
from raytracingweekend_tpu_torch.ops import megakernel as tmk  # noqa: E402
from raytracingweekend_tpu_torch.tools import sweep_twin as tw  # noqa: E402

torch.set_num_threads(2)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CHECKSUM_RTOL = 1e-5
T_RTOL = 1e-4
T_RTOL_ALL = 1e-3
MIN_SAME = 0.999
ROW_KEYS = {"variant", "S", "EE", "T", "iters", "grid", "G", "K", "ms",
            "us_per_iter", "implied_ceiling_seg_per_s", "iters_done",
            "checksum", "device"}

# Runs the JAX tool as `python tools/sweep_twin.py --interpret`, with its
# persistent compilation cache moved from the repository's .jax_cache into
# a directory of the test's own.
_RUN_TOOL = """
import runpy, sys
import jax
_update = jax.config.update
def update(name, value):
    if name == "jax_compilation_cache_dir":
        value = sys.argv[1]
    _update(name, value)
jax.config.update = update
sys.argv = ["tools/sweep_twin.py", "--interpret"]
runpy.run_path("tools/sweep_twin.py", run_name="__main__")
"""


@pytest.fixture(scope="module")
def jax_tool_rows(tmp_path_factory):
    """The JAX tool's rows (quad, ext) in interpret mode: K = 4, G = 1."""
    cache = tmp_path_factory.mktemp("jax_cache")
    env = dict(os.environ, JAX_PLATFORMS="cpu", PYTHONPATH=REPO)
    proc = subprocess.run([sys.executable, "-c", _RUN_TOOL, str(cache)],
                          cwd=REPO, env=env, capture_output=True, text=True,
                          timeout=600)
    assert proc.returncode == 0, proc.stdout + proc.stderr
    rows = [json.loads(line) for line in proc.stdout.splitlines()
            if line.startswith("{")]
    return {r["variant"]: r for r in rows}


@pytest.fixture(scope="module")
def jax_plan():
    """The JAX package's book-1 plan as the port's twin reads it: (soa
    (9, S), attr (24, S), T, ut_t0, ut_idt)."""
    scene = jscenes.make_scene("random_balls", 1.5)
    tabs, cfg, T, _ = jmk.make_plan(scene, 1200, 800, 64, max_depth=50)
    sph, attr = np.asarray(tabs[0]), np.asarray(tabs[1])
    assert [getattr(jmk, f"C_{n}") for n in ("CX", "CY", "CZ", "DCX", "DCY",
                                              "DCZ", "T0", "IDT", "NR2")] \
        == list(tmk.SWEEP_LANES)
    soa = np.ascontiguousarray(sph[:, list(tmk.SWEEP_LANES)].T)
    return (torch.from_numpy(soa), torch.from_numpy(np.array(attr)), T,
            cfg.ut_t0, cfg.ut_idt)


@pytest.fixture(scope="module")
def port_plan():
    """The port's book-1 plan (S = 488, T = 256) and its slot order."""
    tabs, plan = tmk.make_plan(make_scene("random_balls", 1.5), 1200,
                               800, 64, max_depth=50)
    soa, attr, plan2 = tw.book1_inputs("cpu")
    assert plan2 == plan
    return soa, attr, plan, tabs[-1]["slot_ext"]


@pytest.mark.parametrize("variant", ["quad", "ext"])
def test_plain_twin_matches_jax_tool(variant, jax_tool_rows, jax_plan):
    """Same tables, K, G and T as the JAX tool in interpret mode: the
    same iteration count, the same checksum of (ox, iterations)."""
    row = jax_tool_rows[variant]
    soa, attr, T, t0, idt = jax_plan
    assert (row["S"], row["T"], row["iters"], row["grid"]) == (
        soa.shape[1], T, 4, 1)
    out, attrs = tw.sweep_twin_reference(soa, attr, T, 1, 4, t0, idt,
                                         variant == "ext")
    assert float(out[0, 1, 0]) == row["iters_done"] == 4.0
    assert torch.all(out[:, 1] == 4.0)
    checksum = float(out.sum(dtype=torch.float64))
    assert checksum == pytest.approx(row["checksum"], rel=CHECKSUM_RTOL)
    assert (attrs is not None) == (variant == "ext")


def test_first_sweep_matches_jax_hit_spheres(port_plan):
    """The twin's first sweep against the JAX package's closest hit on the
    same rays (the twin's, with unit directions: K1's quadratic assumes
    them) and scene."""
    soa, _, plan, slot_ext = port_plan
    T = 4096
    ox, oy, oz, dx, dy, dz, tm = tw.initial_rays(T, "cpu")
    d = torch.stack([dx, dy, dz], 1).double()
    d = (d / d.norm(dim=1, keepdim=True)).float()
    rays = (ox, oy, oz, d[:, 0], d[:, 1], d[:, 2], tm)
    best, slot = tw.sweep(soa, rays, plan.ut_t0, plan.ut_idt)
    jscene = jscenes.make_scene("random_balls", 1.5)
    o = np.stack([ox.numpy(), oy.numpy(), oz.numpy()], 1)
    jt, jidx = jgeo.hit_spheres(jnp.asarray(o), jnp.asarray(d.numpy()),
                                jnp.asarray(tm.numpy()), 0.001,
                                jscene.spheres, True)
    jt, jidx = np.asarray(jt), np.asarray(jidx)
    hit = best.numpy() < 1e30
    assert hit.mean() > 0.5
    np.testing.assert_array_equal(hit, jt < 1e30)
    bt = best.numpy()[hit]
    assert (np.abs(bt - jt[hit]) <= T_RTOL * jt[hit]).mean() >= MIN_SAME
    np.testing.assert_allclose(bt, jt[hit], rtol=T_RTOL_ALL)
    rows = np.asarray(slot_ext)[slot.numpy()[hit]]
    assert (rows == jidx[hit]).mean() >= MIN_SAME


def test_ext_rows_are_the_winner_rows(port_plan):
    """ext keeps the 24 attribute rows of each lane's argmin slot: a numpy
    gather at the argmin of the per-slot t matrix, iteration by iteration
    (K = 2), on lanes with no tie."""
    soa, attr, plan, _ = port_plan
    T, K = 256, 2
    _, attrs = tw.sweep_twin_reference(soa, attr, T, 1, K, plan.ut_t0,
                                       plan.ut_idt, True)
    rays = tw.initial_rays(T, "cpu")
    for _ in range(K):
        cols = tuple(r[:, None] for r in rays)
        t = tw.slot_t(soa, cols, (cols[6] - plan.ut_t0) * plan.ut_idt)
        t = t.numpy()
        best = t.min(axis=1)
        assert ((t == best[:, None]).sum(axis=1) == 1).all()   # no tie
        assert (best < 1e30).all()
        want = attr.numpy()[:, t.argmin(axis=1)]
        rays = tw._couple(rays, torch.from_numpy(best))
    np.testing.assert_array_equal(attrs[0].numpy(), want)


def test_twin_stops_when_no_lane_hits(port_plan):
    """The loop condition is the data-dependent any(): a table whose slots
    are all padding (nr2 = +1 never hits) stops after one iteration; every
    grid step computes the same rows."""
    soa, attr, plan, _ = port_plan
    dead = soa.clone()
    dead[8] = 1.0
    dead[0:3] = 50.0
    out, attrs = tw.sweep_twin(dead, attr, 64, 3, 4, plan.ut_t0,
                               plan.ut_idt, True)
    assert torch.all(out[:, 1] == 1.0)
    assert torch.all(attrs == 0.0)
    out, _ = tw.sweep_twin(soa, attr, 64, 3, 3, plan.ut_t0, plan.ut_idt,
                           False)
    assert torch.all(out[:, 1] == 3.0)
    assert torch.equal(out[0], out[2])


def test_cli_on_cpu_prints_rows_with_every_key(capsys):
    """`--device cpu` at tiny K and G: one JSON row a variant."""
    assert tw.main(["--device", "cpu", "--iters", "2", "--grid", "2",
                    "--reps", "1"]) == 0
    rows = [json.loads(line) for line in capsys.readouterr().out.splitlines()]
    assert [r["variant"] for r in rows] == ["quad", "ext"]
    for r in rows:
        assert set(r) == ROW_KEYS
        assert (r["S"], r["T"], r["G"], r["K"]) == (488, 256, 2, 2)
        assert r["iters_done"] == 2.0
        assert r["device"] == "cpu (plain version)"
    assert rows[0]["checksum"] == rows[1]["checksum"]


def test_kernel_wrapper_takes_cuda_tensors_only(port_plan):
    """The kernel wrapper raises on CPU tensors (the dispatcher takes the
    plain version for them); the default device raises without a card."""
    soa, attr, plan, _ = port_plan
    with pytest.raises(ValueError, match="CUDA tensors"):
        tw.sweep_twin_kernel(soa, attr, 256, 1, 1, 0.0, 1.0, False)
    if torch.cuda.is_available():
        pytest.skip("a card is present")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        tw.run(K=1, G=1)
