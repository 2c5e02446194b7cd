"""The port's mesh path (raytracingweekend_tpu_torch/parallel/,
ops/mega_grad.py::make_sharded_value_and_grad) on the CPU, on four gloo
ranks that parallel/distributed.py::spawn starts (2 threads each; the
rank-side work is tests/_torch_parallel_ranks.py, which imports no JAX),
against the JAX package's parallel/ on the virtual CPU mesh and against
the sequential emulations (parallel/emulate.py), at the JAX tests' sizes:

- render_sharded_mega equals its emulation bit for bit at (2, 2), (1, 2)
  and (2, 1) (meshes narrower than the world: the ranks outside return
  None), equals trace_mega at (1, 1), takes JAX's seeds, and meets JAX's
  image and dp tiles' means within 5%;
- render_sharded equals its emulation bit for bit and meets JAX's
  render_sharded at tests/test_sharding.py's gates;
- the sharded gradient equals its emulation (loss rtol 1e-6, gradient
  rtol 1e-5); each shard's tape is JAX's on >= 99% of lanes; fed JAX's
  tapes, it meets JAX's make_sharded_value_and_grad (rtol 1e-3 / atol
  1e-6); the shard seeds wrap as JAX's int32 arithmetic;
- fit_scene_params_mega(mesh=) passes tests/test_mega_grad.py:397-430's
  gates; dp_scaling_report gives JAX's row keys; render_distributed,
  dryrun_multichip and the timing tools run; without a card the "cuda"
  entry points raise.
"""
import inspect
import json
import re

import numpy as np
import pytest

torch = pytest.importorskip("torch")
import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

import _torch_parallel_ranks as ranks  # noqa: E402
from raytracingweekend_tpu.models import scenes as jscenes  # noqa: E402
from raytracingweekend_tpu.ops import mega_grad as jmg  # noqa: E402
from raytracingweekend_tpu.parallel import mesh as jmesh  # noqa: E402
from raytracingweekend_tpu.parallel import scaling as jscaling  # noqa: E402
from raytracingweekend_tpu_torch.models.scenes import make_scene  # noqa: E402
from raytracingweekend_tpu_torch.ops import mega_grad as mg  # noqa: E402
from raytracingweekend_tpu_torch.ops import megakernel as mk  # noqa: E402
from raytracingweekend_tpu_torch.parallel import distributed  # noqa: E402
from raytracingweekend_tpu_torch.parallel import emulate  # noqa: E402
from raytracingweekend_tpu_torch.parallel import mesh as tmesh  # noqa: E402
from raytracingweekend_tpu_torch.parallel.dryrun import (  # noqa: E402
    dryrun_multichip)
from raytracingweekend_tpu_torch.tools import grad_bench  # noqa: E402
from raytracingweekend_tpu_torch.tools import (  # noqa: E402
    inverse_render_bench, scaling_report)
from raytracingweekend_tpu_torch.utils import prng  # noqa: E402

torch.set_num_threads(2)

WORLD = 4
# a spawned run's deadline and collective timeout: a rank that hangs fails
# its test, well inside the suite's own limit
SPAWN_TIMEOUT = 240.0
MEAN_RTOL = 0.05


def _jset(sc, p):
    return sc.replace(textures=sc.textures.replace(color=p))


@pytest.fixture(scope="module")
def jax_grad():
    """JAX's sharded value and gradient at (2, 2) on GRAD's workload, its
    aux, and JAX's tape of each shard (its _tape_launch at the shard's
    seed and layout, at JAX's tile width)."""
    name, nx, ny, spp, depth, T, k = ranks.GRAD
    js = jscenes.make_scene(name, 1.0)
    vg, aux = jmg.make_sharded_value_and_grad(
        js, jmesh.make_mesh(2, 2), jnp.zeros((ny, nx, 3), jnp.float32),
        nx=nx, ny=ny, spp=spp, max_depth=depth, T=T, set_params=_jset,
        interpret=True)
    seed = jax.random.randint(jax.random.key(k), (1, 1), 0,
                              np.int32(2 ** 31 - 1), dtype=jnp.int32)
    loss, g = jax.jit(vg)(js.textures.color, seed)
    tabs8 = jmg.build_tables_traced(js, js, aux["meta"])

    @jax.jit
    def tape(pixf_dev, seed_dev):
        return jmg._tape_launch(tabs8, pixf_dev, seed_dev, aux["cfg"],
                                aux["n_tiles_l"], True)

    tapes = {}
    for di in range(2):
        for si in range(2):
            seed_dev = (seed + np.int32(di) * jmg._DP_SEED
                        + np.int32(si) * jmg._SP_SEED)
            pixf_dev = aux["pixf_l"].at[:, 1, :].add(float(di * aux["rows"]))
            tapes[di, si] = np.asarray(tape(pixf_dev, seed_dev))
    return dict(loss=float(loss), g=np.asarray(g), aux=aux,
                T=int(aux["ctx"]["T"]), tapes=tapes)


@pytest.fixture(scope="module")
def world(jax_grad):
    """Every rank's results of ranks.battery on four spawned gloo ranks."""
    res = distributed.spawn(ranks.battery, WORLD,
                            args=(jax_grad["tapes"], jax_grad["T"]),
                            device="cpu", timeout=SPAWN_TIMEOUT, threads=2)
    assert [r["rank"] for r in res] == list(range(WORLD))
    return res


def _canvas(world, key, dp):
    """The (ny, nx, 3) canvas of the ranks' row tiles under results[key]:
    tile di from every rank at coordinate (di, *), all equal."""
    tiles = {}
    for r in world:
        coord, tile = r[key]
        if coord is None:
            assert tile is None
            continue
        if coord[0] in tiles:
            np.testing.assert_array_equal(tile, tiles[coord[0]])
        tiles[coord[0]] = tile
    assert sorted(tiles) == list(range(dp))
    return np.concatenate([tiles[d] for d in range(dp)])


@pytest.mark.parametrize("dp,sp", [(2, 2), (1, 2), (2, 1)])
def test_sharded_mega_equals_sequential_emulation(world, dp, sp):
    name, nx, ny, spp, depth, T, k = ranks.MEGA
    got = _canvas(world, ("mega", dp, sp), dp)
    emu = emulate.render_sharded_mega(make_scene(name, 1.0), dp, sp,
                                      prng.key(k), nx, ny, spp,
                                      max_depth=depth, T=T).numpy()
    assert got.shape == (ny, nx, 3) and np.isfinite(got).all()
    np.testing.assert_array_equal(got, emu)
    outside = [r["rank"] for r in world if r["mega", dp, sp][0] is None]
    assert outside == list(range(dp * sp, WORLD))


def test_sharded_mega_at_1x1_is_trace_mega(world):
    name, nx, ny, spp, depth, T, k = ranks.MEGA
    got = _canvas(world, ("mega", 1, 1), 1)
    res = mk.trace_mega(tmesh.shard_seed(prng.key(k), 0, 0),
                        make_scene(name, 1.0), nx, ny, spp, max_depth=depth,
                        T=T, device="cpu")
    np.testing.assert_array_equal(got, (res.image / spp).numpy())


def test_sharded_mega_seeds_are_jax_draws():
    k = ranks.MEGA[6]
    for di in range(2):
        for si in range(2):
            jk = jax.random.fold_in(jax.random.fold_in(jax.random.key(k),
                                                       di), si)
            want = jax.random.randint(jk, (1, 1), 0, np.int32(2 ** 31 - 1),
                                      dtype=jnp.int32)
            assert tmesh.shard_seed(prng.key(k), di, si) == int(want[0, 0])


def test_sharded_mega_meets_jax(world):
    """JAX's render_sharded_mega on the same mesh shape and key (its tile
    width rounds up to 512 lanes, so its lanes' streams differ): the
    image mean and each dp tile's mean within 5%."""
    name, nx, ny, spp, depth, T, k = ranks.MEGA
    got = _canvas(world, ("mega", 2, 2), 2)
    want = np.asarray(jmesh.render_sharded_mega(
        jscenes.make_scene(name, 1.0), jmesh.make_mesh(2, 2),
        jax.random.key(k), nx, ny, spp, max_depth=depth, T=T,
        interpret=True))
    np.testing.assert_allclose(got.mean(), want.mean(), rtol=MEAN_RTOL)
    np.testing.assert_allclose(got.reshape(2, -1).mean(axis=1),
                               want.reshape(2, -1).mean(axis=1),
                               rtol=MEAN_RTOL)


def test_sharded_wavefront_meets_jax_and_its_emulation(world):
    """tests/test_sharding.py's gates against JAX's render_sharded on the
    same mesh shape and key (mean within 0.03, mean absolute difference
    below 0.12; dp tile means within 0.06), and the emulation bit for
    bit. JAX's jitted jitter is not the port's (ROADMAP N11), so the
    samples differ."""
    name, nx, ny, spp, depth, k = ranks.WAVE
    got = _canvas(world, "wave", 2)
    want = np.asarray(jmesh.render_sharded(
        jscenes.make_scene(name, 1.0), jmesh.make_mesh(2, 2),
        jax.random.key(k), nx, ny, spp, max_depth=depth))
    assert got.shape == want.shape == (ny, nx, 3)
    assert abs(got.mean() - want.mean()) < 0.03
    assert np.abs(got - want).mean() < 0.12
    np.testing.assert_allclose(got.reshape(2, -1).mean(axis=1),
                               want.reshape(2, -1).mean(axis=1), atol=0.06)
    emu = emulate.render_sharded(make_scene(name, 1.0), 2, 2, prng.key(k),
                                 nx, ny, spp, max_depth=depth).numpy()
    np.testing.assert_array_equal(got, emu)


def test_sharded_grad_equals_sequential_emulation(world, jax_grad):
    name, nx, ny, spp, depth, T, _ = ranks.GRAD
    losses = {r["grad"][0] for r in world}
    assert len(losses) == 1, losses
    for r in world[1:]:
        np.testing.assert_array_equal(r["grad"][1], world[0]["grad"][1])
    loss, g, aux_keys = world[0]["grad"]
    assert aux_keys == sorted(jax_grad["aux"])
    scene = make_scene(name, 1.0)
    e_loss, e_g, _ = emulate.value_and_grad(
        scene, np.zeros((ny, nx, 3), np.float32), 2, 2, scene.textures.color,
        ranks.grad_seed(), nx=nx, ny=ny, spp=spp, max_depth=depth, T=T,
        set_params=ranks.set_colors)
    np.testing.assert_allclose(loss, float(e_loss), rtol=1e-6)
    np.testing.assert_allclose(g, e_g.numpy(), rtol=1e-5, atol=1e-8)
    assert np.abs(g).sum() > 0


def test_sharded_grad_tapes_are_jax_tapes(jax_grad):
    """The shards' tapes (mega_grad.shard_tape, what a rank launches) at
    JAX's tile width record JAX's winners on >= 99% of the lanes. A shard
    holds 72 pixels, so one lane is 1.4% of it: the gate pools the four
    shards' 288 lanes, as the single-device tape tests pool theirs
    (ROADMAP N2; here one lane's last segment differs, a rect instead of
    a sphere, a grazing hit's rounding)."""
    name, nx, ny, spp, depth, _, _ = ranks.GRAD
    scene = make_scene(name, 1.0)
    aux = mg.sharded_setup(scene, np.zeros((ny, nx, 3), np.float32), 2, 2,
                           nx=nx, ny=ny, spp=spp, max_depth=depth,
                           T=jax_grad["T"], device="cpu")
    valid = aux["valid"].numpy()
    same = []
    for (di, si), jtape in jax_grad["tapes"].items():
        _, _, tape = mg.shard_tape(aux, scene, di, si, ranks.grad_seed())
        assert tape.shape == jtape.shape
        same.append((tape.numpy() == jtape).all(axis=1)[valid])
    same = np.concatenate(same)
    assert same.size == 4 * (nx * ny // 2)
    assert same.mean() >= 0.99, same.mean()


def test_sharded_grad_fed_jax_tapes_meets_jax(world, jax_grad):
    loss, g = world[0]["grad_jax_tapes"]
    np.testing.assert_allclose(loss, jax_grad["loss"], rtol=1e-3, atol=1e-6)
    np.testing.assert_allclose(g, jax_grad["g"], rtol=1e-3, atol=1e-6)


def test_shard_tape_seed_wraps_as_jax():
    seed = 2 ** 31 - 50_000
    jseed = jnp.asarray([[seed]], jnp.int32)
    got = []
    for di in range(2):
        for si in range(2):
            want = int((jseed + jnp.int32(di) * jmg._DP_SEED
                        + jnp.int32(si) * jmg._SP_SEED)[0, 0])
            got.append(mg.shard_tape_seed(seed, di, si))
            assert got[-1] == want
            assert got[-1] == mg.shard_tape_seed(
                torch.tensor([[seed]], dtype=torch.int32), di, si)
    assert min(got) < 0 <= max(got)


def test_fit_scene_params_mega_mesh_converges(world):
    """tests/test_mega_grad.py:397-430's gates at (2, 2); every rank ends
    with the same colours."""
    losses, final, colors = world[0]["fit"]
    for r in world[1:]:
        np.testing.assert_array_equal(r["fit"][2], colors)
    assert len(losses) == ranks.FIT["steps"]
    assert final < losses[0] * 0.75, (losses[0], final)
    ref = np.asarray(make_scene("cornell_box", 1.0).textures.color[1])
    rec = colors[1]
    assert np.abs(rec - ref).max() < 0.25, (rec, ref)
    assert np.abs(rec - ref).max() < np.abs(0.2 - ref.max()) * 0.5


def test_dp_scaling_report_keeps_jax_rows(world):
    """The rows' keys are those of the dict JAX's dp_scaling_report
    appends (read from its source: running it compiles for ~20 s)."""
    name, nx, ny, spp, depth, dps = ranks.SCALING
    rows = world[0]["scaling"]
    for r in world[1:]:
        assert r["scaling"] == rows
    src = inspect.getsource(jscaling.dp_scaling_report)
    jkeys = set(re.findall(r"(\w+)=", re.search(
        r"rows\.append\(dict\((.*?)\)\)", src, re.S).group(1)))
    assert len(jkeys) == 7
    assert [r["dp"] for r in rows] == list(dps)
    for r in rows:
        assert set(r) == jkeys
        assert r["seconds"] > 0 and np.isfinite(r["samples_per_s"])
    assert rows[0]["efficiency_vs_dp1"] == 1.0


def test_render_distributed_gathers_the_canvas(world):
    canvas = world[0]["distributed"]
    for r in world[1:]:
        np.testing.assert_array_equal(r["distributed"], canvas)
    emu = emulate.render_sharded(make_scene("dielectric", 1.0), 2, 2,
                                 prng.key(4), 16, 16, 8,
                                 max_depth=5).numpy()
    np.testing.assert_array_equal(canvas, emu)
    assert canvas.mean() > 0.1


def test_dryrun_multichip_on_cpu(capsys, monkeypatch):
    monkeypatch.setenv("OMP_NUM_THREADS", "2")      # the ranks' threads
    res = dryrun_multichip(WORLD, device="cpu", timeout=SPAWN_TIMEOUT)
    assert len(res) == WORLD
    assert {(r["dp"], r["sp"]) for r in res} == {(2, 2)}
    assert len({r["mg_loss"] for r in res}) == 1
    # the wrappers count kernel launches only: the CPU runs plain versions
    assert all(set(r["launches"]) >= {"K1", "K2+K3", "K7"}
               and not any(r["launches"].values()) for r in res)
    line = capsys.readouterr().out.strip().splitlines()[-1]
    assert line.startswith("dryrun_multichip(n_devices=4): mesh=(2,2)")
    assert line.count(" ok") == 3


def test_cuda_entry_points_raise_without_a_card():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    with pytest.raises(RuntimeError, match="CUDA"):
        distributed.initialize("file:///nonexistent", 1, 0)
    with pytest.raises(RuntimeError, match="CUDA"):
        distributed.spawn(ranks.grad_seed, 1)
    with pytest.raises(RuntimeError, match="CUDA"):
        dryrun_multichip(2)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        grad_bench.main(["--repeats", "1"])


def _last_json(capsys):
    return json.loads(capsys.readouterr().out.strip().splitlines()[-1])


def test_grad_bench_tool_on_cpu(capsys):
    grad_bench.main(["--device", "cpu", "--nx", "8", "--ny", "8", "--spp",
                     "2", "--max-depth", "2", "--repeats", "1",
                     "--wavefront"])
    row = _last_json(capsys)
    assert set(row) == {"scene", "nx", "ny", "spp", "max_depth",
                        "tape_forward_s", "replay_value_and_grad_s",
                        "step_s", "grad_finite", "wavefront_value_and_grad_s",
                        "speedup_vs_wavefront", "device"}
    assert row["grad_finite"] and row["device"] == "cpu (plain version)"


def test_inverse_render_bench_tool_on_cpu(capsys):
    inverse_render_bench.main(["--device", "cpu", "--nx", "8", "--ny", "8",
                               "--spp", "2", "--max-depth", "2", "--T", "64",
                               "--steps", "3"])
    out = _last_json(capsys)
    assert set(out) == {"scene", "nx", "ny", "spp", "steps", "seconds_total",
                        "s_per_step", "loss_first", "loss_final",
                        "true_color", "recovered", "note", "device"}
    assert out["steps"] == 3 and np.isfinite(out["loss_final"])


def test_scaling_report_tool_on_cpu(capsys, monkeypatch):
    monkeypatch.setenv("OMP_NUM_THREADS", "2")      # the ranks' threads
    scaling_report.main(["--device", "cpu", "--rate", "1e9", "--ranks", "2",
                         "--nx", "8", "--ny", "8", "--spp", "2"])
    doc = _last_json(capsys)
    assert [(r["path"], r["dp"]) for r in doc["rows"]] == [
        ("wavefront", 1), ("wavefront", 2), ("mega", 1), ("mega", 2)]
    pred = {(r["dp"], r["sp"]): r for r in doc["predicted_nvlink"]["rows"]}
    # book 1 at dp = 2: 1200 x 400 pixels in tiles of 256 lanes, 16 B a lane
    assert pred[2, 2]["allreduce_payload_bytes"] == 480_000 * 16
    # (1, 2): 64 spp of 960,000 pixels over 2 cards at 1e9 samples/s,
    # against a ring all-reduce of 960,000 x 16 B at 25 GB/s
    t_c = 1200 * 800 * 64 / 2 / 1e9
    t_m = 2 * (2 - 1) / 2 * 960_000 * 16 / 25e9
    assert pred[1, 2]["efficiency_nvlink4_1link_25GBs"] == pytest.approx(
        t_c / (t_c + t_m))
    assert doc["predicted_nvlink"]["config"]["single_card_samples_per_s"] \
        == 1e9
