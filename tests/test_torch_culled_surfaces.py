"""Cluster culling on scenes with rects, lights, media and textures (K5s)
of the port against the JAX package.

The probe is `models/probe_scenes.py::large_mixed_scene`, built by each
package's own builder: random_balls_large's grid (n = 30 here: 905
spheres, C = 8 clusters of 128 or 4 of 256) under a checker ground, a rect
light in the MIS list, an emissive sphere and an isotropic medium. On the
CPU the port runs its plain PyTorch version, which sweeps as the culled
CUDA kernel does (votes per warp of 32 lanes); the JAX side runs as its
own tests run it (interpret mode, `mega_grad.tape_forward`, the XLA
replay).

- The reference holds to itself: JAX's culled `_kernel` on the probe
  equals its dense one bit for bit (image and segments), as
  `test_dyn_cull_is_bitwise_exact` asserts for sphere scenes.
- The tables, cluster table and auto plan are JAX's.
- The plain culled sweep equals the plain dense one bit for bit, and
  sweeps a cluster for the lanes whose own rays need it (row 7); the card
  test's launches hold visits on both sides of K_BCAST.
- Exact-spp tapes match the JAX tape-mode kernel on >= 99% of 1024 pooled
  lanes, radiance to the replay gate of tests/test_mega_grad.py (rtol
  1e-3, atol 5e-5) on >= 99% of those lanes; the JAX replay of the port's
  tape holds that gate on >= 99% of the pixels where JAX's own image holds
  it; tape mode replays the port's culled tape bit for bit. A tape that
  matches does not fix every value on this scene (ROADMAP Queue 3, N9):
  the float32 root of a 0.2-radius ball rounds ~4e-5 off in t, the next
  hit point then lies ~1e-3 apart, and the rect light's MIS weight and
  emission, or the checker's sign, turn that into more than the gate on
  ~0.3% of the lanes whose tapes match (6 and 8 of ~2040 over keys 3-10,
  textured and moving; the port's culled image equals its dense one bit
  for bit there).
- Overdraw means agree with JAX's within 5%, the statistical gate of
  tests/test_megakernel.py's coherent-layout test.
"""
import functools

import numpy as np
import pytest

torch = pytest.importorskip("torch")
import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from raytracingweekend_tpu.models import builder as jbuilder  # noqa: E402
from raytracingweekend_tpu.models import scene_types as jst  # noqa: E402
from raytracingweekend_tpu.ops import mega_grad as mg  # noqa: E402
from raytracingweekend_tpu.ops import megakernel as mk  # noqa: E402
from raytracingweekend_tpu_torch import render as trender  # noqa: E402
from raytracingweekend_tpu_torch.models import builder as tbuilder  # noqa: E402
from raytracingweekend_tpu_torch.models import scene_types as tst  # noqa: E402
from raytracingweekend_tpu_torch.models.probe_scenes import (  # noqa: E402
    large_mixed_scene)
from raytracingweekend_tpu_torch.ops import mega_grad as tmg  # noqa: E402
from raytracingweekend_tpu_torch.ops import megakernel as tk  # noqa: E402
from raytracingweekend_tpu_torch.utils import prng  # noqa: E402
from test_torch_scene import _assert_tables  # noqa: E402

torch.set_num_threads(2)

NX = NY = 16
SPP, DEPTH = 4, 5
RTOL, ATOL = 1e-3, 5e-5
KEYS = (3, 4, 5, 6)   # four launches pool 1024 lanes for the 99% gate
VARIANTS = {"textured": {}, "moving": {"textured": False, "moving": True}}


@functools.lru_cache(maxsize=None)
def _scenes(variant="textured", n=30):
    kw = dict(VARIANTS[variant], n=n, aspect=1.0)
    return (large_mixed_scene(jbuilder, jst, **kw),
            large_mixed_scene(tbuilder, tst, **kw))


@pytest.mark.parametrize("variant", list(VARIANTS))
def test_jax_culled_equals_dense_on_probe(variant):
    """The reference against itself: JAX's `_kernel` with cull=True (C = 8
    near-to-far survivor sweep) and cull=False on the probe, SB 128, 16x16,
    2 spp, depth 5, interpret mode: the same image and segments, bit for
    bit. (No R8: the culled reference is exact here.)"""
    js, _ = _scenes(variant)
    key = jax.random.key(7)
    kw = dict(max_depth=5, T=256, SB=128, interpret=True)
    a, sa = mk.trace_mega(key, js, NX, NY, 2, cull=True, **kw)
    b, sb = mk.trace_mega(key, js, NX, NY, 2, cull=False, **kw)
    assert mk.make_plan(js, NX, NY, 2, SB=128, cull=True)[1].dyn
    np.testing.assert_array_equal(np.asarray(a), np.asarray(b))
    assert float(sa) == float(sb) > 0


@pytest.mark.parametrize("variant,n,SB", [
    ("textured", 30, 128), ("textured", 30, 256), ("textured", 60, 128),
    ("textured", 60, 256), ("moving", 30, 128), ("moving", 30, 256)])
def test_probe_tables_bitwise(variant, n, SB):
    """The probe's sphere, attribute, rect, light, medium, camera and
    cluster tables, its slot order and motion flags, bitwise JAX's."""
    js, ts = _scenes(variant, n)
    meta_t = _assert_tables(js, ts, SB)
    _, _, clus_j, *_, meta_j = mk.build_tables(js, SB)
    assert np.asarray(clus_j).tobytes() == meta_t["clus_tab"].tobytes()
    assert meta_t["clus_moving"] == meta_j["clus_moving"]
    assert (meta_t["R"], meta_t["L"], meta_t["V"]) == (1, 1, 1)
    assert meta_t["has_checker"] == (variant == "textured")
    assert any(any(m) for m in meta_t["clus_moving"]) == (variant == "moving")


@pytest.mark.parametrize("n", [30, 60])
@pytest.mark.parametrize("exact", [False, True])
def test_make_plan_auto_rules_match_jax_on_probe(n, exact):
    """JAX's auto rules, whatever the scene holds: culling from C > 1,
    SB 128 (overdraw) or 256 (tape), near-to-far order with 16 buckets from
    C >= 8 in overdraw mode, ascending cluster id in tape mode; the tape
    plan's slot order is JAX's."""
    js, ts = _scenes("textured", n)
    tabs, plan = tk.make_plan(ts, 64, 64, 4, exact=exact)
    cfg = mk.make_plan(js, 64, 64, 4, tape=exact)[1]
    assert plan.surfaces and plan.textures
    assert plan.C == cfg.C > 1 and plan.cull and cfg.cull
    assert plan.SB == cfg.SB == (256 if exact else 128)
    assert plan.dyn_order == cfg.dord == (0 if exact else 16)
    assert tk.shared_bytes(plan) < tk.SHARED_MAX
    if exact:
        ctx = mg.plan_tape(js, 64, 64, 4, max_depth=DEPTH, T=256)
        assert np.array_equal(tabs[-1]["slot_ext"], ctx["meta"]["slot_ext"])


@pytest.mark.parametrize("dyn_order", [0, 16])
@pytest.mark.parametrize("exact", [True, False])
@pytest.mark.parametrize("probe", [
    dict(), dict(textured=False), dict(textured=False, moving=True)],
    ids=["textured", "constant", "moving"])
def test_culled_sweep_equals_dense_on_probe(probe, exact, dyn_order):
    """The plain culled sweep against the plain dense sweep on the probe,
    SB 128 (C = 8), bit for bit: image, segments, lane iterations and tape,
    with fewer blocks swept than lane_iters * C."""
    ts = large_mixed_scene(tbuilder, tst, n=30, aspect=1.0, **probe)
    kw = dict(max_depth=6, T=256, exact=exact, SB=128, device="cpu")
    dense = tk.trace_mega(77, ts, NX, NY, 2, cull=False, **kw)
    culled = tk.trace_mega(77, ts, NX, NY, 2, cull=True,
                           dyn_order=dyn_order, **kw)
    assert torch.equal(culled.image, dense.image)
    assert float(culled.segments) == float(dense.segments)
    assert float(culled.lane_iters) == float(dense.lane_iters)
    if exact:
        assert torch.equal(culled.tape, dense.tape)
    assert float(dense.blocks) == float(dense.lane_iters) * 8
    assert 0 < float(culled.blocks) < float(dense.blocks)
    assert float(dense.lane_need) == float(dense.blocks)
    assert 0 < float(culled.lane_need) <= float(culled.blocks)


@pytest.mark.parametrize("exact", [False, True])
@pytest.mark.parametrize("variant", list(VARIANTS))
def test_card_launch_sweeps_both_branches_on_probe(variant, exact):
    """At the card test's launch (large_mixed(n=60) 64x64, 2 spp, depth
    8: tests/test_torch_kernel_card.py) row 7 is at most row 6 on every
    lane and below it in total, and the plain version's per-warp need
    masks hold visits on both sides of K_BCAST, so the card test runs the
    compacted and the broadcast sweep of the culled surfaces kernel."""
    _, ts = _scenes(variant, 60)
    _, plan = tk.make_plan(ts, 64, 64, 2, max_depth=8, exact=exact)
    assert plan.cull and plan.surfaces
    args, _ = tk.device_inputs(ts, plan, "cpu")
    hist = torch.zeros(33, dtype=torch.int64)
    out = tk.trace_mega_reference(*args, 31337, plan, need_hist=hist)
    r6, r7 = out[:, 6], out[:, 7]
    assert (r7 <= r6).all()
    assert 0 < r7.sum().item() < r6.sum().item()
    visits = tk.visits_by_branch(hist)
    assert visits["compacted"] > 0 and visits["broadcast"] > 0
    assert (hist * torch.arange(33)).sum().item() == r7.sum().item()


@functools.lru_cache(maxsize=None)
def _exact_pair(key):
    """One exact-spp launch of the probe on both sides: (JAX ctx, image,
    tape, seed, port result)."""
    js, ts = _scenes()
    ctx = mg.plan_tape(js, NX, NY, SPP, max_depth=DEPTH, T=256)
    img, tape, seed = mg.tape_forward(jax.random.key(key), ctx,
                                      interpret=True)
    seed = int(np.asarray(seed)[0, 0])
    res = tk.trace_mega(seed, ts, NX, NY, SPP, max_depth=DEPTH,
                        rr_depth=None, T=ctx["T"], exact=True, device="cpu")
    return ctx, np.asarray(img), np.asarray(tape), seed, res


def test_exact_spp_matches_jax_tape_on_probe():
    """The probe in tape mode: JAX SB 256, C 4, interleaved votes; the
    port culls in ascending cluster id. Winner codes cover spheres, the
    rect light (S), the medium (S + R) and misses."""
    same_lanes = close_lanes = 0
    codes = set()
    for key in KEYS:
        ctx, img_j, tape_j, _, res = _exact_pair(key)
        assert ctx["cfg"].cull and not ctx["cfg"].dyn and ctx["cfg"].C == 4
        tape_t = res.tape.numpy()
        assert tape_t.shape == tape_j.shape
        same = (tape_t == tape_j).all(axis=1).reshape(-1)
        same_pix = same[np.asarray(ctx["inv"])].reshape(NY, NX)
        a, b = res.image.numpy()[same_pix] / SPP, img_j[same_pix]
        close_lanes += int(np.isclose(a, b, rtol=RTOL, atol=ATOL).all(
            axis=-1).sum())
        same_lanes += int(same_pix.sum())
        assert 0 < float(res.blocks) < float(res.lane_iters) * 4
        codes |= set(np.unique(tape_t).astype(int).tolist())
    S = ctx["meta"]["S"]
    assert {-1, S, S + 1} <= codes and any(0 <= c < S for c in codes)
    assert same_lanes >= 0.99 * len(KEYS) * NX * NY
    assert close_lanes >= 0.99 * same_lanes, (close_lanes, same_lanes)


def test_jax_replay_of_port_tape_on_probe():
    """The JAX replay fed the port's tape reproduces the port's image to
    the replay gate on >= 99% of the pixels where the reference holds that
    gate on its own tape (ROADMAP Queue 3: R3, the replay recomputes
    decisions that are not on the tape; N9, a matching tape does not fix
    every value on this scene)."""
    js, _ = _scenes()
    missed_ref = held_ref = held_port = 0
    for key in KEYS:
        ctx, img_j, tape_j, seed, res = _exact_pair(key)
        replay = mg.make_replay(ctx)
        seed_j = jnp.asarray([[seed]], jnp.int32)
        img_rt = np.asarray(replay(js, jnp.asarray(res.tape.numpy()),
                                   seed_j))
        img_rj = np.asarray(replay(js, jnp.asarray(tape_j), seed_j))
        ok_t = np.isclose(res.image.numpy() / SPP, img_rt, rtol=RTOL,
                          atol=ATOL).all(axis=-1)
        ok_j = np.isclose(img_j, img_rj, rtol=RTOL, atol=ATOL).all(axis=-1)
        held_ref += int(ok_j.sum())
        held_port += int(ok_t[ok_j].sum())
        missed_ref += int((~ok_j).sum())
    assert missed_ref <= 0.01 * len(KEYS) * NX * NY
    assert held_port >= 0.99 * held_ref, (held_port, held_ref)


def test_tape_mode_replays_culled_tape_on_probe():
    """Tape mode (`mega_grad.plan_tape`) on the probe plans the culled
    surfaces kernel in exact mode (SB 256, ascending votes), and the
    replay (K6) of its tape reproduces its image bit for bit: the replay
    reads the winners from the tape and needs no sweep."""
    _, ts = _scenes()
    ctx = tmg.plan_tape(ts, NX, NY, 2, max_depth=DEPTH, T=256,
                        device="cpu")
    plan = ctx["plan"]
    assert plan.cull and plan.surfaces and plan.SB == 256
    assert plan.dyn_order == 0 and plan.C == 4
    img, tape, seed = tmg.tape_forward(prng.key(9), ctx)
    img2 = tmg.make_replay(ctx)(ts, tape, seed)
    assert torch.equal(img2, img)


def test_overdraw_matches_jax_statistically_on_probe():
    """The probe at 32x32x8, depth 4: both plans are C = 8 near-to-far
    culls (JAX's per tile, the port's per warp)."""
    js, ts = _scenes()
    img_j, _, _, blocks_j = mk.trace_mega(
        jax.random.key(11), js, 32, 32, 8, max_depth=4, T=256,
        interpret=True, return_stats=True)
    res = tk.trace_mega(2024, ts, 32, 32, 8, max_depth=4, device="cpu")
    mean_j = float(np.asarray(img_j).mean())
    mean_t = float(res.image.mean())
    assert abs(mean_t - mean_j) <= 0.05 * mean_j, (mean_t, mean_j)
    assert float(res.segments) >= 32 * 32 * 8
    assert 0 < float(res.blocks) < float(res.lane_iters) * 8
    assert float(blocks_j) > 0


def test_cli_renders_large_mixed_huge_on_cpu(tmp_path, capsys):
    """The CLI renders large_mixed at n = 120 (14405 spheres, C = 113),
    whose dense surfaces sweep does not fit a block's shared memory: the
    plan culls instead of raising ValueError."""
    out = tmp_path / "large_mixed_huge.png"
    trender.main(["--scene", "large_mixed_huge", "--nx", "8", "--ny", "6",
                  "--spp", "1", "--max-depth", "3", "--device", "cpu",
                  "--stats", "--out", str(out)])
    assert out.read_bytes()[:8] == b"\x89PNG\r\n\x1a\n"
    assert "(large_mixed_huge, 8x6, 1 spp)" in capsys.readouterr().out
