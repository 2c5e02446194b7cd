"""Large-S cluster culling (K5) of the port against the JAX package.

On the CPU the port runs its plain PyTorch version, which sweeps as the
culled CUDA kernel does (votes per warp of 32 lanes); the JAX side runs
as its own tests run it (interpret mode, `mega_grad.tape_forward`, the
XLA replay).

- The cluster tables (`clus_tab`, `clus_moving`) and the launch plans'
  slot orders are bitwise JAX's.
- Culling only skips clusters that cannot hold the winner, so the culled
  sweep equals the dense one bit for bit: image, segments, lane
  iterations and tape, in ascending and in near-to-far order. It sweeps a
  visited cluster only for the lanes whose own rays need it: row 7 counts
  those (at most row 6, the warp's visits), and the card test's launches
  hold visits on both sides of K_BCAST, so the card covers the compacted
  and the broadcast sweep.
- Exact-spp tapes match the JAX tape-mode kernel (SB = 256, interleaved
  votes) on >= 99% of lanes, with radiance on those lanes to the replay
  gate of tests/test_mega_grad.py (rtol 1e-3, atol 5e-5), and the JAX
  replay of the port's tape reproduces the port's image to that gate
  wherever the JAX kernel's own image holds it.
- Overdraw mode agrees with the JAX kernel's mean within 5%, the
  statistical gate of tests/test_megakernel.py's coherent-layout test.
"""
import functools

import numpy as np
import pytest

torch = pytest.importorskip("torch")
import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from raytracingweekend_tpu.models import scenes as jscenes  # noqa: E402
from raytracingweekend_tpu.ops import mega_grad as mg  # noqa: E402
from raytracingweekend_tpu.ops import megakernel as mk  # noqa: E402
from raytracingweekend_tpu_torch import render as trender  # noqa: E402
from raytracingweekend_tpu_torch.models.scenes import make_scene  # noqa: E402
from raytracingweekend_tpu_torch.ops import megakernel as tk  # noqa: E402
from test_torch_scene import _assert_tables  # noqa: E402

torch.set_num_threads(2)

NX = NY = 16
SPP, DEPTH = 4, 5
RTOL, ATOL = 1e-3, 5e-5
KEYS = (3, 4, 5, 6)   # four launches pool 1024 lanes for the 99% gate


@functools.lru_cache(maxsize=None)
def _scenes(name, n=None):
    kw = {} if n is None else {"n": n}
    return (jscenes.make_scene(name, 1.0, **kw), make_scene(name, 1.0, **kw))


@pytest.mark.parametrize("name,n,SB", [
    ("random_balls_large", 16, 128), ("random_balls_large", 30, 128),
    ("random_balls_large", 30, 256), ("random_balls_large", 60, 128),
    ("random_balls_large", 60, 256), ("random_balls", None, 128)])
def test_cluster_tables_bitwise(name, n, SB):
    """Every table of the plan and the cluster AABBs over the
    motion-swept spheres with their per-axis motion flags (random_balls
    moves along y)."""
    js, ts = _scenes(name, n)
    meta_t = _assert_tables(js, ts, SB)
    _, _, clus_j, *_, meta_j = mk.build_tables(js, SB)
    clus_j = np.asarray(clus_j)
    assert clus_j.shape == meta_t["clus_tab"].shape == (meta_t["C"], 128)
    assert clus_j.tobytes() == meta_t["clus_tab"].tobytes()
    assert meta_t["clus_moving"] == meta_j["clus_moving"]
    if name == "random_balls":
        assert any(m[1] for m in meta_t["clus_moving"])
        assert not any(m[0] or m[2] for m in meta_t["clus_moving"])


def test_exact_slot_order_is_the_jax_tape_plans():
    """Past 512 live spheres the JAX tape plan takes clusters of 256
    slots; the port's exact mode must too, or its winner codes name other
    slots than JAX's tape."""
    js, ts = _scenes("random_balls_large", 30)
    tabs, plan = tk.make_plan(ts, NX, NY, SPP, max_depth=DEPTH, exact=True)
    ctx = mg.plan_tape(js, NX, NY, SPP, max_depth=DEPTH, T=256)
    meta_j, meta_t = ctx["meta"], tabs[-1]
    assert plan.SB == meta_t["SB"] == meta_j["SB"] == ctx["cfg"].SB == 256
    assert plan.C == meta_t["C"] == meta_j["C"] == 4
    assert np.array_equal(meta_t["slot_ext"], meta_j["slot_ext"])


@pytest.mark.parametrize("n", [16, 30, 60])
@pytest.mark.parametrize("exact", [False, True])
def test_make_plan_auto_rules_match_jax(n, exact):
    """Clusters, culling and visit order follow JAX's auto rules: SB 512
    up to 512 live spheres, then 128 (overdraw) or 256 (tape); culling
    from C > 1; near-to-far order with 16 buckets from C >= 8 in overdraw
    mode, ascending cluster id in tape mode. (Below 512 spheres the port
    keeps its cluster unpadded: JAX rounds it to 128 lanes.)"""
    js, ts = _scenes("random_balls_large", n)
    _, plan = tk.make_plan(ts, 64, 64, 4, exact=exact)
    cfg = mk.make_plan(js, 64, 64, 4, tape=exact)[1]
    assert plan.C == cfg.C and plan.cull == cfg.cull == (cfg.C > 1)
    assert plan.dyn_order == cfg.dord == (16 if cfg.C >= 8 and not exact
                                          else 0)
    if cfg.C > 1:
        assert plan.SB == cfg.SB == (256 if exact else 128)


def test_make_plan_refusals():
    """The dense sweep stages a static slot in 16 B: random_balls_huge's
    (S = 14464, 231,424 B) fits the 227 KB of shared memory a block can
    use, random_balls_large at n = 122 (S = 14976, 239,616 B) does not,
    and the plan says so instead of a refused launch. A scene with rects
    culls too (the culled surfaces kernel, K5s), and the culled kernels
    vote per warp."""
    _, huge = _scenes("random_balls_huge")
    _, plan = tk.make_plan(huge, 64, 64, 4)
    assert plan.cull and plan.C == 113 and plan.S == 14464
    assert tk.shared_bytes(plan) < tk.SHARED_MAX
    _, dense = tk.make_plan(huge, 64, 64, 4, cull=False)
    assert tk.shared_bytes(dense) == 16 * 14464 <= tk.SHARED_MAX
    wider = make_scene("random_balls_large", 1.0, n=122)
    with pytest.raises(ValueError, match="232448"):
        tk.make_plan(wider, 64, 64, 4, cull=False)
    _, plan = tk.make_plan(make_scene("cornell_box", 1.0), 8, 8, 1,
                           cull=True)
    assert plan.cull and plan.surfaces and plan.C == 1
    with pytest.raises(ValueError, match="multiple of 32"):
        tk.make_plan(huge, 8, 8, 1, T=48)


@pytest.mark.parametrize("exact", [False, True])
def test_shared_bytes_stage_static_clusters_only(exact):
    """A culled launch with static spheres holds two buffers of a
    cluster's SB centre quads (16 B each) for each warp ahead of its boxes
    and bucket slots; with moving spheres (random_balls, cut into C = 4
    clusters) it holds none."""
    _, large = _scenes("random_balls_large", 30)
    _, book1 = _scenes("random_balls")
    for scene, staged in ((large, True), (book1, False)):
        _, plan = tk.make_plan(scene, 64, 64, 2, exact=exact, SB=128)
        assert plan.cull and plan.C > 1
        assert (plan.moving or any(plan.moving_axes)) != staged
        warps = (256 if exact else plan.T) // 32
        boxes = 4 * plan.C * (6 + (warps if plan.dyn_order else 0))
        stage = warps * 2 * plan.SB * 16 if staged else 0
        assert tk.shared_bytes(plan) == stage + boxes


def test_make_plan_refuses_wide_culled_tiles():
    """The culled kernels' launch bounds cap a lane at 128 registers, so
    their overdraw blocks hold at most CULLED_MAX_T = 512 lanes; exact
    mode runs blocks of 256 whatever T is."""
    _, huge = _scenes("random_balls_huge")
    assert tk.make_plan(huge, 64, 64, 4, T=512)[1].cull
    with pytest.raises(ValueError, match="at most 512 lanes"):
        tk.make_plan(huge, 64, 64, 4, T=1024)
    assert tk.make_plan(huge, 64, 64, 4, T=1024, exact=True)[1].cull


@pytest.mark.parametrize("dyn_order", [0, 16])
@pytest.mark.parametrize("exact", [True, False])
@pytest.mark.parametrize("name,n", [("random_balls", None),
                                    ("random_balls_large", 30)])
def test_culled_sweep_equals_dense(name, n, exact, dyn_order):
    """The plain culled sweep against the plain dense sweep, SB = 128:
    random_balls (moving spheres, C = 4) and random_balls_large(n=30)
    (C = 8), bit for bit, with fewer blocks swept than lane_iters * C."""
    _, ts = _scenes(name, n)
    kw = dict(max_depth=8, T=256, exact=exact, SB=128, device="cpu")
    dense = tk.trace_mega(77, ts, NX, NY, SPP, cull=False, **kw)
    culled = tk.trace_mega(77, ts, NX, NY, SPP, cull=True,
                           dyn_order=dyn_order, **kw)
    C = tk.make_plan(ts, NX, NY, SPP, SB=128)[1].C
    assert C == (4 if name == "random_balls" else 8)
    assert torch.equal(culled.image, dense.image)
    assert float(culled.segments) == float(dense.segments)
    assert float(culled.lane_iters) == float(dense.lane_iters)
    if exact:
        assert torch.equal(culled.tape, dense.tape)
    assert float(dense.blocks) == float(dense.lane_iters) * C
    assert 0 < float(culled.blocks) < float(culled.lane_iters) * C
    assert float(dense.lane_need) == float(dense.blocks)
    assert 0 < float(culled.lane_need) <= float(culled.blocks)


@pytest.mark.parametrize("exact", [False, True])
def test_lane_need_counts_the_rays_own_clusters(exact):
    """Row 7 (the clusters each lane's own ray needed) is at most row 6
    (the clusters its warp swept) on every lane, and below it in total on
    random_balls_large(n=30): a warp visits clusters some of its lanes do
    not need."""
    _, ts = _scenes("random_balls_large", 30)
    _, plan = tk.make_plan(ts, NX, NY, SPP, max_depth=8, exact=exact,
                           SB=128)
    args, _ = tk.device_inputs(ts, plan, "cpu")
    out = tk.trace_mega_reference(*args, 77, plan)
    r6, r7 = out[:, 6], out[:, 7]
    assert (r7 <= r6).all()
    assert 0 < r7.sum().item() < r6.sum().item()


@pytest.mark.parametrize("exact", [False, True])
@pytest.mark.parametrize("name", ["random_balls_large", "random_balls_huge"])
def test_card_launch_sweeps_both_branches(name, exact):
    """At the card test's launch (64x64, 2 spp, depth 8:
    tests/test_torch_kernel_card.py) the plain version's per-warp need
    masks hold visits on both sides of K_BCAST, so the card test runs the
    compacted and the broadcast sweep. The histogram's needing lanes sum
    to row 7; in overdraw mode its visits are row 6 over 32 lanes."""
    scene = make_scene(name, 1.0)
    _, plan = tk.make_plan(scene, 64, 64, 2, max_depth=8, exact=exact)
    args, _ = tk.device_inputs(scene, plan, "cpu")
    hist = torch.zeros(33, dtype=torch.int64)
    out = tk.trace_mega_reference(*args, 31337, plan, need_hist=hist)
    visits = tk.visits_by_branch(hist)
    assert visits["compacted"] > 0 and visits["broadcast"] > 0
    assert hist[0] == 0
    assert (hist * torch.arange(33)).sum().item() == out[:, 7].sum().item()
    if not exact:
        assert out[:, 6].sum().item() == 32 * hist.sum().item()


@pytest.mark.parametrize("exact", [False, True])
def test_one_lane_a_warp_is_compacted(exact):
    """The card test's forced-compacted launch: random_balls_large(n=30)
    at 64x64 with the valid row of pixf zeroed on 31 lanes of every 32.
    Invalid lanes start done, so every visit is needed by one lane (k =
    1 < K_BCAST), and that lane needs every cluster its warp visits: row
    7 equals row 6 on it. The image equals the dense sweep's."""
    _, ts = _scenes("random_balls_large", 30)
    kw = dict(max_depth=8, exact=exact)
    _, plan = tk.make_plan(ts, 64, 64, 2, **kw)
    _, dense = tk.make_plan(ts, 64, 64, 2, cull=False, **kw)
    assert plan.cull and not dense.cull
    args, _ = tk.device_inputs(ts, plan, "cpu")
    pixf = args[0].clone()
    lone = torch.arange(pixf.shape[2]) % 32 == 0
    pixf[:, 2, ~lone] = 0.0
    hist = torch.zeros(33, dtype=torch.int64)
    out = tk.trace_mega_reference(pixf, *args[1:], 31337, plan,
                                  need_hist=hist)
    out_d = tk.trace_mega_reference(pixf, *args[1:], 31337, dense)
    assert hist[1] > 0 and hist[2:].sum() == 0
    valid = pixf[:, 2] > 0
    assert torch.equal(out[:, 7][valid], out[:, 6][valid])
    assert torch.equal(out[:, :6], out_d[:, :6])
    if exact:
        assert torch.equal(out[:, 8:], out_d[:, 8:])


class _ConstsLib:
    """A stand-in for the kernel library's rtw_culled_consts."""

    def __init__(self, consts):
        self.consts = consts

    def rtw_culled_consts(self, out):
        out[0], out[1] = self.consts


@pytest.mark.parametrize("consts,ok", [
    ((tk.K_BCAST, tk.CULLED_MAX_T), True),
    ((tk.K_BCAST + 1, tk.CULLED_MAX_T), False),
    ((tk.K_BCAST, tk.CULLED_MAX_T // 2), False)])
def test_k_bcast_is_the_kernels(consts, ok):
    """The plain version splits visits where the kernel does, and plans
    refuse the tiles the kernel refuses: loading a library whose exported
    (kBcast, kCulledMaxT) differ from (K_BCAST, CULLED_MAX_T) raises."""
    if ok:
        tk.check_culled_consts(_ConstsLib(consts))
    else:
        with pytest.raises(RuntimeError, match="kBcast, kCulledMaxT"):
            tk.check_culled_consts(_ConstsLib(consts))


@functools.lru_cache(maxsize=None)
def _exact_pair(key):
    """One exact-spp launch of random_balls_large(n=30) on both sides:
    (JAX ctx, image, tape, seed, port result)."""
    js, ts = _scenes("random_balls_large", 30)
    ctx = mg.plan_tape(js, NX, NY, SPP, max_depth=DEPTH, T=256)
    img, tape, seed = mg.tape_forward(jax.random.key(key), ctx,
                                      interpret=True)
    seed = int(np.asarray(seed)[0, 0])
    res = tk.trace_mega(seed, ts, NX, NY, SPP, max_depth=DEPTH,
                        rr_depth=None, T=ctx["T"], exact=True, device="cpu")
    return ctx, np.asarray(img), np.asarray(tape), seed, res


def test_exact_spp_matches_jax_tape():
    """random_balls_large(n=30) in tape mode: JAX SB 256, C 4,
    interleaved votes; the port culls in ascending cluster id."""
    same_lanes = 0
    for key in KEYS:
        ctx, img_j, tape_j, _, res = _exact_pair(key)
        assert ctx["cfg"].cull and not ctx["cfg"].dyn and ctx["cfg"].C == 4
        tape_t = res.tape.numpy()
        assert tape_t.shape == tape_j.shape
        same = (tape_t == tape_j).all(axis=1).reshape(-1)
        same_pix = same[np.asarray(ctx["inv"])].reshape(NY, NX)
        a, b = res.image.numpy()[same_pix] / SPP, img_j[same_pix]
        assert np.allclose(a, b, rtol=RTOL, atol=ATOL), (
            f"key {key}: max abs err {np.abs(a - b).max():.3g}")
        same_lanes += int(same_pix.sum())
        assert 0 < float(res.blocks) < float(res.lane_iters) * 4
    assert same_lanes >= 0.99 * len(KEYS) * NX * NY


def test_jax_replay_of_port_tape():
    """The JAX replay fed the port's tape reproduces the port's image to
    the replay gate wherever the reference holds that gate itself. On
    this scene the JAX kernel's own image misses the replay of its own
    tape on a few pixels (1-3 of 256 a key here: the replay recomputes
    decisions that are not on the tape, ROADMAP Queue 3, "Already in the
    reference" item 4); the port may miss it there and nowhere else."""
    js, _ = _scenes("random_balls_large", 30)
    missed_ref = 0
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
        assert ok_t[ok_j].all(), (
            f"key {key}: {int((ok_j & ~ok_t).sum())} pixels miss the gate "
            "where the reference holds it")
        missed_ref += int((~ok_j).sum())
    assert missed_ref <= 0.01 * len(KEYS) * NX * NY


def test_overdraw_matches_jax_statistically():
    """random_balls_large(n=30) at 32x32x8, depth 4: both plans are C = 8
    near-to-far culls (JAX's per tile, the port's per warp)."""
    js, ts = _scenes("random_balls_large", 30)
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


@pytest.mark.parametrize("name", ["random_balls_large", "random_balls_huge"])
def test_cli_renders_stress_scene_on_cpu(tmp_path, capsys, name):
    out = tmp_path / f"{name}.png"
    trender.main(["--scene", name, "--nx", "8", "--ny", "6", "--spp", "1",
                  "--max-depth", "3", "--device", "cpu", "--stats",
                  "--out", str(out)])
    assert out.read_bytes()[:8] == b"\x89PNG\r\n\x1a\n"
    assert f"({name}, 8x6, 1 spp)" in capsys.readouterr().out
