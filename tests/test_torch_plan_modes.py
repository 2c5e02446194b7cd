"""The megakernel's layout and culling modes of the port (k lanes a pixel,
the coherent pixel layout, two-level super-group votes, batched votes, the
bounce unroll) against the JAX package, on the CPU (the port's plain
version; the JAX kernel in interpret mode).

- Host plan, bitwise JAX's: the pixel layouts at k lanes a pixel, the
  cluster-binned layout and its memo, the super-group tables (Morton slot
  order, union rows).
- The culling modes only skip clusters that cannot hold the winner: the
  plain version equals the dense sweep over the same table bit for bit
  (image, segments, lane iterations), and super-groups without batched
  votes equal the same table's ascending sweep on every row, since a
  cluster a union vote drops fails its own vote too.
- The layout and unroll modes change which lanes trace which samples:
  their images agree with the default plan's and with the JAX kernel's in
  the same mode statistically, by the gates of tests/test_megakernel.py.
- The modes' refusals, and the tools that drive them (coherence_sweep,
  export_texture_raw, mega_perf's flags) at --device cpu.
"""
import dataclasses
import json
import os

import numpy as np
import pytest

torch = pytest.importorskip("torch")
import jax  # noqa: E402

from raytracingweekend_tpu.models import scenes as jscenes  # noqa: E402
from raytracingweekend_tpu.ops import megakernel as mk  # noqa: E402
from raytracingweekend_tpu_torch.models.scenes import make_scene  # noqa: E402
from raytracingweekend_tpu_torch.ops import megakernel as tk  # noqa: E402
from raytracingweekend_tpu_torch.ops.integrator import (  # noqa: E402
    _block_linear_order)
from raytracingweekend_tpu_torch.render import launch_seed  # noqa: E402
from raytracingweekend_tpu_torch.tools import (  # noqa: E402
    RTWI, coherence_sweep, export_texture_raw, mega_perf)
from raytracingweekend_tpu_torch.utils import image as image_mod  # noqa: E402

torch.set_num_threads(2)

SEED = 20240601
KEY = jax.random.key(7)
CPU = ["--device", "cpu"]


def _scenes(name, **kw):
    return jscenes.make_scene(name, 1.0, **kw), make_scene(name, 1.0, **kw)


def _blocks(a, n=8):
    """tests/test_megakernel.py's 8 x 8 block means."""
    ny, nx, _ = a.shape
    return a.reshape(n, ny // n, n, nx // n, 3).mean(axis=(1, 3))


def _port(scene, nx, ny, spp, **kw):
    return tk.trace_mega(SEED, scene, nx, ny, spp, device="cpu", **kw)


# ---- host plan, bitwise JAX's ----

@pytest.mark.parametrize("k", [1, 2, 4])
@pytest.mark.parametrize("nx,ny,T", [(16, 16, 128), (40, 24, 256),
                                     (33, 17, 64)])
def test_pixel_layout_k_bitwise(nx, ny, T, k):
    pixf_j, inv_j = mk._pixel_layout(nx, ny, T, k)
    pixf_t, inv_t = tk._pixel_layout(nx, ny, T, k)
    assert np.asarray(pixf_j).tobytes() == pixf_t.tobytes()
    assert np.array_equal(np.asarray(inv_j), inv_t)
    # a shuffled order too: _layout_from_order alone
    order = np.random.default_rng(nx * ny + k).permutation(
        nx * ny).astype(np.int32)
    inv = np.empty_like(order)
    inv[order] = np.arange(order.size, dtype=np.int32)
    a = mk._layout_from_order(order, inv, nx, ny, T, k)[0]
    b = tk._layout_from_order(order, inv, nx, ny, T, k)[0]
    assert np.asarray(a).tobytes() == b.tobytes()
    # every pixel on k lanes, the padding invalid
    lanes = (b[:, 1] * nx + b[:, 0]).astype(np.int64)[b[:, 2] > 0]
    assert np.array_equal(np.bincount(lanes, minlength=nx * ny),
                          np.full(nx * ny, k))


def test_device_layout_is_keyed_by_k():
    a = tk._device_layout(16, 16, 128, "cpu")
    assert tk._device_layout(16, 16, 128, "cpu", 1)[0] is a[0]
    b = tk._device_layout(16, 16, 128, "cpu", 2)
    assert b[0] is not a[0] and b[0].shape == (4, 4, 128)
    assert a[0].shape == (2, 4, 128)


@pytest.mark.parametrize("k", [1, 2])
def test_coherent_pixel_layout_bitwise(k):
    js, ts = _scenes("random_balls_large", n=30)
    meta_j = mk.build_tables(js, 128)[-1]
    meta_t = tk.build_tables(ts, 128)[-1]
    assert meta_t["C"] == meta_j["C"] == 8
    for key in ("clus_lo", "clus_hi"):
        assert np.asarray(meta_j[key]).tobytes() == meta_t[key].tobytes()
    pixf_j, inv_j = mk._coherent_pixel_layout(js, meta_j, 32, 32, 256, k)
    pixf_t, inv_t = tk._coherent_pixel_layout(ts, meta_t, 32, 32, 256, k)
    assert np.asarray(pixf_j).tobytes() == pixf_t.tobytes()
    assert np.array_equal(np.asarray(inv_j), inv_t)
    # the binning is not block-linear, and its inverse reassembles the
    # canvas
    assert not np.array_equal(inv_t, _block_linear_order(32, 32)[1])
    lanes = (pixf_t[:, 1] * 32 + pixf_t[:, 0]).astype(np.int64)
    assert np.array_equal(lanes[:, :256 // k].reshape(-1)[inv_t],
                          np.arange(32 * 32))
    # memoised per scene
    again = tk._coherent_pixel_layout(ts, meta_t, 32, 32, 256, k)
    assert again[0] is pixf_t


def test_coherent_device_layout_is_cached_per_scene():
    """device_inputs takes the binned layout for a coherent plan of C > 1
    clusters, one copy a scene; a one-cluster plan keeps block-linear, and
    a row tile refuses the binned layout."""
    _, ts = _scenes("random_balls_large", n=30)
    _, plan = tk.make_plan(ts, 32, 32, 2, max_depth=3, coherent=True)
    args, inv = tk.device_inputs(ts, plan, "cpu")
    again, _ = tk.device_inputs(ts, plan, "cpu")
    assert again[0] is args[0]
    ref = tk._coherent_pixel_layout(ts, tk.build_tables_cached(
        ts, plan.SB)[-1], 32, 32, plan.T, 1)
    assert args[0].numpy().tobytes() == ref[0].tobytes()
    assert np.array_equal(inv.numpy(), ref[1])
    other = make_scene("random_balls_large", 1.0, n=30)
    mine, _ = tk.device_inputs(other, plan, "cpu")
    assert mine[0] is not args[0] and torch.equal(mine[0], args[0])
    _, blp = tk.make_plan(ts, 32, 32, 2, max_depth=3)
    assert tk.device_inputs(ts, blp, "cpu")[0][0] is tk._device_layout(
        32, 32, blp.T, "cpu")[0]
    _, one = tk.make_plan(make_scene("dielectric", 1.0), 32, 32, 2,
                          coherent=True)
    assert one.C == 1 and one.coherent
    with pytest.raises(ValueError, match="row tile"):
        tk.device_inputs(ts, plan, "cpu", rows=16, row0=16)


@pytest.mark.parametrize("sg", [2, 4, 8])
@pytest.mark.parametrize("n", [16, 30, 60])
def test_super_group_tables_bitwise(n, sg):
    """Morton slot order at every C, then the Cg union rows after the C
    cluster rows: every table, slot_ext and the union rows are JAX's."""
    js, ts = _scenes("random_balls_large", n=n)
    (sph_j, attr_j, clus_j, rect_j, light_j, med_j, _, cam_j,
     meta_j) = mk.build_tables(js, 128, sg)
    sph_t, attr_t, rect_t, light_t, med_t, cam_t, meta_t = tk.build_tables(
        ts, 128, sg)
    for a, b in ((sph_j, sph_t), (attr_j, attr_t), (rect_j, rect_t),
                 (light_j, light_t), (med_j, med_t), (cam_j, cam_t),
                 (clus_j, meta_t["clus_tab"])):
        a = np.asarray(a)
        assert a.shape == b.shape and a.tobytes() == b.tobytes()
    assert np.array_equal(np.asarray(meta_j["slot_ext"]), meta_t["slot_ext"])
    C = meta_t["C"]
    assert (meta_t["sg"], meta_t["Cg"]) == (meta_j["sg"], meta_j["Cg"]) \
        == (sg, -(-C // sg))
    assert meta_t["clus_tab"].shape == (C + meta_t["Cg"], tk.CLUS_LANES)
    # the kd order with the biggest-radius clusters first is another slot
    # order
    assert not np.array_equal(tk.build_tables(ts, 128)[-1]["slot_ext"],
                              meta_t["slot_ext"])


# ---- the culling modes: exact against the dense sweep ----

MODES = [dict(super_group=4), dict(batch_votes=True, dyn_order=0),
         dict(super_group=2, batch_votes=True)]


def _plain_against_dense(scene, nx, ny, spp, depth, **kw):
    """The plan with `kw`, its plain version's output, and the plain
    dense sweep's over the same slot table (the same launch inputs)."""
    _, plan = tk.make_plan(scene, nx, ny, spp, max_depth=depth, **kw)
    args, _ = tk.device_inputs(scene, plan, "cpu")
    out = tk.trace_mega_reference(*args, SEED, plan)
    dense, dargs = tk.dense_over(plan, args)
    assert not dense.cull and dargs[4].shape[0] == plan.C
    return plan, out, tk.trace_mega_reference(*dargs, SEED, dense)


@pytest.mark.parametrize("kw", MODES, ids=["sg4", "bv", "sg2_bv"])
@pytest.mark.parametrize("name,n", [("random_balls", None),
                                    ("random_balls_large", 30)])
def test_culling_modes_equal_the_dense_sweep(name, n, kw):
    scene = make_scene(name, 1.0, **({} if n is None else {"n": n}))
    plan, out, dense = _plain_against_dense(scene, 16, 16, 2, 5, SB=128,
                                            **kw)
    assert plan.C == (4 if n is None else 8) and plan.cull
    assert plan.sg == kw.get("super_group", 0)
    assert plan.batch_votes == kw.get("batch_votes", False)
    assert torch.equal(out[:, :6], dense[:, :6])   # sums, segs, iters, done
    lane_iters = out[:, 4].sum().item()
    blocks = out[:, 6].sum().item()
    assert 0 < blocks < lane_iters * plan.C
    assert bool((out[:, 7] <= out[:, 6]).all()) and out[:, 7].sum() > 0


@pytest.mark.parametrize("name,n", [("random_balls", None),
                                    ("random_balls_large", 30)])
def test_union_votes_change_no_count(name, n):
    """A cluster whose group's union box no lane's ray enters before its
    best fails its own vote too: with interleaved votes, super-groups
    skip only work, and every output row equals the same table's
    ascending sweep, swept and needed blocks included."""
    scene = make_scene(name, 1.0, **({} if n is None else {"n": n}))
    _, plan = tk.make_plan(scene, 16, 16, 2, max_depth=5, SB=128,
                           super_group=2)
    args, _ = tk.device_inputs(scene, plan, "cpu")
    out = tk.trace_mega_reference(*args, SEED, plan)
    flat = list(args)
    flat[4] = args[4][:plan.C]
    ref = tk.trace_mega_reference(*flat, SEED, dataclasses.replace(
        plan, sg=0, Cg=0))
    assert torch.equal(out, ref)


def test_batch_votes_with_super_group_is_exact():
    """tests/test_megakernel.py's case: the pair against the default plan
    (kd slot order, interleaved votes) on random_balls_large(n=16) at
    16x16x2, depth 6, SB 64: the same image and segments."""
    scene = make_scene("random_balls_large", 1.0, n=16)
    base = _port(scene, 16, 16, 2, max_depth=6, T=256, SB=64, cull=True)
    both = _port(scene, 16, 16, 2, max_depth=6, T=256, SB=64, cull=True,
                 batch_votes=True, super_group=2)
    assert torch.equal(base.image, both.image)
    assert base.segments.item() == both.segments.item()
    assert base.lane_iters.item() == both.lane_iters.item()


def test_shared_bytes_counts_unions_and_vote_slots():
    """The union rows and the batched votes' slots in shared memory: 6
    words a box, C words a warp, rounded to a float4."""
    _, ts = _scenes("random_balls_large", n=30)
    _, base = tk.make_plan(ts, 16, 16, 2, dyn_order=0)
    _, sg = tk.make_plan(ts, 16, 16, 2, super_group=3)
    _, bv = tk.make_plan(ts, 16, 16, 2, dyn_order=0, batch_votes=True)
    C, warps = base.C, base.T // 32
    stage = warps * 2 * base.SB * 4

    def align4(n):
        return -(-n // 4) * 4

    assert tk.shared_bytes(base) == 4 * (stage + align4(6 * C))
    assert (sg.Cg, tk.shared_bytes(sg)) == (
        3, 4 * (stage + align4(6 * (C + 3))))
    assert tk.shared_bytes(bv) == 4 * (stage + align4(6 * C + C * warps))


# ---- the layout and unroll modes: statistical ----

def test_slots_per_pixel_agrees():
    """k = 2 lanes a pixel, each tracing spp / 2 samples: JAX's atol 0.03
    on the image mean against k = 1 and against the JAX kernel at k = 2."""
    js, ts = _scenes("dielectric")
    _, plan = tk.make_plan(ts, 16, 16, 8, max_depth=8, T=128,
                           slots_per_pixel=2)
    assert (plan.k, plan.spp) == (2, 4)
    a = _port(ts, 16, 16, 8, max_depth=8, T=128).image.numpy() / 8
    b = _port(ts, 16, 16, 8, max_depth=8, T=128,
              slots_per_pixel=2).image.numpy() / 8
    j, _ = mk.trace_mega(KEY, js, 16, 16, 8, max_depth=8, T=128, SB=32,
                         slots_per_pixel=2, interpret=True)
    j = np.asarray(j) / 8
    assert np.isfinite(b).all()
    for ref in (a, j):
        np.testing.assert_allclose(b.mean(axis=(0, 1)),
                                   ref.mean(axis=(0, 1)), atol=0.03)


def test_unroll_overshoot_is_statistically_neutral():
    """U = 4 bounce iterations between a tile's checks: the same streams
    a iteration, so segments only grow; the means agree by JAX's gates
    with U = 1 and with the JAX kernel at U = 4."""
    js, ts = _scenes("dielectric")
    one = _port(ts, 16, 16, 16, max_depth=8, T=128)
    four = _port(ts, 16, 16, 16, max_depth=8, T=128, unroll=4)
    assert four.segments.item() >= one.segments.item()
    assert four.lane_iters.item() > one.lane_iters.item()
    j, _ = mk.trace_mega(KEY, js, 16, 16, 16, max_depth=8, T=128, SB=32,
                         interpret=True, unroll=4)
    bm = four.image.numpy() / 16
    assert np.isfinite(bm).all()
    for ref in (one.image.numpy() / 16, np.asarray(j) / 16):
        assert abs(ref.mean() - bm.mean()) < 0.03
        assert np.abs(_blocks(ref) - _blocks(bm)).max() < 0.2


def test_unroll_checks_every_u_iterations():
    """An overdraw tile stops on a multiple of U iterations; at U = 1 it
    stops as soon as its slowest lane has spp."""
    _, ts = _scenes("dielectric")
    for U in (1, 3):
        _, plan = tk.make_plan(ts, 16, 16, 4, max_depth=8, T=128, unroll=U)
        args, _ = tk.device_inputs(ts, plan, "cpu")
        out = tk.trace_mega_reference(*args, SEED, plan)
        iters = out[:, 4, 0]
        assert bool((iters % U == 0).all())
        assert bool((out[:, 5] >= 4).all())
    assert plan.unroll == 3


def test_coherent_layout_agrees():
    """The binned layout renders the block-linear one's radiance: relative
    mean within 0.05 of it and of the JAX kernel's binned render."""
    js, ts = _scenes("random_balls_large", n=30)
    a = _port(ts, 16, 16, 4, max_depth=4).image.numpy()
    b = _port(ts, 16, 16, 4, max_depth=4, coherent=True).image.numpy()
    j, _ = mk.trace_mega(KEY, js, 16, 16, 4, max_depth=4, T=256,
                         interpret=True, coherent=True)
    assert np.isfinite(b).all()
    for ref in (a, np.asarray(j)):
        assert abs(ref.mean() - b.mean()) / ref.mean() < 0.05


@pytest.mark.parametrize("kw", [dict(slots_per_pixel=2),
                                dict(coherent=True),
                                dict(slots_per_pixel=2, coherent=True)],
                         ids=["k2", "coherent", "k2_coherent"])
def test_epilogue_lands_each_lane_on_its_pixel(kw):
    """The epilogue pixel by pixel, on the plain version's raw output:
    each lane's radiance sums and sample counts scattered to the pixel
    (i, j) of its pixf row (k lanes a pixel, every pixel covered), then
    renormalised to spp samples, equal `_epilogue`'s image bit for bit
    (at k = 2 a pixel's float32 sum of two lanes is the same in either
    order)."""
    nx, ny, spp = 32, 32, 2
    _, ts = _scenes("random_balls_large", n=30)
    _, plan = tk.make_plan(ts, nx, ny, spp, max_depth=4, **kw)
    assert plan.coherent == bool(kw.get("coherent")) and plan.C > 1
    args, inv = tk.device_inputs(ts, plan, "cpu")
    out = tk.trace_mega_reference(*args, SEED, plan).numpy()
    pixf = args[0].numpy()
    valid = pixf[:, 2, :] > 0
    i = pixf[:, 0, :][valid].astype(np.int64)
    j = pixf[:, 1, :][valid].astype(np.int64)
    lanes = np.bincount(j * nx + i, minlength=nx * ny)
    assert (lanes == plan.k).all()
    sums = np.zeros((ny, nx, 3), np.float32)
    dones = np.zeros((ny, nx), np.float32)
    np.add.at(sums, (j, i), out[:, 0:3, :].transpose(0, 2, 1)[valid])
    np.add.at(dones, (j, i), out[:, 5, :][valid])
    scale = np.float32(plan.spp * plan.k) / np.maximum(dones, 1.0)
    got = tk._epilogue(torch.from_numpy(out), inv, plan).image.numpy()
    assert np.array_equal(got, sums * scale[..., None])
    assert (dones >= spp).all()


# ---- refusals ----

@pytest.mark.parametrize("kw,match", [
    (dict(exact=True, slots_per_pixel=2), "exact mode"),
    (dict(exact=True, unroll=2), "exact mode"),
    (dict(exact=True, super_group=2), "exact mode"),
    (dict(super_group=2, dyn_order=16), "dyn_order"),
    (dict(super_group=2, cull=False), "culled plan"),
    (dict(batch_votes=True, cull=False), "culled plan"),
    (dict(slots_per_pixel=3), "divide"),
    (dict(unroll=0), "unroll")])
def test_plan_mode_refusals(kw, match):
    _, ts = _scenes("random_balls_large", n=30)
    with pytest.raises(ValueError, match=match):
        tk.make_plan(ts, 16, 16, 4, **kw)


def test_plan_mode_rules():
    """JAX's rules: k = 1 where T % k; super-groups need C > 1; batched
    votes are off where near-to-far order is on; the auto order is
    ascending with super-groups; the defaults are today's plan."""
    _, ts = _scenes("random_balls_large", n=30)
    _, one = _scenes("dielectric")
    _, plan = tk.make_plan(one, 16, 16, 8, T=100, slots_per_pixel=8)
    assert (plan.k, plan.spp) == (1, 8)
    _, plan = tk.make_plan(ts, 16, 16, 4, batch_votes=True)
    assert plan.dyn_order == 16 and not plan.batch_votes
    _, plan = tk.make_plan(ts, 16, 16, 4, super_group=4)
    assert plan.dyn_order == 0 and (plan.sg, plan.Cg) == (4, 2)
    with pytest.raises(ValueError, match="C > 1"):
        tk.make_plan(one, 16, 16, 4, super_group=2, cull=True)
    _, plan = tk.make_plan(ts, 16, 16, 4)
    assert (plan.k, plan.coherent, plan.sg, plan.Cg, plan.batch_votes,
            plan.unroll) == (1, False, 0, 0, False, 1)


# ---- the tools ----

def _rows(capsys):
    return [json.loads(x) for x in capsys.readouterr().out.splitlines()
            if x.startswith("{")]


def test_coherence_sweep_rows(capsys, monkeypatch, tmp_path):
    monkeypatch.chdir(tmp_path)
    tiny = ["--nx", "16", "--ny", "16", "--spp", "2", "--max-depth", "3",
            "--launches", "1"]
    assert coherence_sweep.main(CPU + tiny + ["--scenes",
                                              "random_balls_large"]) == 0
    rows = _rows(capsys)
    assert [r["coherent"] for r in rows] == list(coherence_sweep.TURNS)
    assert [r["turn"] for r in rows] == [0, 1, 2, 3]
    assert os.listdir(tmp_path) == []
    for r in rows:
        assert r["device"] == "cpu (plain version)" and r["C"] == 29
        assert 0 < r["lane_survival"] <= r["warp_survival"] <= 1
        assert 0 < r["util"] <= 1 and r["m_seg_per_s"] > 0
        # the timed launch of mega_perf's series: seed launch_seed(0, 0)
        assert r["segments"] == tk.trace_mega(
            launch_seed(0, 0), make_scene("random_balls_large", 1.0), 16,
            16, 2, max_depth=3, device="cpu",
            coherent=r["coherent"]).segments.item()
    assert rows[0]["segments"] == rows[3]["segments"]
    assert rows[1]["segments"] == rows[2]["segments"]
    out = tmp_path / "rows.jsonl"
    coherence_sweep.main(CPU + tiny + ["--scenes", "large_mixed", "--json",
                                       str(out)])
    assert len(out.read_text().splitlines()) == 4
    with pytest.raises(SystemExit, match="unknown scene"):
        coherence_sweep.main(CPU + ["--scenes", "cornell_box"])


def test_export_texture_raw_round_trip(tmp_path):
    """The oracle's texels through a PNG back to the oracle's bytes."""
    png = str(tmp_path / "earth.png")
    image_mod.write_png(image_mod.load_image(RTWI), png)
    out = str(tmp_path / "earth.rtwi")
    assert export_texture_raw.main([out, "--image", png]) == 0
    with open(out, "rb") as f, open(RTWI, "rb") as g:
        assert f.read() == g.read()


def test_export_texture_raw_refuses_the_stand_in(tmp_path, monkeypatch):
    monkeypatch.setattr(export_texture_raw, "earth_texture_path",
                        lambda image_path=None: None)
    out = tmp_path / "x.rtwi"
    with pytest.raises(SystemExit, match="stand-in"):
        export_texture_raw.main([str(out)])
    assert not out.exists()


@pytest.mark.parametrize("flags,kw", [
    (["--sg", "4"], dict(super_group=4)),
    (["--bv", "1", "--dord", "0"], dict(batch_votes=True, dyn_order=0)),
    (["--unroll", "4", "--k", "2", "--coherent", "1"],
     dict(unroll=4, slots_per_pixel=2, coherent=True))])
def test_mega_perf_mode_flags(capsys, monkeypatch, tmp_path, flags, kw):
    monkeypatch.chdir(tmp_path)
    assert mega_perf.main(CPU + ["--scene", "random_balls_large", "--nx",
                                 "16", "--ny", "16", "--spp", "2",
                                 "--max-depth", "3", "--launches", "1",
                                 "--stats"] + flags) == 0
    (row,) = _rows(capsys)
    _, plan = tk.make_plan(make_scene("random_balls_large", 1.0), 16, 16, 2,
                           max_depth=3, **kw)
    assert {k: row[k] for k, _ in mega_perf.MODES if k in row} \
        == mega_perf.plan_modes(plan)
    assert mega_perf.plan_modes(plan)
    assert row["segments"] == tk.trace_mega(
        launch_seed(0, 0), make_scene("random_balls_large", 1.0), 16, 16, 2,
        max_depth=3, device="cpu", **kw).segments.item()
    assert os.listdir(tmp_path) == []
