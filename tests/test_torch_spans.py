"""The render path's host spans (utils/spans.py) and the overdraw counter
(ops/megakernel.py OVERDRAW), on the CPU through the plain version: what
a render records under torch.profiler, how the spans nest, that they
share the profiler's clock, that nothing is recorded or changed without
a profiler, and the `--profile` export."""
import json

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from torch.profiler import ProfilerActivity, profile  # noqa: E402

from raytracingweekend_tpu_torch import render as trender  # noqa: E402
from raytracingweekend_tpu_torch.models.scenes import make_scene  # noqa: E402
from raytracingweekend_tpu_torch.ops import megakernel as mk  # noqa: E402
from raytracingweekend_tpu_torch.utils import spans  # noqa: E402
from raytracingweekend_tpu_torch.utils.config import RenderConfig  # noqa: E402

NX, NY, SPP, SPL = 16, 12, 2, 1
# the spans of a `mega` launch through the plain version (the CUDA path
# adds kernel.prepare, and epilogue.order on the dense surfaces kernels)
LAUNCH_LEAVES = ("loop.key", "loop.seed", "plan.make", "plan.inputs",
                 "kernel.launch", "epilogue.enqueue", "loop.accumulate",
                 "loop.wait")
IMAGE_SPANS = ("render", "render.start", "loop.launch", "render.finish")


def _cfg(seed=5):
    return RenderConfig(nx=NX, ny=NY, spp=SPP, max_depth=4, seed=seed,
                        samples_per_launch=SPL, loop_mode="mega",
                        device="cpu")


@pytest.fixture(scope="module")
def traced():
    """Two renders of a fresh scene under one CPU profiler session: the
    spans, the profiler's CPU events (name, start ns, end ns) and the
    canvases."""
    scene = make_scene("cornell_box", NX / NY)
    spans.take()
    mk.take_overdraw()
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        imgs = [trender.render(scene, _cfg()), trender.render(scene, _cfg())]
    rec = spans.take()
    events = [(e.name(), e.start_ns(), e.start_ns() + e.duration_ns())
              for e in prof.profiler.kineto_results.events()]
    return {"scene": scene, "spans": rec, "events": events, "images": imgs,
            "overdraw": mk.take_overdraw()}


def _children(rec, i):
    return [s for s in rec if s.parent == i]


def test_render_records_every_span_of_the_mega_path(traced):
    rec = traced["spans"]
    names = {s.name for s in rec}
    assert set(IMAGE_SPANS + LAUNCH_LEAVES) <= names
    # a fresh scene builds its tables and layout once, on the first launch
    tables = [s for s in rec if s.name == "plan.tables"]
    assert tables and {s.image for s in tables} == {rec[0].image}
    assert {s.launch for s in tables} == {0}
    assert all(s.end >= s.start > 0 for s in rec)


@pytest.mark.parametrize("level", ["leaf_in_launch", "launch_in_render"])
def test_spans_nest_inside_their_parents(traced, level):
    rec = traced["spans"]
    inner = (LAUNCH_LEAVES if level == "leaf_in_launch"
             else ("loop.launch",))
    outer = "loop.launch" if level == "leaf_in_launch" else "render"
    checked = 0
    for s in rec:
        if s.name not in inner:
            continue
        p = rec[s.parent]
        assert p.name == outer
        assert p.start <= s.start <= s.end <= p.end
        assert s.image == p.image
        if level == "leaf_in_launch":
            assert s.launch == p.launch >= 0
        checked += 1
    assert checked


def test_one_launch_span_a_launch_and_distinct_images(traced):
    rec = traced["spans"]
    roots = [i for i, s in enumerate(rec) if s.name == "render"]
    assert len(roots) == 2 and all(rec[i].parent == -1 for i in roots)
    assert rec[roots[0]].image != rec[roots[1]].image
    for i in roots:
        launches = [s for s in _children(rec, i) if s.name == "loop.launch"]
        assert [s.launch for s in launches] == list(range(SPP // SPL))
        for j, s in enumerate(rec):
            if s.name == "loop.launch" and s.parent == i:
                kids = [k.name for k in _children(rec, j)]
                assert all(kids.count(n) == 1 for n in LAUNCH_LEAVES), kids


def test_seed_span_holds_no_operator_on_the_profilers_clock(traced):
    """`launch_seed` is scalar host arithmetic: alone it gives no profiler
    event, and each loop.seed span of the render holds none and no event
    crosses its edges."""
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        trender.launch_seed(5, 0)
    alone = [e.name() for e in prof.profiler.kineto_results.events()]
    spans.take()
    assert alone == []
    seeds = [s for s in traced["spans"] if s.name == "loop.seed"]
    assert len(seeds) == 2 * SPP // SPL
    for s in seeds:
        inside = [e for e in traced["events"]
                  if s.start <= e[1] and e[2] <= s.end]
        crossing = [e for e in traced["events"]
                    if e[1] < s.start < e[2] or e[1] < s.end < e[2]]
        assert not inside and not crossing, (inside, crossing)


def test_nothing_recorded_without_a_profiler_and_same_canvas(traced):
    spans.take()
    asked = mk.OVERDRAW["asked"]
    img = trender.render(traced["scene"], _cfg())
    assert spans.take() == []
    assert mk.OVERDRAW["asked"] == asked and not mk.OVERDRAW["done"]
    assert torch.equal(img, traced["images"][0])
    assert torch.equal(traced["images"][0], traced["images"][1])


def test_render_counts_overdraw_while_recording(traced):
    done, asked = traced["overdraw"]
    n_tiles = -(-NX * NY // 256)
    assert asked == 2 * (SPP // SPL) * n_tiles * 256 * SPL
    assert done >= asked


@pytest.mark.parametrize("k", [1, 2])
def test_overdraw_totals_equal_row_5_summed_by_hand(k):
    scene = make_scene("cornell_box", 1.0)
    _, plan = mk.make_plan(scene, 8, 8, 4, max_depth=4, T=64,
                           slots_per_pixel=k)
    args, inv = mk.device_inputs(scene, plan, "cpu")
    out = mk._mega_call(*args, 1234, plan)
    mk.take_overdraw()
    mk._epilogue(out, inv, plan)              # not recording: not counted
    assert mk.take_overdraw() == (0.0, 0.0)
    with profile(activities=[ProfilerActivity.CPU]):
        mk._epilogue(out, inv, plan)
        mk._epilogue(out, inv, plan)
    spans.take()
    rows = out[:, 5, :].numpy().astype(np.float64)
    by_hand = sum(float(v) for v in rows.ravel())
    n_tiles, _, T = out.shape
    assert mk.take_overdraw() == (2 * by_hand, 2.0 * n_tiles * T * plan.spp)
    assert by_hand > n_tiles * T * plan.spp     # the tiles overdraw


def test_recorded_spans_leave_the_garbage_collector_nothing_to_walk():
    import gc
    spans.take()
    with profile(activities=[ProfilerActivity.CPU]):
        gc.collect()
        before = len(gc.get_objects())
        for i in range(2000):
            with spans.span("loop.launch", launch=i):
                with spans.span("loop.seed"):
                    pass
        after = len(gc.get_objects())
    assert len(spans.take()) == 4000
    assert after - before < 100


def test_span_sites_do_nothing_when_off():
    spans.take()
    with spans.span("a", image=3):
        with spans.span("b", launch=1):
            pass
    assert spans.take() == []
    assert not spans.recording()


def test_profile_option_writes_the_spans_into_the_trace(tmp_path):
    trender.main(["--scene", "cornell_box", "--nx", "8", "--ny", "8",
                  "--spp", "2", "--samples-per-launch", "1",
                  "--max-depth", "3", "--mode", "mega", "--device", "cpu",
                  "--out", str(tmp_path / "c.png"),
                  "--profile", str(tmp_path / "prof")])
    trace = json.loads((tmp_path / "prof" / "trace.json").read_text())
    evs = trace["traceEvents"]
    mine = [e for e in evs if e.get("pid") == "render spans"
            and e["ph"] == "X"]
    names = {e["name"] for e in mine}
    assert set(IMAGE_SPANS + LAUNCH_LEAVES) <= names
    assert len([e for e in mine if e["name"] == "loop.launch"]) == 2
    # on the trace's clock: the profiler's events of the render lie within
    # the render span
    root = next(e for e in mine if e["name"] == "render")
    ops = [e for e in evs if e.get("cat") == "cpu_op"
           and e["name"] == "aten::zeros"]
    assert ops and any(root["ts"] <= e["ts"] <= root["ts"] + root["dur"]
                       for e in ops)
    assert spans.take() == []
