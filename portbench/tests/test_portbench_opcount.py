"""The operation count recomputed by hand from the plans' S, R and
motion axes, and the metric readers on a synthetic trace."""
import pytest

from portbench import opcount, trace
from portbench.reference import megakernel as rmk
from portbench.reference import scenes as rscenes


def _plan(name, nx, ny):
    return rmk.make_plan(rscenes.make_scene(name, nx / ny), nx, ny, 64,
                         max_depth=50)[1]


def test_random_balls_count_by_hand():
    plan = _plan("random_balls", 1200, 800)
    # 488 slots (485 spheres padded to 8), centres moving along y alone
    # under one shutter window: 20 + 2 operations a slot
    assert plan.S == 488 and plan.moving_axes == (False, True, False)
    assert plan.uniform_time and not plan.surfaces and not plan.cull
    assert opcount.ops_per_segment(plan) == 32 + 488 * 22


def test_cornell_box_count_by_hand():
    plan = _plan("cornell_box", 400, 400)
    # one static sphere slot group (the glass ball), 12 live rects: the
    # light, five walls and the tall box's six faces in one rotated and
    # translated transform group
    assert plan.surfaces and not any(plan.moving_axes) and plan.V == 0
    assert plan.R == 12
    groups = {c >> 4: (c >> 2) & 3 for c in plan.rect_codes}
    assert sorted(groups.values()) == [0, 3]
    expect = 32 + plan.S * 20 + 3 + 12 * 6 + 17
    assert opcount.ops_per_segment(plan) == expect


def test_least_time_takes_the_larger_bound():
    t, b = opcount.least_seconds(67e12, 1.0)
    assert (t, b) == (pytest.approx(1.0), "fp32")
    t, b = opcount.least_seconds(1.0, 3.35e12 * 2)
    assert (t, b) == (pytest.approx(2.0), "hbm")


def _window():
    w = trace.Window()
    ns = 1_000_000
    # two launches of K1, each after a segment read, and one other kernel
    w.device = [("void mega_kernel<2, true>(Params)", 10 * ns, 90 * ns),
                ("elementwise_kernel", 91 * ns, 92 * ns),
                ("void mega_kernel<2, true>(Params)", 100 * ns, 180 * ns),
                ("reduce_kernel", 181 * ns, 182 * ns)]
    w.runtime = [("cudaStreamSynchronize", 6 * ns, 9 * ns),
                 ("cudaStreamSynchronize", 93 * ns, 95 * ns),
                 ("cudaStreamSynchronize", 96 * ns, 96 * ns + 10),
                 ("cudaLaunchKernel", 99 * ns, 99 * ns + 1000)]
    # after the segment read (92-95 ms) the host reads a CPU tensor and
    # copies an index to the card (a synchronisation of its own): neither
    # ends the launch
    w.host = sorted([("aten::_local_scalar_dense", 5 * ns, 9 * ns),
                     ("aten::_local_scalar_dense", 92 * ns, 95 * ns),
                     ("aten::_local_scalar_dense", 97 * ns, 98 * ns),
                     ("aten::copy_", 96 * ns, 96 * ns + 20),
                     *w.runtime], key=lambda t: t[1])
    return w


def test_window_reduction():
    w = _window()
    assert w.kernel_seconds(trace.K1) == pytest.approx(0.160)
    assert w.kernel_count(trace.K1) == 2
    assert w.kernel_count(trace.K23) == 0
    assert w.other_seconds(trace.MEGA) == pytest.approx(0.002)
    assert w.busy_seconds() == pytest.approx(0.162)
    # the second launch starts 5 ms after the segment read's wait ended
    assert w.host_gaps_before(trace.K1) == [pytest.approx(0.005)]
    gaps = w.idle_gaps(2)
    assert gaps[0] == ["aten::_local_scalar_dense", pytest.approx(0.008)]
    assert w.top_device_ops(1)[0][0].startswith("void mega_kernel<")


def test_readers_on_a_synthetic_window():
    from portbench import harness
    plan = _plan("random_balls", 1200, 800)
    ctx = {"window": _window(), "window_s": 0.2, "images": 1,
           "pixel_samples": 10, "launches": 2, "segments": 1e9,
           "plan": plan, "n_tiles": 3750, "table_bytes": 1000,
           "opcount": opcount, "patterns": trace}
    read = {m.split(".")[0]: harness.metric_reader(m)(ctx) for m in (
        "k1_roofline", "k23_roofline", "step_mfu.rate", "segments_per_s.p95",
        "epilogue_device_ms.rate", "host_ms_per_launch.p95",
        "device_idle_share")}
    ops = (32 + 488 * 22) * 1e9
    assert read["k1_roofline"] == pytest.approx(100 * ops / 67e12 / 0.160)
    assert read["k23_roofline"] is None
    assert read["step_mfu"] == pytest.approx(100 * ops / 67e12 / 0.2)
    assert read["segments_per_s"] == pytest.approx(5000.0)
    assert read["epilogue_device_ms"] == pytest.approx(1.0)
    assert read["host_ms_per_launch"] == pytest.approx(5.0)
    assert read["device_idle_share"] == pytest.approx(1 - 0.162 / 0.2)


class _Event:
    def __init__(self, name, start, dur, dev):
        self._v = (name, start, dur, dev)

    def name(self):
        return self._v[0]

    def start_ns(self):
        return self._v[1]

    def duration_ns(self):
        return self._v[2]

    def device_type(self):
        return self._v[3]


def test_profiler_events_classified_by_device_and_name():
    """Kineto events as torch versions without `activity_type` give
    them: the card's by device type, CUDA API calls by name."""
    class Prof:
        class profiler:
            class kineto_results:
                @staticmethod
                def events():
                    return [_Event("void mega_kernel<2, true>(Params)", 50,
                                   40, "DeviceType.CUDA"),
                            _Event("cudaStreamSynchronize", 20, 5,
                                   "DeviceType.CPU"),
                            _Event("aten::_local_scalar_dense", 10, 16,
                                   "DeviceType.CPU"),
                            _Event("cuLaunchKernel", 40, 2,
                                   "DeviceType.CPU")]
    w = trace.from_profiler(Prof)
    assert [n for n, _, _ in w.device] == [
        "void mega_kernel<2, true>(Params)"]
    assert [n for n, _, _ in w.runtime] == ["cudaStreamSynchronize",
                                            "cuLaunchKernel"]
    assert [n for n, _, _ in w.host] == ["aten::_local_scalar_dense",
                                         "cudaStreamSynchronize",
                                         "cuLaunchKernel"]


def test_host_gap_counts_from_the_previous_image_end():
    ns = 1_000_000
    w = trace.Window()
    w.device = [("void mega_kernel_surfaces<0, false, 3>(P)", 1 * ns,
                 4 * ns),
                ("void mega_kernel_surfaces<0, false, 3>(P)", 9 * ns,
                 12 * ns)]
    w.runtime = [("cudaDeviceSynchronize", 4 * ns, 5 * ns)]
    w.host = list(w.runtime)
    assert w.host_gaps_before(trace.K23) == [pytest.approx(0.004)]
