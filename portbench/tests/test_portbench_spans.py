"""The readers of the program's spans and overdraw counter
(`portbench/spans.py`, `metrics/host_*_ms.py`, `kernel_start_lag_us.py`,
`overdraw_share.py`, `idle_explained_share.py`) on a synthetic window and
synthetic spans, with answers computed by hand."""
import types

import pytest
from conftest import ROOT

from portbench import adapter, harness, spans
from portbench import trace as trace_mod

K23 = "void mega_kernel_surfaces<0, false, 3>(Params)"
DTOH = "Memcpy DtoH (Device -> Pinned)"


def _window(late=0):
    """Two launches: megakernels at 1000-5000 and 9000-12900 ns, each
    followed by its segment read's copy (a reduce between), whose
    synchronisation returns 10 ns after the copy ends, the image's
    synchronisation last (the window: 500-13100); the card's clock `late`
    ns behind the host's in launch 1."""
    runtime = [("cudaStreamSynchronize", 5100, 5230),
               ("cudaStreamSynchronize", 12000, 12930),
               ("cudaDeviceSynchronize", 13000, 13100)]
    return trace_mod.Window(
        device=[(K23, 1000, 5000), ("reduce_kernel", 5100, 5200),
                (DTOH, 5210, 5220), (K23, 9000 - late, 12900 - late),
                (DTOH, 12910 - late, 12920 - late)],
        host=sorted([("aten::zeros", 500, 600)] + runtime,
                    key=lambda e: e[1]),
        runtime=runtime)


def _launch(t, skip, seed, plan, prep, call, epi, end, me, n):
    """The spans of launch `n` from time `t`, as the program records them
    (name, start, end, parent index, image, launch): the launch's own span
    (index `me`, its parent the image's root at index 2), then its steps
    from `t + skip` on, each after the last, the wait to `end`."""
    rows = [("loop.launch", t, end, 2, 1, n)]
    at = t + skip
    for name, d in (("loop.key", 10), ("loop.seed", seed),
                    ("plan.make", plan), ("plan.inputs", 50),
                    ("kernel.prepare", prep), ("kernel.launch", call),
                    ("epilogue.enqueue", epi), ("loop.accumulate", 10)):
        rows.append((name, at, at + d, me, 1, n))
        at += d
    rows.append(("loop.wait", at, end, me, 1, n))
    return rows


def _recorded():
    """An earlier session's image (wholly before the window), then one
    image of two launches that opens 98 ns before the window's first
    event; launch 1's steps start 200 ns into its span."""
    old = [("render", 10, 100, -1, 0, -1), ("loop.seed", 20, 90, 0, 0, 0)]
    img = [("render", 402, 13050, -1, 1, -1),
           ("render.start", 402, 700, 2, 1, -1)]
    img += _launch(700, 0, 80, 50, 50, 40, 110, 5300, 4, 0)
    img += _launch(5300, 200, 1600, 400, 600, 100, 300, 13000, 14, 1)
    img.append(("render.finish", 13000, 13040, 2, 1, -1))
    return old + img


@pytest.fixture
def ctx(monkeypatch):
    recorded = _recorded()
    fake = types.SimpleNamespace(take=lambda: list(recorded))
    monkeypatch.setattr(adapter._render, "spans", fake, raising=False)
    monkeypatch.setattr(adapter._mk, "take_overdraw",
                        lambda: (1200.0, 1000.0), raising=False)
    return {"window": _window(), "patterns": trace_mod}


def _read(name, ctx):
    return harness.metric_reader(name, ROOT / "portbench")(ctx)


def test_spans_outside_the_window_are_ignored(ctx):
    rec = spans.record(ctx)
    assert [s[0] for s in rec.spans[:2]] == ["render", "render.start"]
    assert rec.spans[0][1] == 402 and rec.launches() == 2
    assert all(s[4] == 1 for s in rec.spans)
    # parents re-indexed past the two spans left out
    assert rec.spans[1][3] == 0 and rec.spans[3][3] == 2
    # self time: the root less render.start, its launches and finish
    assert rec.self_ns[0] == (13050 - 402) - 298 - 4600 - 7700 - 40
    assert spans.record(ctx) is rec       # taken once a run


@pytest.mark.parametrize("name,value", [
    ("host_seed_ms.p95", ((10 + 80) + (10 + 1600)) / 2 * 1e-6),
    ("host_plan_ms.rate", ((50 + 50) + (400 + 50)) / 2 * 1e-6),
    ("host_enqueue_ms.p95", ((50 + 40 + 110 + 10)
                             + (600 + 100 + 300 + 10)) / 2 * 1e-6),
    # launch 0's call starts at 940 (host), its kernel 60 ns later;
    # launch 1's call at 8160, its kernel 840 later (not launch 0's, which
    # also starts after launch 0's call returned); each high by the 10 ns
    # its read's synchronisation took to return
    ("kernel_start_lag_us.rate", ((60 + 10) + (840 + 10)) / 2 * 1e-3),
    ("overdraw_share.p95", 200 / 1200),
])
def test_readers_on_hand_computed_values(ctx, name, value):
    assert _read(name, ctx) == pytest.approx(value)


def test_idle_explained_share_counts_leaf_spans_only(ctx):
    # on the host's clock (+10 ns): idle 5010-5110 and 5210-5220 (launch
    # 0's wait covers them), 5230-9010 (launch 0's wait to 5300, launch
    # 1's span alone 5300-5500, its steps from 5500) and 12910-12920
    # (launch 1's wait)
    assert _read("idle_explained_share.rate", ctx) == pytest.approx(
        (100 + 10 + 3580 + 10) / (100 + 10 + 3780 + 10))


@pytest.mark.parametrize("late", [1000, -2000])
def test_lags_and_idle_hold_when_the_cards_clock_drifts(ctx, late):
    """The card's timeline off by `late` ns in launch 1 (the profiler's
    device clock drifts from its host clock): the lags, set by each
    launch's own read, do not move, and the idle still lies in the host's
    steps (the gap before launch 1 is `late` ns shorter on the card)."""
    lag = _read("kernel_start_lag_us.p95", ctx)
    ctx = dict(ctx, window=_window(late))
    ctx.pop(spans.KEY)
    assert _read("kernel_start_lag_us.p95", ctx) == pytest.approx(lag)
    rec = spans.record(ctx)
    launches = spans.launches_on_card(rec, ctx["window"], trace_mod.MEGA)
    assert spans.start_lags_ns(launches) == [70, 850]
    assert _read("idle_explained_share.p95", ctx) == pytest.approx(
        (100 + 10 + 3580 - late + 10) / (100 + 10 + 3780 - late + 10))


def test_a_gap_half_covered_by_a_leaf_reads_half(monkeypatch):
    recorded = [("render", 0, 3000, -1, 1, -1),
                ("loop.launch", 0, 3000, 0, 1, 0),
                ("loop.seed", 1000, 1500, 1, 1, 0)]
    monkeypatch.setattr(adapter._render, "spans",
                        types.SimpleNamespace(take=lambda: recorded),
                        raising=False)
    win = trace_mod.Window(device=[("k", 0, 1000), ("k", 2000, 3000)])
    ctx = {"window": win, "patterns": trace_mod}
    assert _read("idle_explained_share.p95", ctx) == pytest.approx(0.5)


def test_a_lag_is_against_the_launchs_own_megakernel_and_read():
    rec = spans.Record(spans=[("loop.launch", 90, 950, -1, 1, 0),
                              ("kernel.launch", 100, 130, 0, 1, 0),
                              ("loop.wait", 130, 850, 0, 1, 0),
                              ("loop.launch", 900, 2000, -1, 1, 1),
                              ("kernel.launch", 900, 920, 3, 1, 1),
                              ("loop.wait", 920, 1900, 3, 1, 1)],
                       self_ns=[0] * 6, overdraw=None)
    # the card's clock 300 ns ahead of the host's: launch 1's kernel
    # seems to start before its call, its read after its wait ended
    dev = [(K23, 500, 800), (DTOH, 810, 820), (K23, 1295, 1990),
           (DTOH, 1995, 2000), ("reduce_kernel", 2010, 2020)]
    # no synchronisation recorded: each read ends with its wait
    win = trace_mod.Window(device=dev)
    launches = spans.launches_on_card(rec, win, trace_mod.MEGA)
    assert launches == [(100, 850, 500, 820), (900, 1900, 1295, 2000)]
    assert spans.start_lags_ns(launches) == [(850 - 100) - (820 - 500),
                                             (1900 - 900) - (2000 - 1295)]
    shift = spans.to_host(launches)
    # the nearest read: 1000 is nearer 820, 1500 nearer 2000
    assert [shift(t) for t in (0, 820, 1000, 1500, 2010)] == [
        30, 850, 1030, 1400, 1910]
    # the last synchronisation that returns inside a wait ends its read;
    # one that outlasts the wait does not
    win = trace_mod.Window(device=dev, runtime=[
        ("cudaStreamSynchronize", 700, 840),
        ("cudaStreamSynchronize", 1000, 1700),
        ("cudaDeviceSynchronize", 1800, 1950)])
    launches = spans.launches_on_card(rec, win, trace_mod.MEGA)
    assert [r for _, r, _, _ in launches] == [840, 1700]
    # a launch whose read is not in the window has no lag
    assert spans.launches_on_card(rec, trace_mod.Window(device=dev[:3]),
                                  trace_mod.MEGA) == [(100, 850, 500, 820)]
    assert spans.to_host([])(7) == 7


def test_a_program_without_spans_gives_nothing(monkeypatch):
    monkeypatch.delattr(adapter._render, "spans")
    monkeypatch.delattr(adapter._mk, "take_overdraw")
    ctx = {"window": _window(), "patterns": trace_mod}
    for name in ("host_seed_ms.rate", "host_plan_ms.p95",
                 "host_enqueue_ms.rate", "kernel_start_lag_us.p95",
                 "overdraw_share.rate", "idle_explained_share.p95"):
        assert _read(name, ctx) is None
