"""The program's own record of a traced window: the host spans that
`render()` and the megakernel's launch record while the profiler runs
(`raytracingweekend_tpu_torch/utils/spans.py`) and the overdraw counter
(`ops/megakernel.py`'s OVERDRAW), reached through the adapter's modules.

The spans are on the clock of the profiler's host events
(`time.time_ns()`), so they are cut to the window by its events with no
calibration: a span is kept if it overlaps the interval from the
window's first event to its last (an image's root span opens before the
image's first operator). The profiler's device events are on the card's
clock as the profiler maps it to the host's, which can drift from the
host's by a millisecond within a window; readers that set a span against
a device event map the card's clock to the host's at each launch's own
segment read (`launches_on_card`, `start_lags_ns`, `to_host`).

Both are taken from the program once a run, by the first reader that
asks, and kept in the run's context for the others. A program that
records neither (an older checkout) gives None, and its readers report
nothing.
"""
from __future__ import annotations

import bisect
import re
from dataclasses import dataclass

from . import adapter

# spans that only enclose other spans: an image and one of its launches
CONTAINERS = ("render", "loop.launch")
# the copies of device-to-host reads (the render loop's segment read),
# and the runtime calls that wait for them
DTOH = re.compile(r"Memcpy DtoH")
SYNC = re.compile(r"Synchronize")
KEY = "program_record"


@dataclass
class Record:
    """`spans`: the program's spans inside the window, in start order
    (name, start, end, parent, image, launch; ns; a parent outside the
    window reads -1); `self_ns`: each span's duration less its children's;
    `overdraw`: (samples completed, samples asked for), or None."""
    spans: list
    self_ns: list
    overdraw: tuple | None

    def launches(self) -> int:
        return sum(1 for s in self.spans if s[0] == "loop.launch")

    def total_ns(self, names=(), prefixes=()) -> int:
        """Summed durations of the spans named `names` or starting with
        one of `prefixes`."""
        return sum(s[2] - s[1] for s in self.spans
                   if s[0] in names or s[0].startswith(tuple(prefixes)))

    def per_launch_ms(self, names=(), prefixes=()):
        n = self.launches()
        if n == 0:
            return None
        return self.total_ns(names, prefixes) / n * 1e-6

    def leaf_intervals(self) -> list:
        """The union of the intervals of every span but the containers,
        merged, as [start, end] pairs in order."""
        out = []
        for s in sorted((s for s in self.spans if s[0] not in CONTAINERS),
                        key=lambda s: s[1]):
            if out and s[1] <= out[-1][1]:
                out[-1][1] = max(out[-1][1], s[2])
            else:
                out.append([s[1], s[2]])
        return out


def _window_bounds(win):
    starts = [e[1] for lst in (win.device, win.host) for e in lst]
    ends = [e[2] for lst in (win.device, win.host) for e in lst]
    if not starts:
        return None
    return min(starts), max(ends)


def cut(recorded: list, lo: int, hi: int) -> tuple:
    """The spans of `recorded` (the program's, in the order they opened)
    that overlap [lo, hi], their parents re-indexed, and each one's self
    time."""
    keep = [i for i, s in enumerate(recorded)
            if s[2] >= lo and s[1] <= hi]
    index = {old: new for new, old in enumerate(keep)}
    spans = [(s[0], s[1], s[2], index.get(s[3], -1), s[4], s[5])
             for s in (recorded[i] for i in keep)]
    self_ns = [s[2] - s[1] for s in spans]
    for s in spans:
        if s[3] >= 0:
            self_ns[s[3]] -= s[2] - s[1]
    return spans, self_ns


def record(ctx) -> Record | None:
    """The program's record of the run whose context is `ctx`, cut to
    ctx["window"]; None where the program records no spans."""
    if KEY in ctx:
        return ctx[KEY]
    rec = None
    spans_mod = getattr(adapter._render, "spans", None)
    bounds = _window_bounds(ctx["window"])
    if spans_mod is not None and hasattr(spans_mod, "take") and bounds:
        spans, self_ns = cut(spans_mod.take(), *bounds)
        take = getattr(adapter._mk, "take_overdraw", None)
        rec = Record(spans, self_ns, take() if take else None)
    ctx[KEY] = rec
    return rec


def launches_on_card(rec: Record, win, pattern) -> list:
    """Each launch of the window `win`, in order, as (its call's start,
    the end of its segment read) on the host's clock and (its
    megakernel's start, the end of the read's copy) on the card's: the
    i-th `kernel.launch` span with the i-th device event matching
    `pattern` (the render loop waits for every launch inside the window),
    and the first device-to-host copy after the kernel starts. The read
    ends on the host when the last runtime synchronisation inside the
    launch's `loop.wait` span returns (the runtime's calls are on the
    host's clock), or, with none recorded, when the span ends. A launch
    without a wait or a copy is left out."""
    syncs = [(s, e) for n, s, e in win.runtime if SYNC.search(n)]
    ends = {}
    for s in rec.spans:
        if s[0] == "loop.wait":
            i = bisect.bisect_right(syncs, (s[2], s[2])) - 1
            while i >= 0 and syncs[i][1] > s[2]:
                i -= 1
            ends[s[3]] = (syncs[i][1] if i >= 0 and syncs[i][0] >= s[1]
                          else s[2])
    calls = sorted((s[1], ends.get(s[3])) for s in rec.spans
                   if s[0] == "kernel.launch")
    kern = [s for n, s, _ in win.device if pattern.search(n)]
    copies = [(s, e) for n, s, e in win.device if DTOH.search(n)]
    out = []
    for (c, r), k in zip(calls, kern):
        j = bisect.bisect_left(copies, (k, 0))
        if r is not None and j < len(copies):
            out.append((c, r, k, copies[j][1]))
    return out


def start_lags_ns(launches: list) -> list:
    """For each launch of `launches_on_card`: its megakernel's start on
    the card less its call's start on the host, in ns, with the card's
    clock set to the host's at the launch's own segment read: the host's
    time from the call to the read's end less the card's from the
    kernel's start to the read's copy end. Each clock then measures only
    an interval of its own (the profiler's device timeline drifts from its
    host timeline by up to ~1 ms within a window); the lag is high by the
    time the synchronisation takes to return after the copy."""
    return [(r - c) - (e - k) for c, r, k, e in launches]


def to_host(launches: list):
    """A function from the card's clock to the host's: a time plus the
    host's clock less the card's at the segment read nearest to it on the
    card, as `start_lags_ns` sets them; the identity where no launch was
    read."""
    at = [e for _, _, _, e in launches]
    off = [w - e for _, w, _, e in launches]

    def shift(t):
        if not at:
            return t
        i = bisect.bisect_right(at, t)
        if i == len(at) or (i and t - at[i - 1] <= at[i] - t):
            i -= 1
        return t + off[i]
    return shift


def covered_ns(gaps: list, intervals: list) -> int:
    """The ns of the (start, end) `gaps` that the merged, ordered
    `intervals` cover."""
    out, j = 0, 0
    for g0, g1 in gaps:
        while j < len(intervals) and intervals[j][1] <= g0:
            j += 1
        k = j
        while k < len(intervals) and intervals[k][0] < g1:
            out += min(g1, intervals[k][1]) - max(g0, intervals[k][0])
            k += 1
    return out
