"""The share of the device's idle time between its busy intervals that
lies inside one of the program's step spans (every span but `render` and
`loop.launch`), on the host's clock as each launch's segment read sets it
(`portbench/spans.py::to_host`): idle the program's own host steps
explain. The rest is the caller's time between images and the program's
time outside any step."""
from portbench import spans


def read(ctx):
    rec = spans.record(ctx)
    if rec is None:
        return None
    win = ctx["window"]
    shift = spans.to_host(spans.launches_on_card(rec, win,
                                                 ctx["patterns"].MEGA))
    busy = win.busy_intervals()
    gaps = sorted((shift(a[1]), shift(a[1]) + b[0] - a[1])
                  for a, b in zip(busy, busy[1:]) if b[0] > a[1])
    idle = sum(g1 - g0 for g0, g1 in gaps)
    if idle <= 0:
        return None
    return spans.covered_ns(gaps, rec.leaf_intervals()) / idle
