"""Microseconds from the start of the megakernel's launch call
(`kernel.launch`, the program's span: the trace holds no runtime call for
it) to the kernel's start on the card, averaged over the window's
launches; the card's clock is set to the host's at each launch's own
segment read (`portbench/spans.py::start_lags_ns`)."""
from portbench import spans


def read(ctx):
    rec = spans.record(ctx)
    if rec is None:
        return None
    lags = spans.start_lags_ns(spans.launches_on_card(
        rec, ctx["window"], ctx["patterns"].MEGA))
    if not lags:
        return None
    return sum(lags) / len(lags) * 1e-3
