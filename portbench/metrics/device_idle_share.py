"""The share of the window in which nothing ran on the card: 1 - the
union of the trace's device activity intervals over the window."""


def read(ctx):
    win = ctx["window"]
    if not win.device:
        return None
    return 1.0 - win.busy_seconds() / ctx["window_s"]
