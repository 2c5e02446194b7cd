"""Device milliseconds a launch of everything on the card other than the
megakernel: the epilogue's renormalisation and inverse permutation, the
canvas accumulation and divide, the slot table's staging, copies and
memsets, from the trace."""


def read(ctx):
    win = ctx["window"]
    if not win.device or ctx["launches"] <= 0:
        return None
    return win.other_seconds(ctx["patterns"].MEGA) / ctx["launches"] * 1e3
