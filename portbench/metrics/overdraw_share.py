"""The share of the samples the window's launches completed that lie
beyond those asked for: lanes trace on while their tile drains, and the
epilogue scales each pixel back to its spp. From the program's overdraw
counter (row 5 of each launch's output summed on the device, read once
after the window)."""
from portbench import spans


def read(ctx):
    rec = spans.record(ctx)
    if rec is None or rec.overdraw is None:
        return None
    done, asked = rec.overdraw
    if done <= 0:
        return None
    return (done - asked) / done
