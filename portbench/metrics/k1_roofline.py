"""K1 (`mega_kernel`, the sphere-only megakernel) against its roofline:
the least time of the window's K1 work at the card's peaks (FP32
operations from `opcount`, a lower bound; bytes each read or written
once) over K1's summed device time, in %. Nothing to read on a scene
with rects, lights or media, which runs K2+K3 instead."""


def read(ctx):
    win, oc, plan = ctx["window"], ctx["opcount"], ctx["plan"]
    k1 = ctx["patterns"].K1
    t = win.kernel_seconds(k1)
    if t <= 0 or plan.surfaces or plan.cull:
        return None
    ops = oc.ops_per_segment(plan) * ctx["segments"]
    nbytes = win.kernel_count(k1) * oc.launch_bytes(
        plan, ctx["n_tiles"], ctx["table_bytes"])
    return 100.0 * oc.least_seconds(ops, nbytes)[0] / t
