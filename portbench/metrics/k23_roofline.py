"""K2+K3 (`mega_kernel_surfaces`: rects, MIS lights, media) against its
roofline: the least time of the window's K2+K3 work at the card's peaks
(FP32 operations from `opcount`, a lower bound; bytes each read or
written once) over its summed device time, in %. Nothing to read on a
sphere-only scene."""


def read(ctx):
    win, oc, plan = ctx["window"], ctx["opcount"], ctx["plan"]
    k23 = ctx["patterns"].K23
    t = win.kernel_seconds(k23)
    if t <= 0 or not plan.surfaces or plan.cull:
        return None
    ops = oc.ops_per_segment(plan) * ctx["segments"]
    nbytes = win.kernel_count(k23) * oc.launch_bytes(
        plan, ctx["n_tiles"], ctx["table_bytes"])
    return 100.0 * oc.least_seconds(ops, nbytes)[0] / t
