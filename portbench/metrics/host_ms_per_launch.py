"""Host milliseconds a launch: from the end of the last wait for the
device (the previous launch's segment read, or the previous image's
synchronisation) to the start of the next megakernel on the card,
averaged over the window's launches, from the trace's CPU events and
device activity."""


def read(ctx):
    gaps = ctx["window"].host_gaps_before(ctx["patterns"].MEGA)
    if not gaps:
        return None
    return 1e3 * sum(gaps) / len(gaps)
