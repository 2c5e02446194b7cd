"""Path segments the megakernels traced (the program's `RenderStats`
counter, overdraw samples included) over the window's seconds, in M
segments/s: the field's rays/s."""


def read(ctx):
    if ctx["segments"] <= 0:
        return None
    return ctx["segments"] / ctx["window_s"] / 1e6
