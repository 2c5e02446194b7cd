"""The whole window's share of the card's FP32 peak: the FP32 operations
of every segment traced (the lower-bound count of `opcount`) over the
window's seconds at 67 TFLOP/s, in %. It bounds every kernel's roofline
share from the side of the whole image: a kernel taken off the path
leaves its own share silent, never this one."""


def read(ctx):
    if ctx["segments"] <= 0:
        return None
    ops = ctx["opcount"].ops_per_segment(ctx["plan"]) * ctx["segments"]
    return 100.0 * ops / (ctx["window_s"] * ctx["opcount"].FP32_PEAK)
