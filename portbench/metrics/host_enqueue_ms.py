"""Host milliseconds a launch in enqueueing the device work: the
megakernel wrapper's checks and staging (`kernel.prepare`), its launch
call (`kernel.launch`), the epilogue's ops (`epilogue.order`,
`epilogue.enqueue`) and the canvas's `+=` (`loop.accumulate`), from the
program's spans inside the window."""
from portbench import spans


def read(ctx):
    rec = spans.record(ctx)
    if rec is None:
        return None
    return rec.per_launch_ms(("kernel.prepare", "kernel.launch",
                              "loop.accumulate"), ("epilogue.",))
