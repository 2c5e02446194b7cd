"""Host milliseconds a launch in the launch's random-number keys: the
render loop's `prng.fold_in(key, launch)` (`loop.key`) and the megakernel
seed, `launch_seed`'s threefry in scalar host arithmetic on Python ints
(`loop.seed`), from the program's spans inside the window."""
from portbench import spans


def read(ctx):
    rec = spans.record(ctx)
    if rec is None:
        return None
    return rec.per_launch_ms(("loop.key", "loop.seed"))
