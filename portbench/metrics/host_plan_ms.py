"""Host milliseconds a launch in the launch plan: `make_plan`
(`plan.make`) and `device_inputs` (`plan.inputs`), any table or layout
build on a memo miss (`plan.tables`) inside them included, from the
program's spans inside the window."""
from portbench import spans


def read(ctx):
    rec = spans.record(ctx)
    if rec is None:
        return None
    return rec.per_launch_ms(("plan.make", "plan.inputs"))
