"""Milliseconds a profiled step in which the device idled while the host was
inside the program's ``engine.step_state`` span (the step state packed and
uploaded from pinned memory before each replay)."""
from gnnbench import spans


def read(ctx):
    tr = ctx["trace"]
    steps = len(ctx["profiled_steps"])
    if tr is None or not steps or tr.busy_s <= 0:
        return None
    upload = spans.host_spans(tr, lambda name: name == spans.STEP_STATE)
    if not upload:
        return None
    return spans.overlap_us(spans.idle_gaps(tr), upload) * 1e-3 / steps
