"""Blocking runtime calls a profiled step inside the program's host spans
(``engine.step_state`` and ``<program>.replay``): device, stream and event
synchronizations, copies that are not asynchronous, and pinned host
allocations and frees (:data:`gnnbench.spans.BLOCKING`)."""
from gnnbench import spans


def read(ctx):
    tr = ctx["trace"]
    steps = len(ctx["profiled_steps"])
    if tr is None or not steps or tr.busy_s <= 0:
        return None
    program = spans.host_spans(
        tr, lambda name: name == spans.STEP_STATE or name.endswith(spans.REPLAY))
    if not program:
        return None
    return spans.blocking_calls(tr, program) / steps
