"""Device milliseconds a profiled step inside the train step's own ``plan``
span (the seed draw and the plan build, its id exchanges included), from
the span's marker pairs in the traced window (:mod:`gnnbench.spans`): the
same work ``plan_ms`` times in replays of ``engine.plan_program`` alone."""
from gnnbench import spans


def read(ctx):
    tr = ctx["trace"]
    if tr is None:
        return None
    return spans.span_ms(tr, "plan", len(ctx["profiled_steps"]))
