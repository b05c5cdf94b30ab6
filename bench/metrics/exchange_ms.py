"""Device milliseconds a profiled step inside the program's exchange spans:
the marker pairs of ``exchange.ids.l*`` (the plan's id all-to-alls),
``exchange.fwd.l*`` (all of ``redistribute``: the request gather, the
exchange and the slot scatter) and ``exchange.bwd.l*`` (their backward),
every layer (:mod:`gnnbench.spans`)."""
from gnnbench import spans


def read(ctx):
    tr = ctx["trace"]
    if tr is None:
        return None
    return spans.span_ms(tr, r"exchange_\w+", len(ctx["profiled_steps"]))
