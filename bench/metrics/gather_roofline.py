"""The feature gather's share of its roofline: the least time of the valid
bytes (``gnnbench.counts.gather_cost``) of the profiled steps, over the
profiled device time of the port's ``gather`` kernel, in percent."""
from gnnbench import counts

KERNEL = r"(^|[\s:])gather_kernel<"


def read(ctx):
    tr = ctx["trace"]
    if tr is None or not ctx["profiled_steps"]:
        return None
    secs = tr.kernel_s(KERNEL)
    if secs <= 0:
        return None
    bound = counts.bound_s([counts.gather_cost(ctx["model"], ctx["work"](s))
                            for s in ctx["profiled_steps"]])
    return 100.0 * bound / secs
