"""The neighbor aggregation's share of its roofline, forward and backward:
the least time of every ``spmm`` call of the profiled steps
(``gnnbench.counts.spmm_costs``: valid rows and kept edges), over the
profiled device time of the port's ``spmm`` kernels (the forward, and the
backward's count, scan, place and rows kernels), in percent."""
from gnnbench import counts

KERNELS = (r"(^|[\s:])(spmm_fwd_kernel|bwd_count_kernel|lookback_scan_kernel"
           r"|bwd_place_kernel|bwd_rows_kernel)[<(]")


def read(ctx):
    tr = ctx["trace"]
    if tr is None or not ctx["profiled_steps"]:
        return None
    secs = tr.kernel_s(KERNELS)
    if secs <= 0:
        return None
    bound = sum(counts.bound_s(counts.spmm_costs(ctx["model"], ctx["work"](s)))
                for s in ctx["profiled_steps"])
    return 100.0 * bound / secs
