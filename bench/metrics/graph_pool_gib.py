"""GiB by which the step program's capture grew its graph's memory pool
(``CompiledFunction.report()``: its ``pool_bytes``)."""


def read(ctx):
    pools = [r["pool_bytes"] for r in ctx["program_report"].values()]
    return sum(pools) / 2**30 if pools else None
