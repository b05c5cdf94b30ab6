"""Valid input ids a seed in the train step's own plans: the program's
counter ``input_rows`` (valid ids of each run's ``input_ids``, all PEs)
over the global batch times its ``replays`` counter (the runs it was
added in), from the step program's ``report()``.  ``input_rows_per_seed``
counts the same ids in plans that ``engine.plan_program`` rebuilds after
the window; this one counts every step the program ran."""


def read(ctx):
    rows = runs = 0
    for rep in ctx["program_report"].values():
        counters = rep.get("counters", {})
        rows += counters.get("input_rows", 0)
        runs += counters.get("replays", 0)
    return rows / (ctx["global_batch"] * runs) if runs and rows else None
