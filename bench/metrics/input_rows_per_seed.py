"""Valid ids of the plans' input layer over all PEs, over the global batch,
for the traced window's first ``count_steps`` steps: the rows a seed costs
the feature gather (the paper's work per seed; a count that repeats)."""


def read(ctx):
    steps = ctx["counted_steps"]
    if not steps:
        return None
    return sum(ctx["input_rows"][s] for s in steps) / (ctx["global_batch"] * len(steps))
