"""Device milliseconds a replay of ``engine.plan_program`` alone (the seed
draw and the sampled plan of a step), by CUDA events around
``plan_replays`` replays at the window's first steps."""


def read(ctx):
    return ctx["plan_ms"]
