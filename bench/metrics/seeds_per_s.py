"""Seed vertices trained a second: the global batch times the steps the
window completed, over the window's host-clock seconds (its closing sync
included)."""


def read(ctx):
    w = ctx["window"]
    return ctx["global_batch"] * w["steps"] / w["seconds"] if w["steps"] else None
