"""Seconds the step program's capture took (``CompiledFunction.report()``:
its ``capture_ms``), part of set-up."""


def read(ctx):
    ms = [r["capture_ms"] for r in ctx["program_report"].values()]
    return sum(ms) / 1e3 if ms else None
