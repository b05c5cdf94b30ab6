"""The whole step's model FLOPs (``gnnbench.counts.step_flops``: valid rows
and kept edges, forward and backward) over 67 TFLOP/s (H100 float32 with
TF32 off) times the host-clock time of the same steps, the traced window's
first ``count_steps``, in percent."""
from gnnbench import counts


def read(ctx):
    steps = [s for s in ctx["counted_steps"] if s in ctx["step_s"]]
    if not steps:
        return None
    flops = sum(counts.step_flops(ctx["model"], ctx["work"](s)) for s in steps)
    secs = sum(ctx["step_s"][s] for s in steps)
    return 100.0 * flops / (counts.FLOAT32_FLOPS * secs)
