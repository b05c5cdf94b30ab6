"""The 90th percentile of the traced window's step times: host clock around
each replay of the step program, ended by a sync (the traced run syncs
every step, so this is not the untraced window's pace)."""
import statistics


def read(ctx):
    times = list(ctx["step_s"].values())
    if len(times) < 10:
        return None
    return 1e3 * statistics.quantiles(times, n=10)[-1]
