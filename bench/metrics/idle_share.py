"""The share of the traced window (the profiled steps and their closing
sync) in which no kernel, copy or memset ran on the device, in percent."""


def read(ctx):
    tr = ctx["trace"]
    if tr is None or tr.window_s <= 0 or tr.busy_s <= 0:
        return None
    return 100.0 * (1.0 - tr.busy_s / tr.window_s)
