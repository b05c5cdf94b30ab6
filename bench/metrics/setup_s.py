"""Seconds from the start of the harness to the first timed step, less the
settle's idle (``harness.SETTLE_S``): the inputs made on the device, the
features' round trip through the host, the engine, the kernel libraries
loaded (built in a checkout's first run), the step program's eager first
call and capture, and the warm steps."""


def read(ctx):
    return ctx["setup_s"]
