"""The program's peak device memory (``torch.cuda.max_memory_allocated``)
over its set-up and the window, with the benchmark's inputs resident, in
GiB."""


def read(ctx):
    return ctx["peak_bytes"] / 2**30 if ctx["peak_bytes"] else None
