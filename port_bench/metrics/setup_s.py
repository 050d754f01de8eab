"""setup_s: seconds from the start of the run's process to its first timed
request: imports, the kernels loaded from the checkout's build cache (built
there by the checkout's first run), the program's set-up, graph captures and
warm calls of the cell's shapes (host clock)."""


def read(ctx):
    return ctx.setup_s
