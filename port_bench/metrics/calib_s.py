"""calib_s: the timed window over the LM fits completed in it, each ending
with the fitted parameters and cost on the host (host clock)."""


def read(ctx):
    return ctx.window_s / len(ctx.latencies) if ctx.latencies else None
