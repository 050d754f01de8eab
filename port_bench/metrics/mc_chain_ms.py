"""mc_chain_ms: the timed window over the MC chain calls completed in it,
each ending with prices and standard errors on the host (host clock)."""


def read(ctx):
    return 1e3 * ctx.window_s / len(ctx.latencies) if ctx.latencies else None
