"""mc_chain_p95_ms: the 95th percentile (linear interpolation) of the MC
chain calls' latencies over the whole window (host clock)."""
import numpy as np


def read(ctx):
    return float(np.percentile(np.asarray(ctx.latencies) * 1e3, 95)) if ctx.latencies else None
