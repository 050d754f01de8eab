"""
The program's calls for the Hawkes jump-diffusion (``stochvolmodels_torch``):
the MC chain through the hand-written thinning kernel ``hawkes_mc``, whose
pricer runs 1800 Euler steps a year.  No LM cell of this model exists.
"""
from __future__ import annotations

from typing import Dict

import stochvolmodels_torch as svt

# operations a path-step of the path loop (float32, 32-bit integer), counted
# from the kernel's source as the other models' counts are (an FMA two): what
# every path-step runs, (76, 54), plus each branch's operations
# (log (19, 4): the exact thinning test where the pre-test fails; jump
# (21, 15): the jump size where a jump fires; on each side) weighted by how
# often it runs.  The work depends on the draws, so the shares were measured
# once and frozen: ``hawkes_branch_shares`` (stochvolmodels_torch/ops/cuda_mc.py)
# over the chain's four slices (780 steps at 1800 a year, the state carried
# from slice to slice, slice seeds base + 7919 i) at this configuration's
# parameters, 131,072 paths: log 0.8317% + 1.0298% and jump 0.8266% + 1.0224%
# of path-steps (base seed 1000003; within 0.004 points on each side at base
# 2147483701).  That gives 76 + 19 x 1.8615% + 21 x 1.8489% = 76.742 and
# 54 + 4 x 1.8615% + 15 x 1.8489% = 54.352 (76.744 and 54.353 at the second
# seed), frozen at two decimals, whatever implements the loop.
OPS_PER_STEP = (76.74, 54.35)
PATH_KERNEL = "hawkes_mc_kernel"
MC_YEAR_STEPS = 1800


class Program:
    def __init__(self, device):
        self.device = device
        self.pricer = svt.HawkesJDPricer(device=device)

    def mc(self, chain, params: Dict[str, float], nb_path: int, seed: int, year_steps: int):
        if year_steps != MC_YEAR_STEPS:
            raise ValueError(f"the Hawkes MC chain runs {MC_YEAR_STEPS} steps a year, "
                             f"not {year_steps}")
        return self.pricer.model_mc_price_chain(chain, svt.HawkesJDParams(**params),
                                                nb_path=nb_path, seed=seed, engine="cuda")
