"""
The program's calls for the Heston model (``stochvolmodels_torch``): the
Levenberg-Marquardt fit of (v0, theta, kappa, rho, volvol), one CUDA graph a
chain shape on a card, and the MC chain through the hand-written kernel
``heston_mc`` (whose pricer runs 360 Euler steps a year).
"""
from __future__ import annotations

from typing import Dict, Tuple

import numpy as np
import stochvolmodels_torch as svt

FIT_KEYS = ("v0", "theta", "kappa", "rho", "volvol")
# operations a path-step of the path loop (float32, 32-bit integer), counted
# from the kernel's source when frozen here: every arithmetic operator,
# comparison, select, min/max/abs, int-float conversion and libm call one,
# an FMA two; the two normals (hashes of two streams, a polynomial ln, an odd
# minimax cos, Box-Muller) 46 + 28, the ring of keys and the loop counter 6
# integer operations, the full-truncation step 22
OPS_PER_STEP = (68, 34)
PATH_KERNEL = "heston_mc_kernel"
LM_GRAPH = "heston_lm"
MC_YEAR_STEPS = 360


class Program:
    def __init__(self, device):
        self.device = device
        self.pricer = svt.HestonPricer(device=device)

    def fit(self, chain, params0: Dict[str, float], lm: Dict) -> Tuple[np.ndarray, float]:
        fit, cost = svt.calibrate_heston_lm(chain, svt.HestonParams(**params0),
                                            nb_iters=int(lm["nb_iters"]), device=self.device)
        return np.array([getattr(fit, k) for k in FIT_KEYS], dtype=np.float64), cost

    def mc(self, chain, params: Dict[str, float], nb_path: int, seed: int, year_steps: int):
        if year_steps != MC_YEAR_STEPS:
            raise ValueError(f"the Heston MC chain runs {MC_YEAR_STEPS} steps a year, "
                             f"not {year_steps}")
        return self.pricer.model_mc_price_chain(chain, svt.HestonParams(**params),
                                                nb_path=nb_path, seed=seed, engine="cuda")
