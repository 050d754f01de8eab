"""
The program's calls for the LogSV model (``stochvolmodels_torch``): the
PARAMS5 Levenberg-Marquardt fit, one CUDA graph a chain shape on a card, and
the MC chain through the hand-written kernel ``logsv_mc``.
"""
from __future__ import annotations

from typing import Dict, Tuple

import numpy as np
import stochvolmodels_torch as svt

FIT_KEYS = ("sigma0", "theta", "kappa1", "beta", "volvol")
# operations a path-step of the path loop (float32, 32-bit integer), counted
# from the kernel's source when frozen here: every arithmetic operator,
# comparison, select, min/max/abs, int-float conversion and libm call one,
# an FMA two; the two normals (hashes of two streams, a polynomial ln, an odd
# minimax cos, Box-Muller) 46 + 28, the ring of keys and the loop counter 6
# integer operations, the log-sigma Euler step 27
OPS_PER_STEP = (73, 34)
PATH_KERNEL = "logsv_mc_kernel"
LM_GRAPH = "lm"


class Program:
    def __init__(self, device):
        self.device = device
        self.pricer = svt.LogSVPricer(device=device)

    def fit(self, chain, params0: Dict[str, float], lm: Dict) -> Tuple[np.ndarray, float]:
        p0 = svt.LogSvParams(**params0)
        fit, cost = svt.calibrate_logsv_lm_on_device(
            chain, p0, nb_iters=int(lm["nb_iters"]), year_steps=int(lm["year_steps"]),
            device=self.device)
        return np.array([getattr(fit, k) for k in FIT_KEYS], dtype=np.float64), cost

    def mc(self, chain, params: Dict[str, float], nb_path: int, seed: int, year_steps: int):
        return self.pricer.model_mc_price_chain(
            chain, svt.LogSvParams(**params), nb_path=nb_path, nb_steps=year_steps, seed=seed,
            engine="cuda")
