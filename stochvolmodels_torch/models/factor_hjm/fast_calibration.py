"""
Swaption-cube calibration helpers of the factor-HJM LogSV model.

PyTorch counterpart of ``stochvolmodels_tpu/models/factor_hjm/fast_calibration.py``.
Only the chain flattening is ported so far; the slice and cube LM fits, the
term-structure bootstrap and the A prefit follow with ``qa_traced``
(ROADMAP section 1, item 4).
"""
from __future__ import annotations

from typing import Optional

import numpy as np


def swaption_chain_to_cube(swaption_chain,
                           max_expiry: Optional[float] = None):
    """flatten a SwOptionChain into (slices, forwards, strikes_slices,
    market_ivols_slices) rows, one per (expiry, tenor), optionally capped
    at ``max_expiry`` (e.g. where the parameter term structure ends)."""
    slices, forwards, strikes_slices, ivols_slices = [], [], [], []
    for i, tenor in enumerate(np.asarray(swaption_chain.tenors, dtype=float)):
        for j, ttm in enumerate(np.asarray(swaption_chain.ttms, dtype=float)):
            if max_expiry is not None and ttm > float(max_expiry):
                continue
            slices.append((float(ttm), float(tenor)))
            forwards.append(float(swaption_chain.forwards[i][j]))
            strikes_slices.append(np.asarray(swaption_chain.strikes_ttms[i][j]))
            ivols_slices.append(np.asarray(swaption_chain.bid_ivs[i][j]))
    return slices, forwards, strikes_slices, ivols_slices
