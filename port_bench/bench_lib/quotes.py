"""
Quote snapshots: the bundled chain as plain numpy, its seeded variations,
and the per-request seeds.  Both the program and the reference start from
these arrays.
"""
from __future__ import annotations

from pathlib import Path
from typing import Dict

import numpy as np


def load(path: Path) -> Dict:
    """a chain snapshot (.npz: ttms, forwards, discfactors, strikes_i,
    optiontypes_i, bid_ivs_i, ask_ivs_i) as a dict of numpy arrays."""
    with np.load(path, allow_pickle=False) as z:
        n = len(z["ttms"])
        return dict(ids=np.asarray(z["ids"]), ticker=str(z["ticker"]),
                    ttms=np.asarray(z["ttms"], dtype=np.float64),
                    forwards=np.asarray(z["forwards"], dtype=np.float64),
                    discfactors=np.asarray(z["discfactors"], dtype=np.float64),
                    strikes=[np.asarray(z[f"strikes_{i}"], dtype=np.float64) for i in range(n)],
                    types=[np.asarray(z[f"optiontypes_{i}"]) for i in range(n)],
                    bid_ivs=[np.asarray(z[f"bid_ivs_{i}"], dtype=np.float64) for i in range(n)],
                    ask_ivs=[np.asarray(z[f"ask_ivs_{i}"], dtype=np.float64) for i in range(n)])


def rng(seed: int, stream: int, k: int) -> np.random.Generator:
    """the generator of request ``k`` of a run (``stream`` 0: the window,
    1: warm-up calls)."""
    return np.random.default_rng([int(seed), int(stream), int(k)])


def request_seed(seed: int, stream: int, k: int) -> int:
    """a 31-bit seed for request ``k`` of a run."""
    return int(rng(seed, stream, k).integers(0, 2 ** 31 - 1))


def moved(quotes: Dict, g: np.random.Generator, level_vol: float, quote_vol: float) -> Dict:
    """a new snapshot of the same strikes and maturities: each slice's bid
    and ask vols shifted together by a level N(0, level_vol) of the slice
    plus N(0, quote_vol) of the quote (the spread is kept)."""
    out = dict(quotes)
    shifts = [g.normal(0.0, level_vol) + g.normal(0.0, quote_vol, size=len(b))
              for b in quotes["bid_ivs"]]
    out["bid_ivs"] = [b + d for b, d in zip(quotes["bid_ivs"], shifts)]
    out["ask_ivs"] = [a + d for a, d in zip(quotes["ask_ivs"], shifts)]
    return out


def jittered(params: Dict[str, float], g: np.random.Generator, share: float) -> Dict[str, float]:
    """each parameter times (1 + U(-share, share))."""
    return {k: float(v * (1.0 + g.uniform(-share, share))) for k, v in params.items()}


def option_chain(quotes: Dict):
    """the program's chain object of a snapshot."""
    import stochvolmodels_torch as svt

    return svt.OptionChain(ids=quotes["ids"], ttms=quotes["ttms"], ticker=quotes["ticker"],
                           forwards=quotes["forwards"], discfactors=quotes["discfactors"],
                           strikes_ttms=quotes["strikes"], optiontypes_ttms=quotes["types"],
                           bid_ivs=quotes["bid_ivs"], ask_ivs=quotes["ask_ivs"])
