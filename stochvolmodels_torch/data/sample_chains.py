"""
Bundled market-data snapshots.

The quote data lives in the JAX package's ``data/chains/*.npz`` files; they
are read here by file path, so loading a chain imports nothing of the JAX
package.
"""
from __future__ import annotations

from pathlib import Path

import numpy as np

from stochvolmodels_torch.data.option_chain import OptionChain

CHAINS_DIR = Path(__file__).resolve().parents[2] / "stochvolmodels_tpu" / "data" / "chains"


def load_chain_npz(name: str) -> OptionChain:
    """load a chain snapshot from the bundled ``.npz`` files."""
    with np.load(CHAINS_DIR / name, allow_pickle=False) as z:
        ttms = z["ttms"]
        n = len(ttms)
        has_ivs = "bid_ivs_0" in z
        return OptionChain(
            ids=z["ids"],
            ttms=ttms,
            ticker=str(z["ticker"]) or None,
            forwards=z["forwards"],
            discfactors=z["discfactors"],
            strikes_ttms=[z[f"strikes_{i}"] for i in range(n)],
            optiontypes_ttms=[z[f"optiontypes_{i}"] for i in range(n)],
            bid_ivs=[z[f"bid_ivs_{i}"] for i in range(n)] if has_ivs else None,
            ask_ivs=[z[f"ask_ivs_{i}"] for i in range(n)] if has_ivs else None,
        )


def get_btc_test_chain_data() -> OptionChain:
    """BTC implied vols of 21Oct2021."""
    return load_chain_npz("btc_20211021.npz")
