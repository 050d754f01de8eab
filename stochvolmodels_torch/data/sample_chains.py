"""
Bundled market-data snapshots.

The quote data is the package's own copy of the snapshots,
``data/chains/*.npz`` beside this module (package data), so an installed
``stochvolmodels_torch`` finds its chains on its own.
"""
from __future__ import annotations

from pathlib import Path

import numpy as np

from stochvolmodels_torch.data.option_chain import OptionChain

CHAINS_DIR = Path(__file__).resolve().parent / "chains"


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


def get_vix_test_chain_data() -> OptionChain:
    """VIX implied vols of 15Jul2022."""
    return load_chain_npz("vix_20220715.npz")


def get_gld_test_chain_data_6m() -> OptionChain:
    """GLD 6m chain."""
    return load_chain_npz("gld_6m.npz")


def get_gld_test_chain_data() -> OptionChain:
    """GLD chain."""
    return load_chain_npz("gld.npz")


def get_sqqq_test_chain_data() -> OptionChain:
    """SQQQ chain."""
    return load_chain_npz("sqqq.npz")


def get_spy_test_chain_data() -> OptionChain:
    """SPY chain."""
    return load_chain_npz("spy.npz")


def get_qv_options_test_chain_data(num_strikes: int = 21) -> OptionChain:
    """synthetic chain of options on quadratic variance: 6 maturities (1w to
    12m), unit forwards, ``num_strikes`` call strikes uniform on [0.75, 1.5]."""
    ids = np.array(['1w', '2w', '1m', '3m', '6m', '12m'])
    ttms = np.array([7.0 / 365.0, 14.0 / 365.0, 0.083333333, 0.25, 0.5, 1.0])
    strikes = np.linspace(0.75, 1.5, num_strikes)
    optiontypes = np.full(strikes.shape, 'C')
    return OptionChain(ids=ids, ttms=ttms, ticker='BTC', forwards=np.ones_like(ttms),
                       discfactors=np.ones_like(ttms), strikes_ttms=[strikes] * len(ttms),
                       optiontypes_ttms=[optiontypes] * len(ttms), bid_ivs=None, ask_ivs=None)
