"""
Build calibration :class:`OptionChain` inputs from live or in-memory
option-chain data.

PyTorch-port copy of ``stochvolmodels_tpu/data/fetch_option_chain.py``,
host code with the JAX package's arithmetic and order, so that every field
of the chain it builds is the JAX module's bit for bit.  The chain
construction (days-map expiry selection, OTM joint-slice assembly,
delta-bounds wing filtering, per-slice packing into the port's
:class:`OptionChain`) needs no optional package and runs on synthetic
in-memory frames.  Only the live fetch (``load_option_chain``,
``sample_option_chain_at_times``) needs the optional
``option-chain-analytics`` package (OCA), resolved when it is called.
pandas, which the card's machine lacks, is imported inside the functions
that need it, so the module imports without it.

Protocol (satisfied by OCA's ``SlicesChain``/``ExpirySlice`` and by the
lightweight containers below):

* ``chain.get_next_slice_after_date(mat_date)`` -> expiry key
* ``chain.expiry_slices[key]`` -> slice with ``expiry_id``, ``get_ttm()``,
  ``get_future_price()`` and
  ``get_joint_slice(delta_bounds=..., is_filtered=...)`` -> DataFrame
  indexed by strike with columns optiontype / bid_iv / ask_iv /
  bid_price / ask_price.
"""
from __future__ import annotations

from dataclasses import dataclass, field
from typing import Dict, Optional, Tuple

import numpy as np

from stochvolmodels_torch.data.option_chain import OptionChain

try:
    from option_chain_analytics import (  # noqa: F401
        OptionsDataDFs, create_chain_from_from_options_dfs)
    from option_chain_analytics.option_chain import SliceColumn  # noqa: F401
    HAS_OCA = True
except ImportError:
    SliceColumn = None
    HAS_OCA = False

# load_option_chain's default value time (a pandas Timestamp when called)
DEFAULT_VALUE_TIME = '2023-02-06 08:00:00+00:00'


def _oca_create_chain():
    """OCA's chain constructor, resolved when called (not when the module
    is imported), so that an ``option_chain_analytics`` module placed in
    ``sys.modules`` later flows through the full adapter."""
    try:
        from option_chain_analytics import create_chain_from_from_options_dfs
        return create_chain_from_from_options_dfs
    except ImportError:
        raise ImportError(
            "live chain fetching needs the optional 'option-chain-analytics' "
            "package; install it or use the bundled sample chains in "
            "stochvolmodels_torch.data.sample_chains")


def _require_oca() -> None:
    _oca_create_chain()


def _col(df, name: str) -> np.ndarray:
    """tolerant column access: plain lower/upper-case string names, or (when
    OCA is installed) the SliceColumn enum member and its value."""
    candidates = [name, name.upper()]
    if SliceColumn is not None:
        member = getattr(SliceColumn, name.upper(), None)
        if member is not None:
            candidates += [member, getattr(member, "value", None)]
    for c in candidates:
        if c is not None and c in df.columns:
            return df[c].to_numpy()
    raise KeyError(f"joint slice frame has no '{name}' column "
                   f"(have: {list(df.columns)})")


def make_joint_slice_df(df,
                        forward: float,
                        delta_bounds: Tuple[Optional[float], Optional[float]] = (-0.1, 0.1),
                        is_filtered: bool = True):
    """the OTM joint smile of one expiry from a raw per-option frame (the
    transformation of OCA's ``ExpirySlice.get_joint_slice``):

    * joint smile: puts quote strikes below the forward, calls at/above it
      (each strike once, sorted ascending);
    * ``delta_bounds=(put_floor, call_floor)``: drop far-wing quotes with
      ``|delta|`` below the floor — puts need ``delta <= put_floor``
      (e.g. -0.1), calls ``delta >= call_floor``; ``None`` disables a side;
    * ``is_filtered``: drop quotes without a usable two-sided vol market
      (non-finite or non-positive bid/ask IV).

    ``df`` columns: strike, optiontype ('C'/'P'), delta, bid_iv, ask_iv,
    bid_price, ask_price (strike may be the index instead).
    """
    df = df.copy()
    if "strike" in df.columns:
        df = df.set_index("strike")
    df.index = df.index.astype(float)

    otype = df["optiontype"].astype(str).to_numpy()
    is_call = np.char.upper(otype.astype(str)) == "C"
    otm = np.where(is_call, df.index.to_numpy() >= float(forward),
                   df.index.to_numpy() < float(forward))
    keep = otm
    if delta_bounds is not None and "delta" in df.columns:
        put_floor, call_floor = delta_bounds
        delta = df["delta"].to_numpy(dtype=float)
        if put_floor is not None:
            keep = keep & np.where(~is_call, delta <= float(put_floor), True)
        if call_floor is not None:
            keep = keep & np.where(is_call, delta >= float(call_floor), True)
    if is_filtered:
        bid_iv = df["bid_iv"].to_numpy(dtype=float)
        ask_iv = df["ask_iv"].to_numpy(dtype=float)
        keep = keep & np.isfinite(bid_iv) & np.isfinite(ask_iv) \
            & (bid_iv > 0.0) & (ask_iv > 0.0)
    out = df.loc[keep].sort_index()
    # one quote per strike: a strike quoted on both sides at the forward keeps the call
    out = out[~out.index.duplicated(keep="last")]
    return out


@dataclass
class ExpirySlice:
    """minimal expiry-slice container satisfying the OCA protocol, for
    in-memory chains (columns as in :func:`make_joint_slice_df`)."""
    expiry_id: str
    ttm: float
    future_price: float
    df: "pd.DataFrame"  # noqa: F821

    def get_ttm(self) -> float:
        return float(self.ttm)

    def get_future_price(self) -> float:
        return float(self.future_price)

    def get_joint_slice(self,
                        delta_bounds: Tuple[Optional[float], Optional[float]] = (-0.1, 0.1),
                        is_filtered: bool = True):
        return make_joint_slice_df(self.df, forward=self.future_price,
                                   delta_bounds=delta_bounds,
                                   is_filtered=is_filtered)


@dataclass
class SlicesChain:
    """minimal chain-of-expiry-slices container satisfying the OCA protocol
    (keys are expiry timestamps, kept sorted)."""
    expiry_slices: Dict["pd.Timestamp", ExpirySlice] = field(default_factory=dict)  # noqa: F821

    def __post_init__(self):
        self.expiry_slices = dict(sorted(self.expiry_slices.items()))

    def get_next_slice_after_date(self, mat_date):
        """first expiry on/after ``mat_date``; the last expiry when the
        date lies past them all (overlapping horizons take the last
        available maturity)."""
        keys = list(self.expiry_slices.keys())
        if not keys:
            raise ValueError("chain has no expiry slices")
        for k in keys:
            if k >= mat_date:
                return k
        return keys[-1]


def generate_vol_chain_np(chain,
                          value_time,
                          days_map: Optional[Dict[str, int]] = None,
                          delta_bounds: Tuple[Optional[float], Optional[float]] = (-0.1, 0.1),
                          is_filtered: bool = True,
                          ) -> OptionChain:
    """the calibration :class:`OptionChain` of a slices chain at
    ``value_time`` (a pandas Timestamp).

    For each ``days_map`` entry (label -> horizon in days) the first expiry
    on/after ``value_time + days`` is selected, its delta-filtered OTM joint
    smile extracted, and non-empty slices packed into one chain with ids
    ``'<label>: <expiry_id>'`` and unit discount factors (crypto-style
    forward quoting).  Works on OCA ``SlicesChain`` objects and on the
    in-memory :class:`SlicesChain` above.
    """
    import pandas as pd

    if days_map is None:
        days_map = {'1w': 7, '1m': 21}

    ttms, future_prices, discfactors, slice_ids = [], [], [], []
    strikes_ttms, optiontypes_ttms = [], []
    bid_ivs, ask_ivs, bid_prices, ask_prices = [], [], [], []
    seen = set()
    for label, day in days_map.items():
        next_date = value_time + pd.DateOffset(days=day)
        slice_date = chain.get_next_slice_after_date(mat_date=next_date)
        if slice_date in seen:   # overlapping horizons resolve to one expiry
            continue
        seen.add(slice_date)
        slice_t = chain.expiry_slices[slice_date]
        df = slice_t.get_joint_slice(delta_bounds=delta_bounds,
                                     is_filtered=is_filtered)
        if df.empty:
            continue
        slice_ids.append(f"{label}: {slice_t.expiry_id}")
        ttms.append(slice_t.get_ttm())
        future_prices.append(slice_t.get_future_price())
        discfactors.append(1.0)
        strikes_ttms.append(df.index.to_numpy(dtype=float))
        optiontypes_ttms.append(_col(df, "optiontype").astype(str))
        bid_ivs.append(_col(df, "bid_iv").astype(float))
        ask_ivs.append(_col(df, "ask_iv").astype(float))
        bid_prices.append(_col(df, "bid_price").astype(float))
        ask_prices.append(_col(df, "ask_price").astype(float))

    return OptionChain(ttms=np.array(ttms),
                       forwards=np.array(future_prices),
                       discfactors=np.array(discfactors),
                       ids=np.array(slice_ids),
                       strikes_ttms=strikes_ttms,
                       optiontypes_ttms=optiontypes_ttms,
                       bid_ivs=bid_ivs,
                       ask_ivs=ask_ivs,
                       bid_prices=bid_prices,
                       ask_prices=ask_prices)


def load_option_chain(options_data_dfs,
                      value_time=DEFAULT_VALUE_TIME,
                      days_map: Optional[Dict[str, int]] = None,
                      delta_bounds: Tuple[Optional[float], Optional[float]] = (-0.1, 0.1),
                      is_filtered: bool = True,
                      ) -> Optional[OptionChain]:
    """the OptionChain of an OCA ``OptionsDataDFs`` at ``value_time`` (a
    pandas Timestamp, or a string pandas parses), or None where OCA builds
    no chain.  OCA gates only its chain constructor, resolved here; the
    chain is built by :func:`generate_vol_chain_np`."""
    create_chain = _oca_create_chain()
    if isinstance(value_time, str):
        import pandas as pd
        value_time = pd.Timestamp(value_time)
    chain = create_chain(
        options_data_dfs=options_data_dfs, value_time=value_time)
    if chain is None:
        return None
    return generate_vol_chain_np(chain=chain, value_time=value_time,
                                 days_map=days_map, delta_bounds=delta_bounds,
                                 is_filtered=is_filtered)


def sample_option_chain_at_times(options_data_dfs,
                                 time_period,
                                 freq: str = 'W-FRI',
                                 days_map: Optional[Dict[str, int]] = None,
                                 delta_bounds: Tuple[Optional[float], Optional[float]] = (-0.1, 0.1),
                                 hour_offset: int = 8,
                                 ) -> Dict:
    """chains on a date schedule, for time-series calibration, keyed by
    value time.  ``time_period`` is anything with ``.start``/``.end``
    timestamps (e.g. qis.TimePeriod) or a ``(start, end)`` pair."""
    import pandas as pd

    _require_oca()
    start, end = (getattr(time_period, "start", None),
                  getattr(time_period, "end", None))
    if start is None or end is None:
        start, end = time_period
    value_times = (pd.date_range(start=start, end=end, freq=freq)
                   + pd.Timedelta(hours=hour_offset))
    return {vt: load_option_chain(options_data_dfs=options_data_dfs,
                                  value_time=vt, days_map=days_map,
                                  delta_bounds=delta_bounds, is_filtered=True)
            for vt in value_times}


def load_price_data(options_data_dfs,
                    time_period=None,
                    data: str = 'close',
                    freq: Optional[str] = 'D',
                    ):
    """the underlying's price series (a pandas Series) beside the options
    data; duck-typed on ``get_spot_data()``."""
    spot_price = options_data_dfs.get_spot_data()[data]
    if freq is not None:
        spot_price = spot_price.resample(freq).last()
    if time_period is not None:
        locate = getattr(time_period, "locate", None)
        if locate is not None:
            spot_price = locate(spot_price)
        else:
            start, end = time_period
            spot_price = spot_price.loc[start:end]
    return spot_price
