"""
Option-chain containers.

PyTorch counterpart of ``stochvolmodels_tpu/data/option_chain.py``: the
user-facing :class:`OptionChain` keeps ragged per-maturity numpy lists, and
lowers to a dense padded :class:`ChainGrid` of tensors on a chosen device —
(n_ttm, max_strikes) panels with a validity mask.  Padded strike slots carry
the slice forward (log-moneyness 0, always finite) and a call code.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import List, Optional, Sequence, Tuple

import numpy as np
import torch

from stochvolmodels_torch.config import encode_optiontypes
from stochvolmodels_torch.ops import bachelier as bachel
from stochvolmodels_torch.ops import bsm
from stochvolmodels_torch.utils.funcs import SeriesLike, npad, to_series, unpad
from stochvolmodels_torch.utils.profiling import to_device
from stochvolmodels_torch.utils.var_swap import compute_var_swap_strike


@dataclass(frozen=True)
class ChainGrid:
    """dense padded chain panel.

    ``strikes``/``optioncodes``/``mask`` have shape (n_ttm, max_strikes), the
    rest (n_ttm,).  Floats are float64, codes int8, mask bool.
    """
    ttms: torch.Tensor
    forwards: torch.Tensor
    discfactors: torch.Tensor
    strikes: torch.Tensor
    optioncodes: torch.Tensor  # int8; bit0=is_call, bit1=is_inverse
    mask: torch.Tensor         # bool, True on real quotes

    @property
    def device(self) -> torch.device:
        return self.strikes.device

    @property
    def n_ttms(self) -> int:
        return self.ttms.shape[0]

    @property
    def max_strikes(self) -> int:
        return self.strikes.shape[1]

    def masked(self, panel: torch.Tensor, fill: float = float("nan")) -> torch.Tensor:
        """the (n_ttm, max_strikes) result panel with ``fill`` on padded slots."""
        return torch.where(self.mask, panel, fill)

    def to(self, device) -> "ChainGrid":
        """the same grid with every tensor on ``device``."""
        return ChainGrid(ttms=self.ttms.to(device), forwards=self.forwards.to(device),
                         discfactors=self.discfactors.to(device),
                         strikes=self.strikes.to(device),
                         optioncodes=self.optioncodes.to(device),
                         mask=self.mask.to(device))


@dataclass
class OptionSlice:
    """single-maturity container."""
    ttm: float
    forward: float
    strikes: np.ndarray
    optiontypes: np.ndarray
    id: str
    discfactor: Optional[float] = None
    discount_rate: Optional[float] = None
    bid_ivs: Optional[np.ndarray] = None
    ask_ivs: Optional[np.ndarray] = None
    bid_prices: Optional[np.ndarray] = None
    ask_prices: Optional[np.ndarray] = None

    def __post_init__(self):
        if self.discfactor is not None:
            self.discount_rate = -np.log(self.discfactor) / self.ttm
        elif self.discount_rate is not None:
            self.discfactor = np.exp(-self.discount_rate * self.ttm)
        else:
            self.discfactor = 1.0
            self.discount_rate = 0.0


@dataclass
class OptionChain:
    """chain of ragged per-maturity numpy arrays; ``to_grid`` lowers it to tensors."""
    ttms: np.ndarray
    forwards: np.ndarray
    strikes_ttms: Sequence[np.ndarray]
    optiontypes_ttms: Sequence[np.ndarray]
    ids: Optional[np.ndarray] = None
    discfactors: Optional[np.ndarray] = None
    discount_rates: Optional[np.ndarray] = None
    ticker: Optional[str] = None
    bid_ivs: Optional[Sequence[np.ndarray]] = None
    ask_ivs: Optional[Sequence[np.ndarray]] = None
    bid_prices: Optional[Sequence[np.ndarray]] = None
    ask_prices: Optional[Sequence[np.ndarray]] = None
    forwards0: Optional[np.ndarray] = None

    def __post_init__(self):
        self.ttms = np.asarray(self.ttms, dtype=float)
        self.forwards = np.asarray(self.forwards, dtype=float)
        self.strikes_ttms = [np.asarray(s, dtype=float) for s in self.strikes_ttms]
        self.optiontypes_ttms = [np.asarray(t) for t in self.optiontypes_ttms]
        if self.ids is None:
            self.ids = np.array([f"{ttm:0.2f}" for ttm in self.ttms])
        if self.discfactors is not None:
            self.discfactors = np.asarray(self.discfactors, dtype=float)
            self.discount_rates = -np.log(self.discfactors) / self.ttms
        elif self.discount_rates is not None:
            self.discount_rates = np.asarray(self.discount_rates, dtype=float)
            self.discfactors = np.exp(-self.discount_rates * self.ttms)
        else:
            self.discfactors = np.ones_like(self.ttms)
            self.discount_rates = np.zeros_like(self.ttms)

    def to_grid(self, device="cuda") -> ChainGrid:
        """lower to the dense padded panel on ``device``."""
        strikes, mask = npad(self.strikes_ttms, pad_value=np.nan)
        # pad strikes with the row forward: log-moneyness 0, always finite
        strikes = np.where(mask, strikes, self.forwards[:, None])
        codes, _ = npad([encode_optiontypes(t) for t in self.optiontypes_ttms],
                        pad_value=1)  # pad as calls
        f64 = lambda a: to_device(np.asarray(a, dtype=np.float64), torch.float64, device)
        return ChainGrid(ttms=f64(self.ttms), forwards=f64(self.forwards),
                         discfactors=f64(self.discfactors), strikes=f64(strikes),
                         optioncodes=to_device(codes.astype(np.int8), torch.int8, device),
                         mask=to_device(mask, torch.bool, device))

    def unpad_panel(self, panel) -> List[np.ndarray]:
        """split a (n_ttm, max_strikes) panel (tensor or array) into the ragged list."""
        if isinstance(panel, torch.Tensor):
            panel = panel.detach().cpu().numpy()
        _, mask = npad(self.strikes_ttms, pad_value=np.nan)
        return unpad(np.asarray(panel), mask)

    @classmethod
    def slice_to_chain(cls, ttm: float, forward: float, strikes: np.ndarray,
                       optiontypes: np.ndarray, discfactor: float = 1.0,
                       id: Optional[str] = None) -> "OptionChain":
        """single-slice chain from raw arrays."""
        return cls(ttms=np.array([ttm]), forwards=np.array([forward]),
                   strikes_ttms=[np.asarray(strikes)],
                   optiontypes_ttms=[np.asarray(optiontypes)],
                   discfactors=np.array([discfactor]),
                   ids=np.array([id]) if id is not None else np.array([f"{ttm:0.2f}"]))

    @classmethod
    def get_uniform_chain(cls,
                          ttms: np.ndarray = np.array([0.083, 0.25]),
                          ids: np.ndarray = np.array(['1m', '3m']),
                          forwards: np.ndarray = np.array([1.0, 1.0]),
                          strikes: np.ndarray = np.linspace(0.9, 1.1, 3),
                          flat_vol: float = 0.2
                          ) -> "OptionChain":
        """synthetic chain: the same strikes at every maturity, flat bid and
        ask vols, calls at and above the forward and puts below."""
        return cls(ttms=ttms, ids=ids, forwards=forwards,
                   strikes_ttms=[strikes for _ in ttms],
                   bid_ivs=[flat_vol * np.ones_like(strikes) for _ in ttms],
                   ask_ivs=[flat_vol * np.ones_like(strikes) for _ in ttms],
                   optiontypes_ttms=[np.where(strikes >= forward, 'C', 'P')
                                     for forward in forwards])

    @classmethod
    def to_uniform_strikes(cls, obj: "OptionChain", num_strikes: int = 21) -> "OptionChain":
        """the chain re-gridded to ``num_strikes`` uniform strikes between each
        slice's first and last, calls at and above the forward; no quotes."""
        new_strikes_ttms, new_optiontypes_ttms = [], []
        for strikes_ttm, forward in zip(obj.strikes_ttms, obj.forwards):
            new_strikes = np.linspace(strikes_ttm[0], strikes_ttm[-1], num_strikes)
            new_strikes_ttms.append(new_strikes)
            new_optiontypes_ttms.append(np.where(new_strikes >= forward, 'C', 'P'))
        return cls(ttms=obj.ttms, forwards=obj.forwards, strikes_ttms=new_strikes_ttms,
                   optiontypes_ttms=new_optiontypes_ttms, discfactors=obj.discfactors,
                   ticker=obj.ticker, ids=obj.ids, bid_ivs=None, ask_ivs=None)

    @classmethod
    def to_forward_normalised_strikes(cls, obj: "OptionChain") -> "OptionChain":
        """the chain with strikes divided by their forwards and unit forwards;
        the old forwards are kept as ``forwards0``."""
        return cls(ttms=obj.ttms, forwards=np.ones_like(obj.forwards),
                   strikes_ttms=[s / f for s, f in zip(obj.strikes_ttms, obj.forwards)],
                   optiontypes_ttms=obj.optiontypes_ttms, discfactors=obj.discfactors,
                   ticker=obj.ticker, ids=obj.ids, bid_ivs=obj.bid_ivs, ask_ivs=obj.ask_ivs,
                   forwards0=obj.forwards)

    @classmethod
    def get_slices_as_chain(cls, option_chain: "OptionChain", ids) -> "OptionChain":
        """the sub-chain of the slices with the given ids, in that order."""
        indices = [list(option_chain.ids).index(id_) for id_ in ids]
        pick = lambda seq: None if seq is None else [seq[i] for i in indices]
        return cls(ids=np.asarray(ids), ttms=option_chain.ttms[indices],
                   ticker=option_chain.ticker, forwards=option_chain.forwards[indices],
                   strikes_ttms=pick(option_chain.strikes_ttms),
                   optiontypes_ttms=pick(option_chain.optiontypes_ttms),
                   discfactors=option_chain.discfactors[indices],
                   bid_ivs=pick(option_chain.bid_ivs), ask_ivs=pick(option_chain.ask_ivs),
                   bid_prices=pick(option_chain.bid_prices),
                   ask_prices=pick(option_chain.ask_prices))

    def get_slice(self, id: str) -> OptionSlice:
        """the :class:`OptionSlice` with the given id."""
        idx = list(self.ids).index(id)
        g = lambda seq: None if seq is None else seq[idx]
        return OptionSlice(id=self.ids[idx], ttm=self.ttms[idx], forward=self.forwards[idx],
                           strikes=self.strikes_ttms[idx], optiontypes=self.optiontypes_ttms[idx],
                           discfactor=self.discfactors[idx], bid_ivs=g(self.bid_ivs),
                           ask_ivs=g(self.ask_ivs), bid_prices=g(self.bid_prices),
                           ask_prices=g(self.ask_prices))

    def print(self) -> None:
        """print the chain's maturities, forwards, strikes, types, ids and vols."""
        for k in ('ttms', 'forwards', 'strikes_ttms', 'optiontypes_ttms', 'ids',
                  'bid_ivs', 'ask_ivs'):
            print(f"{k}:\n{getattr(self, k)}")

    def get_mid_vols(self) -> Optional[List[np.ndarray]]:
        """per-slice mid implied vols, the average of bid and ask (None
        without both)."""
        if self.bid_ivs is not None and self.ask_ivs is not None:
            return [0.5 * (b + a) for b, a in zip(self.bid_ivs, self.ask_ivs)]
        return None

    def get_chain_data_as_xy(self) -> Tuple[tuple, List[np.ndarray]]:
        """(x, y) for calibration: the chain's coordinates (ttms, forwards,
        discount factors, strikes, option types) and its mid vols."""
        mid_vols = [0.5 * (b + a) for b, a in zip(self.bid_ivs, self.ask_ivs)]
        x = (self.ttms, self.forwards, self.discfactors, self.strikes_ttms,
             self.optiontypes_ttms)
        return x, mid_vols

    def get_chain_vegas(self, is_unit_ttm_vega: bool = False) -> List[np.ndarray]:
        """BSM vegas per slice at the mid vols, the calibration weights; with
        ``is_unit_ttm_vega`` every slice takes ttm 1.  Numpy in and out: the
        port's vega runs on host tensors."""
        ttms = np.ones_like(self.ttms) if is_unit_ttm_vega else self.ttms
        host = lambda a: torch.as_tensor(np.asarray(a, dtype=np.float64))
        return [bsm.compute_bsm_vanilla_vega(ttm=host(ttm), forward=host(fwd),
                                             strike=host(strikes), vol=host(vols)).numpy()
                for ttm, fwd, strikes, vols in zip(ttms, self.forwards, self.strikes_ttms,
                                                   self.get_mid_vols())]

    def get_chain_deltas(self) -> List[np.ndarray]:
        """BSM deltas per slice at the mid vols (undiscounted), numpy in and
        out: the port's delta runs on host tensors."""
        host = lambda a: torch.as_tensor(np.asarray(a, dtype=np.float64))
        return [bsm.compute_bsm_vanilla_delta(ttm=host(ttm), forward=host(fwd),
                                              strike=host(strikes), vol=host(vols),
                                              optiontype=types).numpy()
                for ttm, fwd, strikes, types, vols in zip(
                    self.ttms, self.forwards, self.strikes_ttms, self.optiontypes_ttms,
                    self.get_mid_vols())]

    def get_chain_skews(self, delta: float = 0.25) -> np.ndarray:
        """skew per slice: (vol at -delta - vol at +delta) / vol at 0.5,
        the vols interpolated against the BSM deltas."""
        skews = np.zeros(len(self.ttms))
        for idx, (deltas, vols) in enumerate(zip(self.get_chain_deltas(), self.get_mid_vols())):
            dput = np.interp(x=-delta, xp=deltas, fp=vols)
            d50 = np.interp(x=0.5, xp=deltas, fp=vols)
            dcall = np.interp(x=delta, xp=deltas, fp=vols)
            skews[idx] = (dput - dcall) / d50
        return skews

    def get_chain_atm_vols(self) -> np.ndarray:
        """ATM vol per slice: the mid vols interpolated to the forward."""
        return np.array([np.interp(x=forward, xp=strikes, fp=vols) for forward, strikes, vols
                         in zip(self.forwards, self.strikes_ttms, self.get_mid_vols())])

    def get_slice_varswap_strikes(self, floor_with_atm_vols: bool = True):
        """varswap strike per maturity from the option strip at the mid vols,
        floored at the ATM vols by default, indexed by ttm: a pandas Series
        as in the JAX package (:func:`to_series`)."""
        host = lambda a: torch.as_tensor(np.asarray(a, dtype=np.float64))
        varswap_strikes = np.zeros_like(self.ttms)
        for idx, (ttm, vols) in enumerate(zip(self.ttms, self.get_mid_vols())):
            strikes, types = self.strikes_ttms[idx], self.optiontypes_ttms[idx]
            mid_prices = bsm.compute_bsm_vanilla_price(
                forward=host(self.forwards[idx]), strike=host(strikes), ttm=host(ttm),
                vol=host(vols), optiontype=types).numpy()
            puts = types == 'P'
            varswap_strikes[idx] = compute_var_swap_strike(
                put_strikes=strikes[puts], put_prices=mid_prices[puts],
                call_strikes=strikes[~puts], call_prices=mid_prices[~puts],
                forward=self.forwards[idx], ttm=ttm)
        if floor_with_atm_vols:
            varswap_strikes = np.maximum(self.get_chain_atm_vols(), varswap_strikes)
        return to_series(varswap_strikes, self.ttms)

    def compute_model_ivols_from_chain_data(self, model_prices,
                                            forwards: np.ndarray = None,
                                            device="cuda") -> List[np.ndarray]:
        """invert model prices to BSM ivols on ``device``.

        ``model_prices`` may be the ragged list or a padded (T, K) panel.
        """
        if forwards is None:
            forwards = self.forwards
        if isinstance(model_prices, (list, tuple)):
            model_prices, _ = npad([np.asarray(p) for p in model_prices], pad_value=np.nan)
        prices_panel = torch.as_tensor(model_prices, dtype=torch.float64, device=device)
        grid = self.to_grid(device=device)
        ivols = bsm.infer_bsm_ivols_from_model_chain_prices(
            ttms=grid.ttms, forwards=torch.as_tensor(np.asarray(forwards, dtype=np.float64),
                                                     device=device),
            discfactors=grid.discfactors, strikes_ttms=grid.strikes,
            optiontypes_ttms=grid.optioncodes, model_prices_ttms=prices_panel)
        return self.unpad_panel(ivols)


@dataclass
class SwOptionChain:
    """swaption cube container: expiries x swap tenors x strikes, the
    counterpart of the JAX package's ``SwOptionChain`` (host numpy)."""
    ccy: str
    ttms: np.ndarray
    tenors: np.ndarray
    ttms_ids: Sequence[str]
    tenors_ids: Sequence[str]
    forwards: Sequence[np.ndarray]
    strikes_ttms: Sequence[Sequence[np.ndarray]]
    bid_ivs: Sequence[Sequence[np.ndarray]]
    ask_ivs: Sequence[Sequence[np.ndarray]]
    ticker: Optional[str] = None

    def __post_init__(self):
        assert self.ttms.size == len(self.ttms_ids)
        assert self.tenors.size == len(self.tenors_ids)
        assert np.all(np.diff(self.ttms) >= 0) and np.all(self.ttms >= 0)
        assert np.all(np.diff(self.tenors) >= 0) and np.all(self.tenors >= 0)
        self.optiontypes_ttms = tuple(np.repeat('C', self.strikes_ttms[0][0].size)
                                      for _ in self.ttms)
        assert len(self.strikes_ttms) == len(self.tenors_ids)
        assert len(self.bid_ivs) == len(self.ask_ivs) == len(self.tenors_ids)
        assert len(self.strikes_ttms[0]) == len(self.ttms_ids)
        assert self.strikes_ttms[0][0].ndim == 1
        assert (len(self.forwards) == len(self.tenors_ids)
                and self.forwards[0].size == len(self.ttms_ids))
        for i in range(len(self.tenors_ids)):
            for j in range(len(self.ttms_ids)):
                assert self.strikes_ttms[i][j].size == self.strikes_ttms[0][0].size
                assert self.bid_ivs[i][j].size == self.ask_ivs[0][0].size

    @classmethod
    def create_swaption_chain_MF(cls, ccy: str, tenors: np.ndarray, tenors_ids,
                                 ttms: np.ndarray, ttms_ids, forwards,
                                 strikes_ttms, ivs, ticker: str) -> "SwOptionChain":
        """build a cube from model data, re-centring strikes on the flat-curve
        par rates (option_chain.py:382-416)."""
        from stochvolmodels_torch.utils.rate_core import (
            get_default_swap_term_structure,
            swap_rate,
        )
        for idx_tenor, tenor in enumerate(tenors):
            for idx_ttm, ttm in enumerate(ttms):
                ts_sw = get_default_swap_term_structure(ttm, tenor)
                par = swap_rate(ccy, ttm, ts_sw)
                strikes_ttms[idx_tenor][idx_ttm] = (strikes_ttms[idx_tenor][idx_ttm]
                                                    - forwards[idx_tenor][idx_ttm] + par)
                forwards[idx_tenor][idx_ttm] = par
        return cls(ccy=ccy, ttms=ttms, tenors=tenors, ttms_ids=ttms_ids,
                   tenors_ids=tenors_ids, forwards=forwards,
                   strikes_ttms=strikes_ttms, bid_ivs=ivs, ask_ivs=ivs,
                   ticker=ticker)

    def get_mid_vols(self):
        return [[0.5 * (self.bid_ivs[i][j] + self.ask_ivs[i][j])
                 for j in range(len(self.ttms_ids))]
                for i in range(len(self.tenors_ids))]

    def get_chain_atm_vols(self):
        atm_vols = []
        for forwards_tenor, strikes_tenor, vols_tenor in zip(self.forwards,
                                                             self.strikes_ttms,
                                                             self.get_mid_vols()):
            atm = np.array([np.interp(x=f, xp=s, fp=v) for f, s, v in
                            zip(forwards_tenor, strikes_tenor, vols_tenor)])
            atm_vols.append(atm)
        return atm_vols

    def get_chain_vegas(self, is_unit_ttm_vega: bool = False):
        """normal vegas [tenor][expiry] at the mid vols; numpy in and out:
        the port's vega runs on host tensors."""
        ttms = np.ones_like(self.ttms) if is_unit_ttm_vega else self.ttms
        host = lambda a: torch.as_tensor(np.asarray(a, dtype=np.float64))
        vegas_chain = []
        for forwards, strikes_ttms, mid_vols in zip(self.forwards,
                                                    self.strikes_ttms,
                                                    self.get_mid_vols()):
            vegas = [bachel.compute_normal_slice_vegas(
                ttm=host(t), forward=host(f), strikes=host(s), vols=host(v)).numpy()
                for t, f, s, v in zip(ttms, forwards, strikes_ttms, mid_vols)]
            vegas_chain.append(vegas)
        return vegas_chain

    def reduce_strikes(self, nb_otms: int) -> "SwOptionChain":
        """keep nb_otms OTM strikes either side of ATM (option_chain.py:418-441)."""
        nb_strikes = int((self.strikes_ttms[0][0].size - 1) / 2)
        if nb_otms > nb_strikes:
            raise ValueError(f"nb_otms={nb_otms} > otm strikes={nb_strikes}")
        rng = range(nb_strikes - nb_otms, nb_strikes + nb_otms + 1)
        pick = lambda seq: [[seq[i][j][rng] for j in range(len(self.ttms_ids))]
                            for i in range(len(self.tenors_ids))]
        return SwOptionChain(ccy=self.ccy, ttms=self.ttms, tenors=self.tenors,
                             ttms_ids=self.ttms_ids, tenors_ids=self.tenors_ids,
                             forwards=self.forwards,
                             strikes_ttms=pick(self.strikes_ttms),
                             bid_ivs=pick(self.bid_ivs),
                             ask_ivs=pick(self.ask_ivs), ticker=self.ticker)

    def reduce_ttms(self, ttms_ids) -> "SwOptionChain":
        """restrict the cube to the listed expiry ids (option_chain.py:443-467)."""
        if not np.all(np.isin(ttms_ids, self.ttms_ids)):
            raise ValueError("Expiries to be removed not present in chain")
        idx_ttms = np.where(np.isin(self.ttms_ids, ttms_ids))[0]
        pick = lambda seq: [[seq[i][j] for j in idx_ttms]
                            for i in range(len(self.tenors_ids))]
        forwards = [np.array([self.forwards[i][j] for j in idx_ttms])
                    for i in range(len(self.tenors_ids))]
        return SwOptionChain(ccy=self.ccy, ttms=self.ttms[idx_ttms],
                             tenors=self.tenors, ttms_ids=list(ttms_ids),
                             tenors_ids=self.tenors_ids, forwards=forwards,
                             strikes_ttms=pick(self.strikes_ttms),
                             bid_ivs=pick(self.bid_ivs),
                             ask_ivs=pick(self.ask_ivs), ticker=self.ticker)

    def reduce_tenors(self, tenors_ids) -> "SwOptionChain":
        """restrict the cube to the listed tenor ids (option_chain.py:469-493)."""
        if not np.all(np.isin(tenors_ids, self.tenors_ids)):
            raise ValueError("Tenors to be removed not present in chain")
        idx_tenors = np.where(np.isin(self.tenors_ids, tenors_ids))[0]
        pick = lambda seq: [[seq[i][j] for j in range(len(self.ttms_ids))]
                            for i in idx_tenors]
        forwards = [np.asarray(self.forwards[i]) for i in idx_tenors]
        return SwOptionChain(ccy=self.ccy, ttms=self.ttms,
                             tenors=self.tenors[idx_tenors],
                             ttms_ids=self.ttms_ids,
                             tenors_ids=[self.tenors_ids[i] for i in idx_tenors],
                             forwards=forwards,
                             strikes_ttms=pick(self.strikes_ttms),
                             bid_ivs=pick(self.bid_ivs),
                             ask_ivs=pick(self.ask_ivs), ticker=self.ticker)

    @classmethod
    def remap_to_inc_delta(cls, vols):
        """negate the delta index of ``vols`` (a pandas Series or a
        :class:`SeriesLike`) in place, and return it."""
        index = [-x for x in vols.index]
        vols.index = np.asarray(index, dtype=float) if isinstance(vols, SeriesLike) else index
        return vols

    @classmethod
    def remap_to_pc_delta(cls, inc_grid: np.ndarray) -> np.ndarray:
        put_cond = inc_grid < -0.5
        call_cond = inc_grid >= -0.5
        return np.concatenate((-inc_grid[put_cond] - 1.0, -inc_grid[call_cond]))


@dataclass
class FutOptionChain:
    """futures option chain with optional open-interest filtering, the
    counterpart of the JAX package's ``FutOptionChain`` (host numpy)."""
    ccy: str
    ttms: np.ndarray
    forwards: np.ndarray
    strikes_ttms: Sequence[np.ndarray]
    ttms_ids: Optional[np.ndarray]
    ivs_call_ttms: Sequence[np.ndarray]
    ivs_put_ttms: Sequence[np.ndarray]
    ticker: Optional[str] = None
    call_oi: Optional[Sequence[np.ndarray]] = None
    put_oi: Optional[Sequence[np.ndarray]] = None
    call_vol: Optional[Sequence[np.ndarray]] = None
    put_vol: Optional[Sequence[np.ndarray]] = None

    def __post_init__(self):
        assert self.ttms.size == len(self.ttms_ids)
        assert np.all(np.diff(self.ttms) >= 0) and np.all(self.ttms >= 0)
        self.optiontypes_ttms = tuple(np.repeat('C', self.strikes_ttms[i].size)
                                      for i in range(len(self.ttms)))
        assert all(c.shape == p.shape for c, p in zip(self.ivs_call_ttms, self.ivs_put_ttms))
        assert len(self.ivs_call_ttms) == self.ttms.size
        assert self.ttms.shape == self.forwards.shape
        assert all(np.asarray(s).ndim == 1 for s in self.strikes_ttms)
        assert (self.call_oi is None) == (self.put_oi is None)
        assert (self.call_vol is None) == (self.put_vol is None)

    def filter_by_oi(self, max_strikes: int, include_atm: bool) -> "FutOptionChain":
        """keep the ``max_strikes`` strikes of each expiry with the largest
        open interest (calls and puts), in strike order; with
        ``include_atm`` the middle strike must be among them."""
        if self.call_oi is None:
            raise NotImplementedError("call/put open interest cannot be None")
        mid_idx = int(0.5 * (self.strikes_ttms[0].size - 1))
        strikes_l, ivc_l, ivp_l, coi_l, poi_l = [], [], [], [], []
        for idx_ttm in range(len(self.ttms)):
            oi = self.call_oi[idx_ttm] + self.put_oi[idx_ttm]
            idxs = oi.argsort()[-max_strikes:][::-1]
            if include_atm and mid_idx not in idxs:
                raise ValueError(f"atm strike not found among top {max_strikes} liquid options")
            idxs = np.sort(idxs)
            strikes_l.append(self.strikes_ttms[idx_ttm][idxs])
            ivc_l.append(self.ivs_call_ttms[idx_ttm][idxs])
            ivp_l.append(self.ivs_put_ttms[idx_ttm][idxs])
            coi_l.append(self.call_oi[idx_ttm][idxs])
            poi_l.append(self.put_oi[idx_ttm][idxs])
        return FutOptionChain(ccy=self.ccy, ttms=self.ttms, forwards=self.forwards,
                              strikes_ttms=np.array(strikes_l), ivs_call_ttms=np.array(ivc_l),
                              ivs_put_ttms=np.array(ivp_l), ttms_ids=self.ttms_ids,
                              call_oi=coi_l, put_oi=poi_l, ticker=self.ticker)

    def get_mid_vols(self):
        return self.ivs_call_ttms

    def get_chain_vegas(self, device="cuda") -> List[np.ndarray]:
        """normal vegas of each expiry's strikes at the call vols, computed
        on ``device``."""
        f64 = lambda a: torch.as_tensor(np.asarray(a, dtype=np.float64), device=device)
        return [bachel.compute_normal_slice_vegas(ttm=f64(t), forward=f, strikes=s,
                                                  vols=v).cpu().numpy()
                for t, f, s, v in zip(self.ttms, self.forwards, self.strikes_ttms,
                                      self.ivs_call_ttms)]

    def reduce_ttms(self, ttms_ids) -> "FutOptionChain":
        """restrict the chain to the listed expiry ids."""
        if not np.all(np.isin(ttms_ids, self.ttms_ids)):
            raise ValueError("Expiries to be removed not present in chain")
        idx_ttms = np.where(np.isin(self.ttms_ids, ttms_ids))[0]
        assert self.call_oi is None and self.call_vol is None
        return FutOptionChain(ccy=self.ccy, ttms=self.ttms[idx_ttms],
                              forwards=self.forwards[idx_ttms],
                              strikes_ttms=[self.strikes_ttms[i] for i in idx_ttms],
                              ttms_ids=ttms_ids,
                              ivs_put_ttms=[self.ivs_put_ttms[i] for i in idx_ttms],
                              ivs_call_ttms=[self.ivs_call_ttms[i] for i in idx_ttms],
                              ticker=self.ticker)
