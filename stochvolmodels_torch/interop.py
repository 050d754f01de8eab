"""
Carry state over from the JAX package, through plain numpy and floats only.

Nothing here imports the JAX package: callers hand over what its objects hold
(``LogSvParams.to_dict()``, ``HestonParams.to_dict()``,
``HawkesJDParams.to_dict()``, ``GmmParams.to_dict()``,
``TdistParams.to_dict()``, the ragged arrays of an ``OptionChain``, a vol
backbone Series, the uint32 QMC panels of LogSV's and Heston's Sobol
engines, two streams a step, the arrays of a ``MultiFactRateLogSvParams``),
so the same state can be fed to both packages.
"""
from __future__ import annotations

from typing import Any, Mapping, Optional, Sequence, Tuple

import numpy as np
import torch

from stochvolmodels_torch.data.option_chain import OptionChain
from stochvolmodels_torch.models.factor_hjm.rate_factor_basis import CheyettePEND, NelsonSiegel
from stochvolmodels_torch.models.factor_hjm.rate_logsv_params import (
    MultiFactRateLogSvParams,
    TermStructure,
)
from stochvolmodels_torch.models.gmm import GmmParams
from stochvolmodels_torch.models.hawkes_jd import HawkesJDParams
from stochvolmodels_torch.models.heston import HestonParams
from stochvolmodels_torch.models.logsv.params import LogSvParams
from stochvolmodels_torch.models.tdist import TdistParams
from stochvolmodels_torch.utils.funcs import SeriesLike


def params_from_numpy(d: Mapping[str, Any]) -> LogSvParams:
    """LogSvParams from the JAX package's ``LogSvParams.to_dict()``.

    A vol backbone may come as a ``(ttms, etas)`` pair or as a Series-like
    object (a pandas Series); ``LogSvParams`` reads either.
    """
    optional = lambda k: None if d.get(k) is None else np.asarray(d[k], dtype=float)
    return LogSvParams(sigma0=float(d["sigma0"]), theta=float(d["theta"]),
                       kappa1=float(d["kappa1"]),
                       kappa2=None if d.get("kappa2") is None else float(d["kappa2"]),
                       beta=float(d["beta"]), volvol=float(d["volvol"]),
                       vol_backbone=d.get("vol_backbone"), H=float(d.get("H", 0.5)),
                       weights=optional("weights"), nodes=optional("nodes"))


def heston_params_from_numpy(d) -> HestonParams:
    """HestonParams from the JAX package's ``HestonParams.to_dict()`` or from
    its ``to_array()``, [v0, theta, kappa, rho, volvol]."""
    if isinstance(d, Mapping):
        return HestonParams(**{k: float(d[k]) for k in ("v0", "theta", "kappa", "rho", "volvol")})
    v0, theta, kappa, rho, volvol = (float(v) for v in np.asarray(d, dtype=float).ravel())
    return HestonParams(v0=v0, theta=theta, kappa=kappa, rho=rho, volvol=volvol)


def hawkes_params_from_numpy(d: Mapping[str, Any]) -> HawkesJDParams:
    """HawkesJDParams from the JAX package's ``HawkesJDParams.to_dict()``;
    ``risk_premia_gamma`` may be None."""
    gamma = d.get("risk_premia_gamma")
    fields = [k for k in HawkesJDParams.__dataclass_fields__ if k != "risk_premia_gamma"]
    return HawkesJDParams(**{k: float(d[k]) for k in fields},
                          risk_premia_gamma=None if gamma is None else float(gamma))


def gmm_params_from_numpy(d: Mapping[str, Any]) -> GmmParams:
    """GmmParams from the JAX package's ``GmmParams.to_dict()``."""
    arr = lambda k: np.array(d[k], dtype=float)
    return GmmParams(gmm_weights=arr("gmm_weights"), gmm_mus=arr("gmm_mus"),
                     gmm_vols=arr("gmm_vols"), ttm=float(d["ttm"]))


def tdist_params_from_numpy(d: Mapping[str, Any]) -> TdistParams:
    """TdistParams from the JAX package's ``TdistParams.to_dict()``."""
    return TdistParams(**{k: float(d[k]) for k in ("drift", "vol", "nu", "ttm")})


def rate_params_from_numpy(d: Mapping[str, Any]) -> MultiFactRateLogSvParams:
    """MultiFactRateLogSvParams from the arrays of the JAX package's.

    ``d`` holds ``sigma0``, ``theta``, ``kappa1``, ``kappa2``, ``q`` (or
    None), the term structures ``beta_ts``/``beta_xs`` and
    ``volvol_ts``/``volvol_xs``, ``A``, ``R``, ``ccy``, and the basis:
    ``basis`` = ``"NELSON-SIEGEL"`` with ``meanrev`` and ``key_terms``, or
    ``"CHEYETTE-PEND"`` with ``mrv0``, ``mrv_delta`` and ``key_terms``;
    optionally ``vol_interpolation``.  Arrays are copied, so the two
    packages' parameters never share memory.
    """
    arr = lambda k: np.array(d[k], dtype=float)
    kind = d.get("basis", "NELSON-SIEGEL")
    if kind == "NELSON-SIEGEL":
        basis = NelsonSiegel(meanrev=float(d["meanrev"]), key_terms=arr("key_terms"))
    elif kind == "CHEYETTE-PEND":
        basis = CheyettePEND(mrv0=float(d["mrv0"]), mrv_delta=float(d["mrv_delta"]),
                             key_terms=arr("key_terms"))
    else:
        raise NotImplementedError(f"basis {kind!r}")
    q = d.get("q")
    return MultiFactRateLogSvParams(
        sigma0=float(d["sigma0"]), theta=float(d["theta"]), kappa1=float(d["kappa1"]),
        kappa2=float(d["kappa2"]),
        beta=TermStructure(ts=arr("beta_ts"), xs=arr("beta_xs")),
        volvol=TermStructure(ts=arr("volvol_ts"), xs=arr("volvol_xs")),
        A=arr("A"), R=arr("R"), basis=basis, ccy=str(d["ccy"]),
        vol_interpolation=str(d.get("vol_interpolation", "BY_YIELD")),
        q=None if q is None else float(q))


def chain_from_numpy(ttms: Sequence[float],
                     forwards: Sequence[float],
                     strikes_ttms: Sequence[np.ndarray],
                     optiontypes_ttms: Sequence[np.ndarray],
                     discfactors: Optional[Sequence[float]] = None,
                     ids: Optional[Sequence[str]] = None,
                     ticker: Optional[str] = None,
                     bid_ivs: Optional[Sequence[np.ndarray]] = None,
                     ask_ivs: Optional[Sequence[np.ndarray]] = None) -> OptionChain:
    """OptionChain from the ragged arrays of a JAX-package ``OptionChain``."""
    as_list = lambda seq: None if seq is None else [np.asarray(a) for a in seq]
    return OptionChain(ttms=np.asarray(ttms, dtype=float),
                       forwards=np.asarray(forwards, dtype=float),
                       strikes_ttms=as_list(strikes_ttms),
                       optiontypes_ttms=[np.asarray(t).astype(str) for t in optiontypes_ttms],
                       discfactors=None if discfactors is None else np.asarray(discfactors, dtype=float),
                       ids=None if ids is None else np.asarray(ids),
                       ticker=ticker, bid_ivs=as_list(bid_ivs), ask_ivs=as_list(ask_ivs))


def backbone_from_numpy(backbone) -> SeriesLike:
    """a vol backbone (the JAX package's ``pd.Series`` of etas indexed by
    ttm, or a ``(ttms, etas)`` pair) as the port's pandas-free Series-like."""
    if hasattr(backbone, "index") and hasattr(backbone, "to_numpy"):
        return SeriesLike(values=np.asarray(backbone.to_numpy(), dtype=float),
                          index=np.asarray(backbone.index, dtype=float))
    ttms, etas = backbone
    return SeriesLike(values=etas, index=ttms)


def qmc_panels_from_numpy(panels, device="cuda") -> Tuple[torch.Tensor, ...]:
    """the JAX package's ``qmc_scan_panels`` output (uint32 arrays: v_tot,
    shift_tot, v_steps, shifts) as the port's int64 tensors on ``device``."""
    return tuple(torch.as_tensor(np.asarray(p).astype(np.int64), device=device) for p in panels)
