"""
Monte-Carlo payoff evaluation for vanilla, inverse and quadratic-variance
options.

PyTorch counterpart of ``stochvolmodels_tpu/ops/payoffs.py``, computed in
float64 whatever the dtype of the simulated state:

* simulated spots are recentred on the forward before payoffs, so put-call
  parity holds across the slice;
* means and stds drop NaN paths, as ``jnp.nanmean`` and ``jnp.nanstd`` do
  (torch has no ``nanstd``: :func:`nanstd` is written here);
* the returned std is the standard error ``nanstd / sqrt(nb_path)``; with
  ``antithetic`` it is taken over the P/2 pair averages, and with
  ``nb_replicates`` R over the R replicate means (ddof 1).

:func:`mc_vars_payoff` keeps tensors (the MC calibration differentiates
through it); :func:`compute_mc_vars_payoff` returns numpy.
"""
from __future__ import annotations

import math
from typing import Tuple

import numpy as np
import torch

from stochvolmodels_torch.config import VariableType
from stochvolmodels_torch.ops.bsm import as_option_codes
from stochvolmodels_torch.utils.profiling import MC_PAYOFF_SPAN, annotate, to_device, to_host


def nanstd(a: torch.Tensor, dim: int, ddof: int = 0) -> torch.Tensor:
    """NaN-dropping standard deviation along ``dim``, as ``jnp.nanstd``:
    sum over the finite-or-inf entries of (a - nanmean)^2 over (count -
    ddof), NaN where that count is not above ``ddof``."""
    nan = torch.isnan(a)
    mean = torch.nanmean(a, dim=dim, keepdim=True)
    centered = torch.where(nan, 0.0, a - mean)
    count = (~nan).sum(dim=dim).to(a.dtype)
    var = torch.sum(centered * centered, dim=dim) / (count - ddof)
    return torch.sqrt(torch.where(count > ddof, var, torch.nan))


def _underlying(x: torch.Tensor, qvar: torch.Tensor, ttm, forward,
                variable_type: VariableType) -> Tuple[torch.Tensor, torch.Tensor]:
    """(spots recentred on the forward along the last axis, the payoff's
    underlying): the spots for LOG_RETURN, annualised qvar for Q_VAR."""
    spots = forward * torch.exp(x)
    spots = spots - (torch.nanmean(spots, dim=-1, keepdim=True) - forward)
    if variable_type == VariableType.LOG_RETURN:
        return spots, spots
    if variable_type == VariableType.Q_VAR:
        return spots, qvar / ttm
    raise NotImplementedError(f"variable_type={variable_type}")


def _payoffs(u: torch.Tensor, spots: torch.Tensor, strikes: torch.Tensor,
             codes: torch.Tensor) -> torch.Tensor:
    """(K, ...) payoffs of calls and puts (inverse: over the spot) on the
    underlying ``u`` (...), strikes and codes (K,)."""
    extra = (None,) * u.dim()
    k = strikes[(slice(None),) + extra]
    c = codes[(slice(None),) + extra]
    is_call = (c & 1).to(torch.bool)
    is_inverse = (c & 2).to(torch.bool)
    call_pay = torch.where(u > k, u - k, 0.0)
    put_pay = torch.where(u < k, k - u, 0.0)
    payoff = torch.where(is_call, call_pay, put_pay)
    return torch.where(is_inverse, payoff / spots, payoff)


@annotate(MC_PAYOFF_SPAN)
def mc_vars_payoff(x0: torch.Tensor,
                   qvar0: torch.Tensor,
                   ttm,
                   forward,
                   strikes: torch.Tensor,
                   codes: torch.Tensor,
                   discfactor=1.0,
                   variable_type: VariableType = VariableType.LOG_RETURN,
                   antithetic: bool = False,
                   nb_replicates: int = 0
                   ) -> Tuple[torch.Tensor, torch.Tensor]:
    """(discounted mean payoff, standard error) per strike, as float64
    tensors that carry the gradients of the paths and of ``forward``.

    ``strikes`` (K,) float64 and ``codes`` (K,) int8 on the paths' device;
    ``ttm``, ``forward`` and ``discfactor`` are floats or 0-dim tensors.
    ``antithetic``: path i and i + P/2 are a pair, the stderr is over the
    pair averages.  ``nb_replicates`` R > 1: the paths are R contiguous
    replicate groups, each recentred on its own, the price is the mean of
    the replicate means and the stderr their std (ddof 1) over sqrt(R).
    """
    if antithetic and nb_replicates > 1:
        raise NotImplementedError("antithetic pairing and QMC replicates are mutually "
                                  "exclusive reductions")
    x = x0.to(torch.float64)
    qvar = qvar0.to(torch.float64)
    nb_path = x.shape[0]
    if nb_replicates > 1:
        if nb_path % nb_replicates:
            raise ValueError(f"nb_path={nb_path} not divisible by nb_replicates={nb_replicates}")
        x = x.reshape(nb_replicates, -1)
        qvar = qvar.reshape(nb_replicates, -1)
    spots, u = _underlying(x, qvar, ttm, forward, variable_type)
    payoff = _payoffs(u, spots, strikes, codes)
    if nb_replicates > 1:
        rep_means = torch.nanmean(payoff, dim=2)                     # (K, R)
        return (discfactor * torch.nanmean(rep_means, dim=1),
                discfactor * nanstd(rep_means, dim=1, ddof=1) / math.sqrt(nb_replicates))
    if antithetic:
        half = nb_path // 2
        payoff = 0.5 * (payoff[:, :half] + payoff[:, half:])
        nb_path = half
    return (discfactor * torch.nanmean(payoff, dim=1),
            discfactor * nanstd(payoff, dim=1) / math.sqrt(nb_path))


def compute_mc_vars_payoff(x0: torch.Tensor,
                           sigma0: torch.Tensor,
                           qvar0: torch.Tensor,
                           ttm: float,
                           forward: float,
                           strikes_ttm,
                           optiontypes_ttm,
                           discfactor: float = 1.0,
                           variable_type: VariableType = VariableType.LOG_RETURN,
                           antithetic: bool = False,
                           nb_replicates: int = 0
                           ) -> Tuple[np.ndarray, np.ndarray]:
    """discounted mean payoff and standard error per strike for one slice,
    as numpy ((K,), (K,)).

    ``x0``/``qvar0``: terminal log-return and quadratic variance paths
    (nb_path,); ``sigma0`` is accepted for signature symmetry and unused.
    The reductions are those of :func:`mc_vars_payoff`.  Strikes and string
    option types go up and the results come back through
    ``utils/profiling``'s transfers: four a slice.
    """
    del sigma0
    device = x0.device
    strikes = to_device(np.asarray(strikes_ttm, dtype=np.float64), torch.float64, device)
    codes = as_option_codes(optiontypes_ttm, device)
    prices, stds = mc_vars_payoff(x0, qvar0, float(ttm), float(forward), strikes, codes,
                                  discfactor=float(discfactor), variable_type=variable_type,
                                  antithetic=antithetic, nb_replicates=nb_replicates)
    return to_host(prices), to_host(stds)
