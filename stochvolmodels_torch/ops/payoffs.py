"""
Monte-Carlo payoff evaluation for vanilla and inverse options.

PyTorch counterpart of ``stochvolmodels_tpu/ops/payoffs.py`` for the plain
estimator, computed in float64 whatever the dtype of the simulated state:

* simulated spots are recentred on the forward before payoffs, so put-call
  parity holds across the slice;
* means and stds drop NaN paths;
* the returned std is the standard error ``nanstd / sqrt(nb_path)``.
"""
from __future__ import annotations

import math
from typing import Tuple

import numpy as np
import torch

from stochvolmodels_torch.config import VariableType
from stochvolmodels_torch.ops.bsm import as_option_codes


def _nanmean_nanstd(a: torch.Tensor, dim: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """NaN-dropping mean and population std (ddof=0) along ``dim``."""
    mean = torch.nanmean(a, dim=dim, keepdim=True)
    count = (~torch.isnan(a)).sum(dim=dim, keepdim=True)
    var = torch.nansum(torch.square(a - mean), dim=dim, keepdim=True) / count
    return mean.squeeze(dim), torch.sqrt(var).squeeze(dim)


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
    """discounted mean payoff and standard error per strike for one slice.

    ``x0``/``qvar0``: terminal log-return and quadratic variance paths
    (nb_path,); ``sigma0`` is accepted for signature symmetry and unused.
    Returns numpy ((K,), (K,)).  The antithetic and QMC-replicate estimators
    are not ported.
    """
    del sigma0
    if antithetic or nb_replicates > 1:
        raise NotImplementedError("only the plain estimator is ported")
    device = x0.device
    x = x0.to(torch.float64)
    spots_t = float(forward) * torch.exp(x)
    correction = torch.nanmean(spots_t) - float(forward)
    spots_t = spots_t - correction

    if variable_type == VariableType.LOG_RETURN:
        underlying_t = spots_t
    elif variable_type == VariableType.Q_VAR:
        underlying_t = qvar0.to(torch.float64) / float(ttm)
    else:
        raise NotImplementedError(f"variable_type={variable_type}")

    strikes = torch.as_tensor(np.asarray(strikes_ttm, dtype=np.float64), device=device)[:, None]
    codes = as_option_codes(optiontypes_ttm, device)[:, None]
    is_call = (codes & 1).to(torch.bool)
    is_inverse = (codes & 2).to(torch.bool)

    u = underlying_t[None, :]                                  # (1, P)
    call_pay = torch.where(u > strikes, u - strikes, 0.0)
    put_pay = torch.where(u < strikes, strikes - u, 0.0)
    payoff = torch.where(is_call, call_pay, put_pay)
    payoff = torch.where(is_inverse, payoff / spots_t[None, :], payoff)

    mean, std = _nanmean_nanstd(payoff, dim=1)
    option_prices = discfactor * mean
    option_std = discfactor * std / math.sqrt(x0.shape[0])
    return option_prices.cpu().numpy(), option_std.cpu().numpy()
