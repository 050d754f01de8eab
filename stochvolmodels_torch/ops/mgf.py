"""
Transform-pricing engine: Fourier inversion of payoffs against a log-MGF grid.

PyTorch counterpart of ``stochvolmodels_tpu/ops/mgf.py`` for the log-return
vanilla pricer.  Complex values are native complex128.  The composite-Simpson
weights keep the reference's even-length quirk (the last point of an
even-length grid keeps weight 4), which is baked into its prices.
"""
from __future__ import annotations

import math
from typing import Tuple

import numpy as np
import torch

from stochvolmodels_torch.config import VariableType
from stochvolmodels_torch.ops.bsm import as_option_codes

PHI_POINTS = 1000


def get_phi_grid(is_spot_measure: bool = True, max_phi: int = PHI_POINTS,
                 vol_scaler: float = 0.28, device="cpu") -> torch.Tensor:
    """log-price transform grid phi = real_p + i p, p in [0, 5.6/vol_scaler].

    The real part is -0.5 under the spot measure and +0.5 under the inverse
    measure.  ``p`` is built as ``k * (stop / (n-1))`` with the end point set
    to ``stop``: the rounding of ``np.linspace`` and of ``jnp.linspace`` as
    XLA compiles it, so the grids agree bit for bit.
    """
    real_p = -0.5 if is_spot_measure else 0.5
    stop = 5.6 / float(vol_scaler)
    div = max_phi - 1
    p = torch.cat([torch.arange(div, dtype=torch.float64, device=device) * (stop / div),
                   torch.full((1,), stop, dtype=torch.float64, device=device)])
    return torch.complex(torch.full_like(p, real_p), p)


def get_transform_var_grid(variable_type: VariableType = VariableType.LOG_RETURN,
                           is_spot_measure: bool = True, max_phi: int = PHI_POINTS,
                           vol_scaler: float = 0.28, device="cpu"
                           ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """(phi, psi, theta) grids with the two inactive grids zeroed."""
    if variable_type != VariableType.LOG_RETURN:
        raise NotImplementedError(f"variable_type={variable_type}")
    phi_grid = get_phi_grid(is_spot_measure=is_spot_measure, max_phi=max_phi,
                            vol_scaler=vol_scaler, device=device)
    zero = torch.zeros_like(phi_grid)
    return phi_grid, zero, zero


def simpson_base_weights(n: int) -> np.ndarray:
    """static composite-Simpson pattern with the reference's even-length quirk:
    [1, 4, 2, 4, ..., 4(!)] for even n."""
    base = np.where(np.arange(n) % 2 == 1, 4.0, 2.0)
    base[0] = 1.0
    if (n - 1) % 2 == 0:  # an odd last index keeps 4.0, as in the reference
        base[-1] = 1.0
    return base


def compute_integration_weights(var_grid: torch.Tensor, is_simpson: bool = True) -> torch.Tensor:
    """quadrature weights on Im(grid) (1-D): Simpson (default) or trapezoid."""
    p = var_grid.imag
    if is_simpson:
        base = torch.as_tensor(simpson_base_weights(p.shape[-1]), device=p.device)
        return ((p[1] - p[0]) / 3.0) * base
    return torch.cat([(0.5 * (p[1] - p[0]))[None], p[1:] - p[:-1]])


def _nansum_re(weights: torch.Tensor, exponent: torch.Tensor, dim: int = -1) -> torch.Tensor:
    """Re[sum_n w_n exp(z_n)] with NaN and overflowing terms dropped.

    ``weights`` is real; a term is dropped where Re z or Im z is NaN, where
    Re z exceeds 0.98 log(max float), or where the term itself is NaN.
    """
    re, im = exponent.real, exponent.imag
    cap = 0.98 * math.log(torch.finfo(re.dtype).max)
    bad = torch.isnan(re) | torch.isnan(im) | (re > cap)
    e = torch.exp(torch.where(bad, 0.0, re))
    im_safe = torch.where(bad, 0.0, im)
    term = e * (weights * torch.cos(im_safe))
    return torch.sum(torch.where(bad | torch.isnan(term), 0.0, term), dim=dim)


def vanilla_prices_with_mgf_grid(log_mgf_grid: torch.Tensor, phi_grid: torch.Tensor,
                                 forwards: torch.Tensor, strikes: torch.Tensor,
                                 optiontypes, discfactors=1.0,
                                 is_spot_measure: bool = True,
                                 is_simpson: bool = True) -> torch.Tensor:
    """capped-payoff Fourier inversion for one slice or a stack of slices.

    Shapes: ``log_mgf_grid`` (..., N) complex, ``phi_grid`` (N,) with real
    part +-0.5, ``forwards`` (...,), ``strikes``/``optiontypes`` (..., K).
    Returns prices (..., K).
    """
    dp = compute_integration_weights(var_grid=phi_grid, is_simpson=is_simpson)
    p = phi_grid.imag
    p_payoff = (dp / math.pi) / (p * p + 0.25)

    fwd = forwards[..., None] if forwards.dim() == strikes.dim() - 1 else forwards
    x = torch.log(fwd / strikes)                                   # (..., K)

    # exponent z = -x*phi + logMGF, shape (..., K, N), assembled per part
    z_re = -x[..., None] * phi_grid.real + log_mgf_grid.real[..., None, :]
    z_im = -x[..., None] * phi_grid.imag + log_mgf_grid.imag[..., None, :]
    capped = _nansum_re(p_payoff, torch.complex(z_re, z_im), dim=-1)  # (..., K)

    is_call = (as_option_codes(optiontypes, strikes.device) & 1).to(torch.bool)
    if isinstance(discfactors, torch.Tensor) and discfactors.dim() == strikes.dim() - 1:
        discfactors = discfactors[..., None]
    if is_spot_measure:
        call_px = discfactors * (fwd - strikes * capped)
        put_px = discfactors * (strikes - strikes * capped)
    else:  # inverse measure: multiply by forward
        call_px = fwd * discfactors * (1.0 - capped)
        put_px = fwd * discfactors * (torch.exp(-x) - capped)
    return torch.where(is_call, call_px, put_px)
