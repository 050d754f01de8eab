"""
Transform-pricing engine: Fourier inversion of payoffs against a log-MGF grid.

PyTorch counterpart of ``stochvolmodels_tpu/ops/mgf.py``: the transform
grids (Phi for log-returns, the 40,000-point Psi for quadratic variance, the
5,000-point Theta for the vol), the vanilla, risk-premia (gamma), digital
and quadratic-variance pricers, and the density inversion.  Complex values
are native complex128.  The composite-Simpson weights keep the reference's
even-length quirk (the last point of an even-length grid keeps weight 4),
which is baked into its prices.
"""
from __future__ import annotations

import math
from typing import Optional, Tuple

import numpy as np
import torch

from stochvolmodels_torch.config import VariableType
from stochvolmodels_torch.ops.bsm import as_option_codes

PHI_POINTS = 1000
PSI_POINTS = 40000
PSI_SPAN = 4000.0
THETA_POINTS = 5000
THETA_SPAN = 600.0


def get_phi_grid(is_spot_measure: bool = True, max_phi: int = PHI_POINTS,
                 vol_scaler: float = 0.28, real_phi: Optional[float] = None,
                 device="cuda") -> torch.Tensor:
    """log-price transform grid phi = real_p + i p, p in [0, 5.6/vol_scaler].

    The real part is ``real_phi`` when given, else -0.5 under the spot
    measure and +0.5 under the inverse measure.  ``p`` is built as
    ``k * (stop / (n-1))`` with the end point set to ``stop``: the rounding
    of ``np.linspace`` and of ``jnp.linspace`` as XLA compiles it, so the
    grids agree bit for bit.  ``vol_scaler`` may be a 0-dim float64 tensor on
    ``device`` (a captured calibration takes it as an input); the grid then
    has the same bits as from the Python float.  So may ``real_phi`` (the
    risk-premia grid's -1/2 - gamma).
    """
    if real_phi is None:
        real_p = -0.5 if is_spot_measure else 0.5
    elif isinstance(real_phi, torch.Tensor):
        real_p = real_phi.to(torch.float64)
    else:
        real_p = float(real_phi)
    div = max_phi - 1
    if isinstance(vol_scaler, torch.Tensor):
        # tensor by tensor: a true division (``5.6 / t`` multiplies by 1/t,
        # and the card divides by a Python number through its reciprocal)
        vs = vol_scaler.to(torch.float64)
        stop = vs.new_full((), 5.6) / vs
        step, end = stop / vs.new_full((), div), stop.reshape(1)
    else:
        stop = 5.6 / float(vol_scaler)
        step, end = stop / div, torch.full((1,), stop, dtype=torch.float64, device=device)
    p = torch.cat([torch.arange(div, dtype=torch.float64, device=device) * step, end])
    re = real_p.expand(p.shape) if isinstance(real_p, torch.Tensor) else torch.full_like(p, real_p)
    return torch.complex(re, p)


def _span_grid(span: float, n: int, device) -> torch.Tensor:
    """[0, span] in n points, rounded as ``jnp.linspace`` rounds them."""
    div = n - 1
    return torch.cat([torch.arange(div, dtype=torch.float64, device=device) * (span / div),
                      torch.full((1,), span, dtype=torch.float64, device=device)])


def get_psi_grid(max_psi: int = PSI_POINTS, device="cuda") -> torch.Tensor:
    """quadratic-variance transform grid psi = -1/2 + i p, p in [0, 4000]."""
    p = _span_grid(PSI_SPAN, max_psi, device)
    return torch.complex(torch.full_like(p, -0.5), p)


def get_theta_grid(max_theta: int = THETA_POINTS, device="cuda") -> torch.Tensor:
    """volatility transform grid theta = i p, p in [0, 600]."""
    p = _span_grid(THETA_SPAN, max_theta, device)
    return torch.complex(torch.zeros_like(p), p)


def get_transform_var_grid(variable_type: VariableType = VariableType.LOG_RETURN,
                           is_spot_measure: bool = True, max_phi: int = PHI_POINTS,
                           vol_scaler: float = 0.28, real_phi: Optional[float] = None,
                           device="cuda"
                           ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """(phi, psi, theta) grids with the inactive ones zeroed: LOG_RETURN runs
    on the phi grid; Q_VAR on the psi grid with phi held at 0 (spot measure)
    or 1 (inverse); SIGMA on the theta grid."""
    if variable_type == VariableType.LOG_RETURN:
        phi_grid = get_phi_grid(is_spot_measure=is_spot_measure, max_phi=max_phi,
                                vol_scaler=vol_scaler, device=device, real_phi=real_phi)
        zero = torch.zeros_like(phi_grid)
        return phi_grid, zero, zero
    if variable_type == VariableType.Q_VAR:
        psi_grid = get_psi_grid(device=device)
        phi_grid = torch.complex(torch.full_like(psi_grid.real, 0.0 if is_spot_measure else 1.0),
                                 torch.zeros_like(psi_grid.real))
        return phi_grid, psi_grid, torch.zeros_like(psi_grid)
    if variable_type == VariableType.SIGMA:
        theta_grid = get_theta_grid(device=device)
        zero = torch.zeros_like(theta_grid)
        return zero, zero, theta_grid
    raise NotImplementedError(f"variable_type={variable_type}")


def simpson_base_weights(n: int) -> np.ndarray:
    """static composite-Simpson pattern with the reference's even-length quirk:
    [1, 4, 2, 4, ..., 4(!)] for even n."""
    base = np.where(np.arange(n) % 2 == 1, 4.0, 2.0)
    base[0] = 1.0
    if (n - 1) % 2 == 0:  # an odd last index keeps 4.0, as in the reference
        base[-1] = 1.0
    return base


def _simpson_base_on(n: int, device) -> torch.Tensor:
    """:func:`simpson_base_weights` made on ``device`` by kernels (no copy from
    the host, so a CUDA graph can capture it); the values are exact."""
    k = torch.arange(n, device=device)
    base = torch.where(k % 2 == 1, 4.0, 2.0).to(torch.float64)
    ends = (k == 0) | ((k == n - 1) & ((n - 1) % 2 == 0))
    return torch.where(ends, 1.0, base)


def compute_integration_weights(var_grid: torch.Tensor, is_simpson: bool = True) -> torch.Tensor:
    """quadrature weights on Im(grid) (1-D): Simpson (default) or trapezoid."""
    p = var_grid.imag
    if is_simpson:
        return ((p[1] - p[0]) / 3.0) * _simpson_base_on(p.shape[-1], p.device)
    return torch.cat([(0.5 * (p[1] - p[0]))[None], p[1:] - p[:-1]])


def _nansum_re(weights: torch.Tensor, exponent: torch.Tensor, dim: int = -1) -> torch.Tensor:
    """Re[sum_n w_n exp(z_n)] with NaN and overflowing terms dropped.

    ``weights`` is real or complex: a complex weight contributes
    ``e^Re z (Re w cos Im z - Im w sin Im z)``.  A term is dropped where
    Re z or Im z is NaN, where Re z exceeds 0.98 log(max float), or where
    the term itself is NaN.
    """
    re, im = exponent.real, exponent.imag
    cap = 0.98 * math.log(torch.finfo(re.dtype).max)
    bad = torch.isnan(re) | torch.isnan(im) | (re > cap)
    e = torch.exp(torch.where(bad, 0.0, re))
    im_safe = torch.where(bad, 0.0, im)
    if weights.is_complex():
        term = e * (weights.real * torch.cos(im_safe) - weights.imag * torch.sin(im_safe))
    else:
        term = e * (weights * torch.cos(im_safe))
    return torch.sum(torch.where(bad | torch.isnan(term), 0.0, term), dim=dim)


def _real_over(w: torch.Tensor, den: torch.Tensor) -> torch.Tensor:
    """real ``w`` over complex ``den``, in the JAX package's operation order
    (``Cplx.__rtruediv__``): (w Re d, -w Im d) / |d|^2."""
    d2 = den.real * den.real + den.imag * den.imag
    return torch.complex(w * den.real / d2, -w * den.imag / d2)


def _payoff_weights(phi_grid: torch.Tensor, dp: torch.Tensor, real_phi_is_half: bool,
                    shift) -> torch.Tensor:
    """the capped-payoff kernel -(dp/pi) / ((phi + shift + 1)(phi + shift));
    with ``real_phi_is_half`` its real form on Re phi = -1/2,
    (dp/pi) / (p^2 + 1/4)."""
    p = phi_grid.imag
    if real_phi_is_half:
        return (dp / math.pi) / (p * p + 0.25)
    return -_real_over(dp / math.pi, (phi_grid + (shift + 1.0)) * (phi_grid + shift))


def _log_moneyness_exponent(x: torch.Tensor, phi_grid: torch.Tensor,
                            log_mgf_grid: torch.Tensor) -> torch.Tensor:
    """z = -x phi + logMGF, shape (..., K, N), assembled part by part."""
    z_re = -x[..., None] * phi_grid.real + log_mgf_grid.real[..., None, :]
    z_im = -x[..., None] * phi_grid.imag + log_mgf_grid.imag[..., None, :]
    return torch.complex(z_re, z_im)


def vanilla_prices_with_mgf_grid(log_mgf_grid: torch.Tensor, phi_grid: torch.Tensor,
                                 forwards: torch.Tensor, strikes: torch.Tensor,
                                 optiontypes, discfactors=1.0,
                                 is_spot_measure: bool = True,
                                 is_simpson: bool = True,
                                 real_phi_is_half: bool = True) -> torch.Tensor:
    """capped-payoff Fourier inversion for one slice or a stack of slices.

    Shapes: ``log_mgf_grid`` (..., N) complex, ``phi_grid`` (N,),
    ``forwards`` (...,), ``strikes``/``optiontypes`` (..., K).  Returns
    prices (..., K).  ``real_phi_is_half`` selects the real payoff kernel
    (Re phi = +-1/2); otherwise the complex kernel
    -1/((phi + 1) phi) (spot measure) or -1/((phi - 1) phi) (inverse).
    """
    dp = compute_integration_weights(var_grid=phi_grid, is_simpson=is_simpson)
    p_payoff = _payoff_weights(phi_grid, dp, real_phi_is_half,
                               shift=0.0 if is_spot_measure else -1.0)

    fwd = forwards[..., None] if forwards.dim() == strikes.dim() - 1 else forwards
    x = torch.log(fwd / strikes)                                   # (..., K)
    capped = _nansum_re(p_payoff, _log_moneyness_exponent(x, phi_grid, log_mgf_grid),
                        dim=-1)                                    # (..., K)

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


def vanilla_slice_pricer_with_mgf_grid(log_mgf_grid: torch.Tensor, phi_grid: torch.Tensor,
                                       forward, strikes, optiontypes, discfactor=1.0,
                                       is_spot_measure: bool = True,
                                       is_simpson: bool = True) -> torch.Tensor:
    """one slice; the payoff kernel is chosen from the grid's real part, as
    the JAX package does."""
    re0 = float(phi_grid.real.reshape(-1)[0])
    strikes = torch.as_tensor(strikes, dtype=torch.float64, device=phi_grid.device)
    return vanilla_prices_with_mgf_grid(
        log_mgf_grid=log_mgf_grid, phi_grid=phi_grid,
        forwards=torch.as_tensor(float(forward), dtype=torch.float64, device=phi_grid.device),
        strikes=strikes, optiontypes=optiontypes, discfactors=discfactor,
        is_spot_measure=is_spot_measure, is_simpson=is_simpson,
        real_phi_is_half=abs(abs(re0) - 0.5) < 1e-12)


def slice_pricer_with_mgf_grid_with_gamma(log_mgf_grid: torch.Tensor,
                                          phi_grid: torch.Tensor,
                                          risk_premia_gamma,
                                          ttm: float,
                                          forward,
                                          normalizer,
                                          gamma_forward,
                                          strikes,
                                          optiontypes,
                                          discfactor=1.0,
                                          is_spot_measure: bool = True,
                                          is_simpson: bool = True,
                                          real_phi_is_half: bool = False) -> torch.Tensor:
    """risk-premia-gamma payoff inversion for one slice (spot measure only).

    The payoff kernel is shifted by gamma, -1/((phi + gamma + 1)(phi +
    gamma)); calls assemble against the gamma-forward and the gamma-strike
    K^(1 + gamma) with the MGF normalizer.  ``ttm`` and ``discfactor`` are
    unused, as in the JAX package.  ``risk_premia_gamma``, ``forward``,
    ``normalizer`` and ``gamma_forward`` are Python floats or 0-dim float64
    tensors on the grid's device (a captured reprice takes them as tensors).
    """
    if not is_spot_measure:
        raise NotImplementedError("gamma kernel only under the spot measure")
    dp = compute_integration_weights(var_grid=phi_grid, is_simpson=is_simpson)
    if not isinstance(risk_premia_gamma, torch.Tensor):
        risk_premia_gamma, forward = float(risk_premia_gamma), float(forward)
    p_payoff = _payoff_weights(phi_grid, dp, real_phi_is_half, shift=risk_premia_gamma)
    strikes = torch.as_tensor(strikes, dtype=torch.float64, device=phi_grid.device)
    x = torch.log(forward / strikes)
    capped = _nansum_re(p_payoff, _log_moneyness_exponent(x, phi_grid, log_mgf_grid), dim=-1)

    is_call = (as_option_codes(optiontypes, strikes.device) & 1).to(torch.bool)
    gamma_strikes = torch.pow(strikes, 1.0 + risk_premia_gamma)
    call_px = gamma_forward - normalizer * gamma_strikes * capped
    put_px = strikes - normalizer * gamma_strikes * capped
    return torch.where(is_call, call_px, put_px)


def _per_row(a, strikes: torch.Tensor):
    """a per-slice value ``a`` (float or tensor) shaped to broadcast over the
    strike axis of ``strikes``."""
    if isinstance(a, torch.Tensor) and a.dim() == strikes.dim() - 1:
        return a[..., None]
    return a


def digital_prices_with_mgf_grid(log_mgf_grid: torch.Tensor, phi_grid: torch.Tensor,
                                 forwards, strikes: torch.Tensor, optiontypes,
                                 discfactors=1.0, is_simpson: bool = True,
                                 real_phi_negative: bool = True) -> torch.Tensor:
    """cash-digital Fourier inversion for one slice or a stack of slices.

    The kernel -(dp/pi)/phi prices calls where Re phi < 0
    (``real_phi_negative``), +(dp/pi)/phi prices puts otherwise; the other
    side is 1 - price.  Shapes as :func:`vanilla_prices_with_mgf_grid`.
    """
    dp = compute_integration_weights(var_grid=phi_grid, is_simpson=is_simpson)
    p_payoff = _real_over(-dp / math.pi if real_phi_negative else dp / math.pi, phi_grid)
    fwd = _per_row(forwards, strikes)
    x = torch.log(fwd / strikes)
    digital = _nansum_re(p_payoff, _log_moneyness_exponent(x, phi_grid, log_mgf_grid), dim=-1)
    is_call = (as_option_codes(optiontypes, strikes.device) & 1).to(torch.bool)
    price = torch.where(is_call == real_phi_negative, digital, 1.0 - digital)
    return _per_row(discfactors, strikes) * price


def digital_slice_pricer_with_mgf_grid(log_mgf_grid: torch.Tensor, phi_grid: torch.Tensor,
                                       forward, strikes, optiontypes, discfactor=1.0,
                                       is_simpson: bool = True) -> torch.Tensor:
    """one slice; the call kernel is chosen from the sign of the grid's real
    part, as the JAX package does."""
    re0 = float(phi_grid.real.reshape(-1)[0])
    device = phi_grid.device
    return digital_prices_with_mgf_grid(
        log_mgf_grid=log_mgf_grid, phi_grid=phi_grid,
        forwards=torch.as_tensor(float(forward), dtype=torch.float64, device=device),
        strikes=torch.as_tensor(strikes, dtype=torch.float64, device=device),
        optiontypes=optiontypes, discfactors=discfactor, is_simpson=is_simpson,
        real_phi_negative=re0 < 0.0)


def qvar_prices_with_mgf_grid(log_mgf_grid: torch.Tensor, psi_grid: torch.Tensor, ttms,
                              strikes: torch.Tensor, optiontypes, forwards=None,
                              discfactors=1.0, is_simpson: bool = True,
                              is_spot_measure: bool = True) -> torch.Tensor:
    """calls on annualised quadratic variance: the kernel (dp/pi)/psi^2 against
    the exponent strike*ttm*psi + logMGF, divided by ttm and floored at 1e-10.
    Only calls are priced, as in the reference; ``optiontypes``,
    ``forwards`` and ``is_spot_measure`` are accepted for its signature."""
    dp = compute_integration_weights(var_grid=psi_grid, is_simpson=is_simpson)
    a, b = psi_grid.real, psi_grid.imag
    psi2 = torch.complex(a * a - b * b, a * b + b * a)
    p_payoff = _real_over(dp / math.pi, psi2)
    t = _per_row(ttms, strikes)
    kt = strikes * t
    z = torch.complex(kt[..., None] * a + log_mgf_grid.real[..., None, :],
                      kt[..., None] * b + log_mgf_grid.imag[..., None, :])
    option_price = _nansum_re(p_payoff, z, dim=-1)
    return torch.clamp(_per_row(discfactors, strikes) * option_price / t, min=1e-10)


def slice_qvar_pricer_with_a_grid(log_mgf_grid: torch.Tensor, psi_grid: torch.Tensor, ttm,
                                  strikes, optiontypes, forward=None, discfactor=1.0,
                                  is_simpson: bool = True,
                                  is_spot_measure: bool = True) -> torch.Tensor:
    """one slice of :func:`qvar_prices_with_mgf_grid`."""
    return qvar_prices_with_mgf_grid(
        log_mgf_grid=log_mgf_grid, psi_grid=psi_grid, ttms=ttm,
        strikes=torch.as_tensor(strikes, dtype=torch.float64, device=psi_grid.device),
        optiontypes=optiontypes, forwards=forward, discfactors=discfactor,
        is_simpson=is_simpson, is_spot_measure=is_spot_measure)


def pdf_with_mgf_grid(log_mgf_grid: torch.Tensor, transform_var_grid: torch.Tensor,
                      space_grid: torch.Tensor, shift: float = 0.0, scale: float = 1.0,
                      is_simpson: bool = True) -> torch.Tensor:
    """density mass on a uniform space grid by transform inversion:
    dx Re sum_n (dp_n/pi) exp(z_space q_n + logMGF_n), z_space = (x - shift)/scale."""
    dp = compute_integration_weights(var_grid=transform_var_grid, is_simpson=is_simpson) / math.pi
    z_space = (space_grid - shift) / scale                         # (M,)
    z = torch.complex(z_space[..., None] * transform_var_grid.real + log_mgf_grid.real,
                      z_space[..., None] * transform_var_grid.imag + log_mgf_grid.imag)
    pdf = _nansum_re(dp, z, dim=-1)
    return (space_grid[1] - space_grid[0]) * pdf
