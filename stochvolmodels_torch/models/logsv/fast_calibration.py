"""
LogSV calibration with the whole optimization loop on the device.

PyTorch counterpart of ``stochvolmodels_tpu/models/logsv/fast_calibration.py``.
Two solvers fit the PARAMS5 vector [sigma0, theta, kappa1, beta, volvol]
(kappa2 = kappa1 / theta) to the chain's mid vols:

* :func:`calibrate_logsv_lm_on_device` — Levenberg-Marquardt on the
  sqrt-weight-scaled vol residuals, with the martingale and moment
  constraints as one-sided penalty residuals.  ~12-16 iterations.  On a CUDA
  device the whole ``nb_iters``-iteration loop is one captured CUDA graph
  (``ops/graphs.py``), the counterpart of the JAX package's one compiled
  program: a warm call copies its inputs into the graph's buffers and
  replays it.  This is ``method='lm'`` of
  ``LogSVPricer.calibrate_model_params_to_chain``.
* :func:`calibrate_logsv_on_device` — projected Adam with a cosine learning
  rate; first-order, hundreds of iterations, run eagerly.

Both price with the float64 affine RK4 (on a card the hand-written kernel of
``ops/affine_rk4.py``, one launch a residual pass and one more for its
tangents) and invert with the fast implied vol (bisection + Newton,
implicit-function derivatives).
"""
from __future__ import annotations

import math
from typing import List, Optional, Tuple

import numpy as np
import torch

from stochvolmodels_torch.data.option_chain import ChainGrid, OptionChain
from stochvolmodels_torch.models.logsv.params import LogSvParams
from stochvolmodels_torch.models.logsv.pricer import ConstraintsType, _pad_panel, set_vol_scaler
from stochvolmodels_torch.ops import affine_rk4, bsm, graphs, mgf
from stochvolmodels_torch.ops.lm import lm_minimize
from stochvolmodels_torch.utils.profiling import (
    LM_FIT_SPAN,
    LM_PREPARE_SPAN,
    annotate,
    to_device,
    to_host,
)

# optimizer vector: [sigma0, theta, kappa1, beta, volvol] (PARAMS5 layout)
LOWER = np.array([0.1, 0.1, 0.25, -3.0, 0.2])
UPPER = np.array([1.5, 1.5, 10.0, 3.0, 3.0])


def _bounds_vector(p: Optional[LogSvParams], default: np.ndarray) -> np.ndarray:
    """PARAMS5 [sigma0, theta, kappa1, beta, volvol] bounds from LogSvParams."""
    if p is None:
        return default
    return np.array([p.sigma0, p.theta, p.kappa1, p.beta, p.volvol])


def _chain_targets(option_chain: OptionChain, is_vega_weighted: bool, device
                   ) -> Tuple[float, ChainGrid, np.ndarray, np.ndarray]:
    """(vol scaler, grid, market vol panel, weight panel): the panels are 0
    on padded slots; the weights are the slice-normalised BSM vegas at the
    mid vols, or ones."""
    vol_scaler = set_vol_scaler(sigma0=option_chain.get_chain_atm_vols()[0],
                                ttm=option_chain.ttms[0])
    grid = option_chain.to_grid(device=device)
    market_panel = _pad_panel(option_chain.get_mid_vols(), grid)
    if is_vega_weighted:
        vegas = [v / np.sum(v) for v in option_chain.get_chain_vegas()]
        weights_panel = _pad_panel(vegas, grid)
    else:
        weights_panel = np.ones_like(market_panel)
    mask = to_host(grid.mask)
    return (vol_scaler, grid, np.where(mask, market_panel, 0.0),
            np.where(mask, weights_panel, 0.0))


def _constraint_gaps(constraints_type: ConstraintsType, theta, kappa1, kappa2, beta,
                     volvol) -> List[torch.Tensor]:
    """max(violation, 0) of each constraint of the type: kappa2 >= beta
    (MMA martingale), kappa2 >= 2 beta (inverse martingale), kappa >= 1.5
    vartheta^2 (finite fourth moment)."""
    gaps = []
    if constraints_type in (ConstraintsType.MMA_MARTINGALE,
                            ConstraintsType.MMA_MARTINGALE_MOMENT4):
        gaps.append(torch.clamp(beta - kappa2, min=0.0))
    if constraints_type in (ConstraintsType.INVERSE_MARTINGALE,
                            ConstraintsType.INVERSE_MARTINGALE_MOMENT4):
        gaps.append(torch.clamp(2.0 * beta - kappa2, min=0.0))
    if constraints_type in (ConstraintsType.MMA_MARTINGALE_MOMENT4,
                            ConstraintsType.INVERSE_MARTINGALE_MOMENT4):
        kappa = kappa1 + kappa2 * theta
        vartheta2 = beta * beta + volvol * volvol
        gaps.append(torch.clamp(1.5 * vartheta2 - kappa, min=0.0))
    return gaps


def _model_vols(pars: torch.Tensor, grid: ChainGrid, vol_scaler, ttms_static, year_steps: int
                ) -> Tuple[torch.Tensor, Tuple[torch.Tensor, ...]]:
    """the fast implied vols of the chain panel at the PARAMS5 vector, and
    (theta, kappa1, kappa2, beta, volvol).  The chain's log-MGF panel comes
    from ``affine_rk4.log_mgf_chain`` (one kernel launch on a card), then
    each slice is priced by the Fourier quadrature, as
    ``logsv_chain_price_grid`` prices it."""
    sigma0, theta, kappa1, beta, volvol = pars.unbind()
    kappa2 = kappa1 / theta
    phi_grid = mgf.get_phi_grid(vol_scaler=vol_scaler, device=grid.device)
    log_mgf = affine_rk4.log_mgf_chain(
        torch.stack([sigma0, theta, kappa1, kappa2, beta, volvol]), phi_grid,
        affine_rk4.chain_schedule(ttms_static, year_steps))
    prices = torch.stack([mgf.vanilla_prices_with_mgf_grid(
        log_mgf_grid=log_mgf[i], phi_grid=phi_grid, forwards=grid.forwards[i],
        strikes=grid.strikes[i], optiontypes=grid.optioncodes[i],
        discfactors=grid.discfactors[i]) for i in range(len(ttms_static))])
    vols = bsm.infer_bsm_implied_vol_fast(
        forward=grid.forwards[:, None], ttm=grid.ttms[:, None], strike=grid.strikes,
        given_price=prices, discfactor=grid.discfactors[:, None], optiontype=grid.optioncodes)
    return vols, (theta, kappa1, kappa2, beta, volvol)


def _fit_params(best) -> LogSvParams:
    """LogSvParams from a PARAMS5 vector on the host (array or CPU tensor)."""
    best = np.asarray(best, dtype=np.float64)
    return LogSvParams(sigma0=best[0], theta=best[1], kappa1=best[2],
                       kappa2=best[2] / best[1], beta=best[3], volvol=best[4])


def _lm_residuals(ttms, forwards, discfactors, strikes, optioncodes, mask, market, sqrtw,
                  vol_scaler, *, ttms_static, year_steps, constraints_type):
    """the LM residual function of the PARAMS5 vector: sqrt-weighted
    fast-IV errors (0 where the model vol is NaN) and sqrt(10) x the
    constraint gaps of ``constraints_type``."""
    grid = ChainGrid(ttms=ttms, forwards=forwards, discfactors=discfactors, strikes=strikes,
                     optioncodes=optioncodes, mask=mask)
    sqrt10 = math.sqrt(10.0)

    def residuals(pars):
        vols, constrained = _model_vols(pars, grid, vol_scaler, ttms_static, year_steps)
        nan_mask = torch.isnan(vols)
        clean = torch.where(nan_mask, market, vols)
        r = (sqrtw * (clean - market)).reshape(-1)
        pen = [sqrt10 * gap for gap in _constraint_gaps(constraints_type, *constrained)]
        if pen:
            r = torch.cat([r, torch.stack(pen)])
        return r

    return residuals


def _lm_run(p0, ttms, forwards, discfactors, strikes, optioncodes, mask, market, sqrtw,
            lower, upper, vol_scaler, *, ttms_static, year_steps, nb_iters, constraints_type):
    """the LM fit on tensors only (so that it can be captured): returns
    (best parameters, best cost)."""
    residuals = _lm_residuals(ttms, forwards, discfactors, strikes, optioncodes, mask, market,
                              sqrtw, vol_scaler, ttms_static=ttms_static, year_steps=year_steps,
                              constraints_type=constraints_type)
    return lm_minimize(residuals, p0, lower, upper, nb_iters=nb_iters)


def calibrate_logsv_lm_on_device(option_chain: OptionChain,
                                 params0: LogSvParams,
                                 constraints_type: ConstraintsType = ConstraintsType.UNCONSTRAINT,
                                 nb_iters: int = 16,
                                 year_steps: int = 360,
                                 use_float32: Optional[bool] = None,
                                 is_vega_weighted: bool = True,
                                 params_min: Optional[LogSvParams] = None,
                                 params_max: Optional[LogSvParams] = None,
                                 device="cuda",
                                 ) -> Tuple[LogSvParams, float]:
    """PARAMS5 calibration by Levenberg-Marquardt; returns (params, cost).

    The 5-column residual Jacobian comes from one ``jacfwd`` pass with the
    residuals as its aux, so an iteration costs two residual evaluations'
    worth of launches.  Box constraints by projection; martingale and moment
    constraints by sqrt(10)-scaled one-sided penalty residuals.  On a CUDA
    device the whole fit runs as one CUDA graph, captured at the first call
    of each (chain panel shape, ``nb_iters``, ``year_steps``, constraints
    type, maturities) and replayed after; inside ``graphs.eager()`` it runs
    eagerly, with the same bits.  ``use_float32`` is accepted for signature
    parity and mapped to float64, the card's native precision.  Spans: the
    fit is one ``LM_FIT_SPAN``, its inputs one ``LM_PREPARE_SPAN``.
    """
    del use_float32
    with annotate(LM_FIT_SPAN):
        with annotate(LM_PREPARE_SPAN):
            vol_scaler, grid, market, weights = _chain_targets(option_chain, is_vega_weighted,
                                                               device)
            ttms_static = tuple(float(t) for t in option_chain.ttms)
            up = lambda a: to_device(a, torch.float64, device)
            inputs = (up(np.array([params0.sigma0, params0.theta, params0.kappa1, params0.beta,
                                   params0.volvol], dtype=np.float64)),
                      grid.ttms, grid.forwards, grid.discfactors, grid.strikes, grid.optioncodes,
                      grid.mask, up(market), up(np.sqrt(weights)),
                      up(_bounds_vector(params_min, LOWER)), up(_bounds_vector(params_max, UPPER)),
                      up(vol_scaler))
        static = dict(ttms_static=ttms_static, year_steps=int(year_steps),
                      nb_iters=int(nb_iters), constraints_type=constraints_type)
        if graphs.use_graph(inputs[0]):
            key = (tuple(grid.strikes.shape), static["nb_iters"], static["year_steps"],
                   constraints_type, ttms_static, str(inputs[0].device))
            best, best_cost = graphs.run_captured("lm", key, lambda *a: _lm_run(*a, **static),
                                                  inputs)
        else:
            best, best_cost = _lm_run(*inputs, **static)
        return _fit_params(to_host(best)), float(to_host(best_cost))


def calibrate_logsv_on_device(option_chain: OptionChain,
                              params0: LogSvParams,
                              constraints_type: ConstraintsType = ConstraintsType.UNCONSTRAINT,
                              nb_iters: int = 200,
                              learning_rate: float = 0.08,
                              year_steps: int = 360,
                              use_float32: Optional[bool] = None,
                              is_vega_weighted: bool = True,
                              params_min: Optional[LogSvParams] = None,
                              params_max: Optional[LogSvParams] = None,
                              device="cuda",
                              ) -> Tuple[LogSvParams, float]:
    """PARAMS5 calibration by projected Adam; returns (params, loss).

    The loss is the weighted squared vol error over the quotes with a model
    vol, 0.01 for each quote without one (so that a region of NaN vols does
    not score a perfect 0), and 10 x the squared constraint violations.
    Adam's constants are (0.9, 0.999, 1e-8) and the learning rate follows a
    cosine from ``learning_rate`` to 0.  First-order, so it needs hundreds
    of iterations; prefer :func:`calibrate_logsv_lm_on_device`.  Runs
    eagerly; ``use_float32`` is mapped to float64.
    """
    del use_float32
    f64 = dict(dtype=torch.float64, device=device)
    vol_scaler, grid, market, weights = _chain_targets(option_chain, is_vega_weighted, device)
    market, weights = torch.as_tensor(market, **f64), torch.as_tensor(weights, **f64)
    ttms_static = tuple(float(t) for t in option_chain.ttms)
    lower = torch.as_tensor(_bounds_vector(params_min, LOWER), **f64)
    upper = torch.as_tensor(_bounds_vector(params_max, UPPER), **f64)

    def raw_loss(pars):
        vols, constrained = _model_vols(pars, grid, vol_scaler, ttms_static, year_steps)
        nan_mask = torch.isnan(vols)
        clean = torch.where(nan_mask, market, vols)
        r = weights * torch.square(clean - market)
        loss = torch.sum(torch.where(nan_mask, 0.0, r))
        loss = loss + 0.01 * torch.sum(nan_mask & (weights > 0.0)).to(torch.float64)
        for gap in _constraint_gaps(constraints_type, *constrained):
            loss = loss + 10.0 * torch.square(gap)
        return loss

    b1, b2, eps = 0.9, 0.999, 1e-8
    pars = torch.tensor([params0.sigma0, params0.theta, params0.kappa1, params0.beta,
                         params0.volvol], **f64)
    m, v = torch.zeros_like(pars), torch.zeros_like(pars)
    best_pars, best_loss = pars, torch.full((), math.inf, **f64)
    for i in range(nb_iters):
        tracked = pars.detach().requires_grad_(True)
        loss = raw_loss(tracked)
        (g,) = torch.autograd.grad(loss, tracked)
        loss = loss.detach()
        m = b1 * m + (1 - b1) * g
        v = b2 * v + (1 - b2) * g * g
        mhat = m / (1 - b1 ** (i + 1.0))
        vhat = v / (1 - b2 ** (i + 1.0))
        lr = learning_rate * 0.5 * (1.0 + math.cos(math.pi * i / nb_iters))
        better = loss < best_loss
        best_pars = torch.where(better, pars, best_pars)
        best_loss = torch.where(better, loss, best_loss)
        pars = torch.clamp(pars - lr * mhat / (torch.sqrt(vhat) + eps), lower, upper)
    with torch.no_grad():
        final_loss = raw_loss(pars)
    better = final_loss < best_loss
    best = torch.where(better, pars, best_pars)
    return _fit_params(to_host(best)), float(torch.where(better, final_loss, best_loss))
