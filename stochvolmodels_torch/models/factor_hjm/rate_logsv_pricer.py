"""
Swaption and rate-futures pricers for the factor HJM model with a LogSV driver
(Sepp & Rakhmonov 2025, RDR 28:12).

PyTorch counterpart of
``stochvolmodels_tpu/models/factor_hjm/rate_logsv_pricer.py``: the adaptive
tanh-sinh chain pricer (swaptions on the normal-moneyness kernel
1/(pi phi^2), futures on the log-shifted kernel 1/(pi phi (phi+1)) with the
convexity adjustment of Theorem 3.3), the fixed-panel differentiable slice
and cube pricers, the cube with traced structural panels, the ModelPricer
classes, and the joint factor/vol Monte Carlo under the risk-neutral,
annuity and T-forward measures with the futures Monte Carlo.

On a CUDA device a cube reprice is one captured graph (``"rates_cube"``):
all P slices, the S shared RK4 steps, the tanh-sinh inversion and the (P, K)
integral, keyed by the cube's shapes and S, with the frozen panels as graph
inputs; the traced cube is one graph too (``"rates_cube_traced"``, the
mean-state RK4 and the panels inside it); each ``ff`` batch of the adaptive
pricer is one graph of the RK4 (``"rates_ode"``), keyed by (padded batch,
steps, expansion order); each Monte Carlo segment between requested
maturities is one graph (``"rates_mc"``, ``"rates_futures_mc"``), its
normals drawn before the replay.  The ``engine=`` argument of the JAX
package ('auto' | 'f64' | 'df32') is accepted and always runs
float64/complex128.  ``mesh=`` (``parallel/mesh.py``) splits a cube's slice
axis over several devices (:class:`ShardedSwaptionCube`).
"""
from __future__ import annotations

import copy
from enum import Enum
from typing import Optional, Tuple

import numpy as np
import torch

from stochvolmodels_torch.models.factor_hjm.conv_adj import conv_adj_linear_block, solve_conv_adj
from stochvolmodels_torch.models.factor_hjm.double_exp_pricer import de_pricer, tanh_sinh_nodes
from stochvolmodels_torch.models.factor_hjm.qa_traced import (
    QAGeometryTensors,
    build_qa_geometry,
    qa_panels_traced,
)
from stochvolmodels_torch.models.factor_hjm.rate_affine_expansion import (
    UnderlyingType,
    _scalar_series,
    compute_logsv_a_mgf_grid,
    contract_log_mgf,
    interp_series,
    rk4_batch,
    stage_brackets,
    stage_times,
    step_multipliers,
    templates_on,
)
from stochvolmodels_torch.models.factor_hjm.rate_factor_basis import NelsonSiegel
from stochvolmodels_torch.models.factor_hjm.rate_logsv_params import MultiFactRateLogSvParams
from stochvolmodels_torch.models.logsv.affine import ExpansionOrder, get_expansion_n
from stochvolmodels_torch.models.model_pricer import ModelPricer
from stochvolmodels_torch.ops import graphs
from stochvolmodels_torch.ops.bachelier import infer_normal_ivols_from_slice_prices
from stochvolmodels_torch.ops.random import generator_from_seed, step_normals
from stochvolmodels_torch.parallel.mesh import (
    PathMesh,
    check_mesh,
    gather,
    on_device,
    shard_bounds,
)
from stochvolmodels_torch.utils.funcs import set_time_grid
from stochvolmodels_torch.utils.rate_core import (
    bracket,
    df_fast,
    generate_ttms_grid,
    get_futures_start_and_pmt,
)

ENGINES = ("auto", "f64", "df32")


class Measure(Enum):
    """pricing measure: risk-neutral, annuity (Q^A), or T-forward."""
    RISK_NEUTRAL = 1
    ANNUITY = 2
    FORWARD = 3


class FutSettleType(Enum):
    """settlement convention of the rate futures contract."""
    EURODOLLAR = 1
    SOFR = 2


def _check_signature_only(engine: str) -> None:
    """``engine`` is kept for the JAX package's signature."""
    if engine not in ENGINES:
        raise ValueError(f"engine must be one of {ENGINES}, got {engine!r}")


# ----------------------------------------------------------------------------
# futures convexity adjustment (Theorem 3.3 / 3.5)
# ----------------------------------------------------------------------------

def futures_conv_adj(t_start: float,
                     basis_type: str,
                     params: MultiFactRateLogSvParams,
                     t0: float,
                     Delta: float,
                     settlement_type: FutSettleType,
                     expansion_order: ExpansionOrder,
                     dense_output: bool = False,
                     t_grid: Optional[np.ndarray] = None,
                     device="cuda") -> Tuple[np.ndarray, ...]:
    """futures convexity adjustment, analytic form of Theorem 3.5: the
    linear bond-coefficient block in closed form and the 2-3-dim h-system by
    RK4 on ``device`` (``conv_adj.py``).

    Returns (b1, b2, h1, h2, h0) at ``tau_eval = t_start - t0`` (EURODOLLAR;
    plus Delta for SOFR), or dense arrays over ``tau = t_start - t_grid``
    when ``dense_output`` is set; numpy.
    """
    assert basis_type == "NELSON-SIEGEL"
    assert t0 <= t_start
    if expansion_order == ExpansionOrder.FIRST:
        if settlement_type == FutSettleType.SOFR:
            raise NotImplementedError
    elif expansion_order != ExpansionOrder.ZERO:
        raise NotImplementedError
    if settlement_type not in (FutSettleType.EURODOLLAR, FutSettleType.SOFR):
        raise NotImplementedError

    device = torch.device(device)
    is_sofr = settlement_type == FutSettleType.SOFR
    tau_S = t_start - t0
    tau_E = tau_S + Delta
    tau_eval = max(tau_S, 1e-4) if not is_sofr else max(tau_E, 1e-4)

    taus, h_traj = solve_conv_adj(
        params, t_start=t_start, Delta=Delta, tau_end=tau_eval,
        settlement_is_sofr=is_sofr, expansion_order=expansion_order, device=device)
    h_traj = h_traj.cpu().numpy()
    block = lambda tau: tuple(x.cpu().numpy() for x in conv_adj_linear_block(
        params.basis.meanrev, tau, Delta, is_sofr, device=device))

    if dense_output:
        assert t_grid is not None
        tau_req = t_start - np.asarray(t_grid, dtype=float)
        b1, b2 = block(tau_req)
        h1 = np.interp(tau_req, taus, h_traj[:, 0])
        h2 = (np.interp(tau_req, taus, h_traj[:, 1])
              if expansion_order == ExpansionOrder.FIRST
              else np.zeros_like(tau_req))
        h0 = np.interp(tau_req, taus, h_traj[:, 2])
        return b1, b2, h1, h2, h0

    b1e, b2e = block(np.asarray(tau_eval))
    # the linear block net of the closed-form bond-coefficient increment over
    # the accrual period
    b1 = b1e - (params.basis.bond_coeffs(tau_E)[0] - params.basis.bond_coeffs(tau_S)[0])
    b2 = b2e - (params.basis.bond_coeffs(tau_E)[1] - params.basis.bond_coeffs(tau_S)[1])
    h1, h2, h0 = h_traj[-1, 0], h_traj[-1, 1], h_traj[-1, 2]
    if expansion_order != ExpansionOrder.FIRST:
        h2 = 0.0
    return b1, b2, h1, h2, h0


def calc_futures_rate(ccy: str,
                      basis_type: str,
                      params: MultiFactRateLogSvParams,
                      x0: np.ndarray,
                      y0: np.ndarray,
                      sigma0: np.ndarray,
                      t0: float,
                      t_start: float,
                      t_end: float,
                      Delta: float,
                      settlement_type: FutSettleType,
                      expansion_order: ExpansionOrder,
                      device="cuda") -> Tuple[np.ndarray, ...]:
    """futures rate with convexity (Eqs. 44-46), host numpy around the
    convexity adjustment's h-system on ``device``."""
    assert basis_type == "NELSON-SIEGEL"
    assert 0 <= t0 <= t_start
    q = params.theta if params.q is None else params.q
    v0 = sigma0[:, 0] - q
    b1, b2, h1, h2, h0 = futures_conv_adj(
        t_start=t_start, basis_type=basis_type, params=params, t0=t0,
        Delta=Delta, settlement_type=settlement_type,
        expansion_order=expansion_order, device=device)
    c_tau = np.exp(b1 @ np.transpose(x0) + b2 @ np.transpose(y0)
                   + h0 + h1 * v0 + h2 * v0 * v0)
    P_t_Ts_Te = (params.basis.bond(t=t0, T=t_end, x=x0, y=y0, ccy=ccy, m=0)
                 / params.basis.bond(t=t0, T=t_start, x=x0, y=y0, ccy=ccy, m=0))
    x00 = np.zeros(params.basis.get_nb_factors())
    y00 = np.zeros(params.basis.get_nb_aux_factors())
    P_0_Ts_Te = (params.basis.bond(t=t0, T=t_end, x=x00, y=y00, ccy=ccy, m=0)[0]
                 / params.basis.bond(t=t0, T=t_start, x=x00, y=y00, ccy=ccy, m=0)[0])
    futures_analyt_ae1 = 1.0 / Delta * (1.0 / P_t_Ts_Te * c_tau - 1.0)
    return futures_analyt_ae1, c_tau, P_t_Ts_Te, P_0_Ts_Te


# ----------------------------------------------------------------------------
# the inversion integrand
# ----------------------------------------------------------------------------

def _payoff_factor(phi_re: np.ndarray, phi_im: np.ndarray, futures: bool
                   ) -> Tuple[np.ndarray, np.ndarray]:
    """(re, im) of 1/(pi phi^2) (swaps) or 1/(pi phi (phi+1)) (futures), on
    the host in the JAX package's real-pair arithmetic: the product, then
    c/z = (c re / |z|^2, -c im / |z|^2)."""
    if futures:
        b_re, b_im = phi_re + 1.0, phi_im
    else:
        b_re, b_im = phi_re, phi_im
    z_re = phi_re * b_re - phi_im * b_im
    z_im = phi_re * b_im + phi_im * b_re
    d = z_re * z_re + z_im * z_im
    c = 1.0 / np.pi
    return c * z_re / d, -c * z_im / d


def _integrand_np(log_mgf: np.ndarray, phi_re, phi_im, moneyness, pay_re, pay_im):
    """the (N, K) inversion integrand e^{z.re} (pay.re cos z.im - pay.im sin
    z.im), z = moneyness phi + log MGF, in numpy."""
    z_re = moneyness[None, :] * phi_re[:, None] + log_mgf.real[:, None]
    z_im = moneyness[None, :] * phi_im[:, None] + log_mgf.imag[:, None]
    e = np.exp(z_re)
    return e * (pay_re[:, None] * np.cos(z_im) - pay_im[:, None] * np.sin(z_im))


# ----------------------------------------------------------------------------
# DE-quadrature chain pricer
# ----------------------------------------------------------------------------

def logsv_chain_de_pricer(params: MultiFactRateLogSvParams,
                          t_grid: np.ndarray,
                          ttms: np.ndarray,
                          forwards,
                          strikes_ttms,
                          optiontypes_ttms,
                          underlying_type: UnderlyingType = UnderlyingType.SWAP,
                          expansion_order: ExpansionOrder = ExpansionOrder.FIRST,
                          x0: Optional[np.ndarray] = None,
                          y0: Optional[np.ndarray] = None,
                          device="cuda",
                          **kwargs) -> Tuple[list, list]:
    """price swaption or futures-option slices by adaptive tanh-sinh
    quadrature of the inversion integral (``double_exp_pricer.de_pricer``).

    Each ``ff`` call solves the Riccati RK4 (360 steps/yr) for one padded
    node batch on ``device`` (one captured graph per padded batch, step
    count and expansion order on a card) and forms the integrand on the
    host; the normal implied vols invert on ``device``.  Returns
    (prices, normal ivols) as nested lists [tenor][expiry] of numpy arrays.
    """
    device = torch.device(device)
    settlement_type = kwargs.get('settlement_type', FutSettleType.EURODOLLAR)
    model_prices_tenors, model_ivs_tenors = [], []
    t_grid0 = t_grid
    if underlying_type == UnderlyingType.SWAP:
        assert params.basis.key_terms.size == len(forwards)
        assert ttms.size == 1 and len(optiontypes_ttms) == 1
        ttms_ = np.ones_like(params.basis.key_terms) * ttms[0]
        optiontypes_ttms_ = [optiontypes_ttms[0] for _ in params.basis.key_terms]
        rng_ttm = params.basis.key_terms
    elif underlying_type == UnderlyingType.FUTURES:
        assert len(forwards) == 1
        assert ttms.size == 1 and len(optiontypes_ttms) == 1
        ttms_ = ttms
        optiontypes_ttms_ = optiontypes_ttms
        rng_ttm = ['FUTURES_DUMMY_TENOR']
    else:
        raise NotImplementedError
    futures = underlying_type == UnderlyingType.FUTURES

    for idx_tenor, _ in enumerate(rng_ttm):
        model_prices_ttms, model_ivs_ttms = [], []
        tenor = rng_ttm[idx_tenor] if not futures else np.nan
        for ttm, forward, strikes_ttm, optiontypes_ttm in zip(
                ttms_, forwards[idx_tenor], strikes_ttms[idx_tenor], optiontypes_ttms_):
            if not futures:
                a, kappa0, kappa1, kappa2, beta, volvol, _ = params.transform_QA_params(
                    expiry=ttm, t_grid=t_grid0, tenor=tenor, x0=x0, y0=y0)
                a0 = a
                a1 = np.zeros_like(kappa0)
                b = np.zeros_like(kappa0)
                frac = np.nan
            else:
                tenor = 0.25
                start, end = get_futures_start_and_pmt(t0=ttm, lag=0.0, libor_tenor=tenor)
                frac = end - start
                a, eta, kappa0, kappa1, kappa2, beta, volvol = params.transform_QT_params(
                    expiry=ttm, t_grid=t_grid0, t_start=start, t_end=end)
                _, _, h1, _, _ = futures_conv_adj(
                    t_start=start, basis_type="NELSON-SIEGEL", params=params,
                    t0=0.0, Delta=tenor, expansion_order=ExpansionOrder.ZERO,
                    dense_output=True, t_grid=t_grid0[:np.where(t_grid0 == ttm)[0][0] + 1],
                    settlement_type=settlement_type, device=device)
                a0 = a + np.einsum('i,ij->ij', h1, beta)
                a1 = np.multiply(h1, volvol)
                b = (np.einsum('ij,ij->i', a0, eta)
                     + 0.5 * np.einsum('ij,ij->i', a0, a0))
            itemindex = np.where(t_grid0 == ttm)[0][0]
            times = t_grid0[:itemindex + 1]
            q_eff = params.theta if params.q is None else params.q
            strikes_np = np.asarray(strikes_ttm, dtype=float)
            if futures:
                moneyness = np.log((strikes_np + 1.0 / frac) / (forward + 1.0 / frac))
                scale = -(strikes_np + 1.0 / frac)
            else:
                moneyness = strikes_np - forward
                scale = None

            def ff(p: np.ndarray) -> np.ndarray:
                p = np.asarray(p, dtype=float)
                phi = torch.complex(torch.full(p.shape, -0.5, dtype=torch.float64, device=device),
                                    torch.as_tensor(p, device=device))
                _, log_mgf = compute_logsv_a_mgf_grid(
                    ttm=float(ttm), phi_grid=phi, sigma0=params.sigma0, q=q_eff,
                    times=times, a0=a0, a1=a1, kappa0=kappa0, kappa1=kappa1,
                    kappa2=kappa2, beta=beta, volvol=volvol, b=b,
                    underlying_type=underlying_type, expansion_order=expansion_order)
                phi_re = np.full(p.shape, -0.5)
                pay_re, pay_im = _payoff_factor(phi_re, p, futures)
                integrand = _integrand_np(log_mgf.cpu().numpy(), phi_re, p, moneyness,
                                          pay_re, pay_im)
                return integrand if scale is None else scale[None, :] * integrand

            def ivols_of(call_prices):
                out = infer_normal_ivols_from_slice_prices(
                    ttm=torch.as_tensor(float(ttm), dtype=torch.float64, device=device),
                    forward=float(forward), strikes=strikes_np,
                    model_prices=np.asarray(call_prices, dtype=float),
                    optiontypes=np.repeat('C', strikes_np.size), discfactor=1.0)
                return out.cpu().numpy()

            if not futures:
                def ff_transf(model_prices: np.ndarray):
                    return model_prices, ivols_of(model_prices)
            else:
                def ff_transf(capped_prices: np.ndarray):
                    call_prices = forward + 1.0 / frac - np.asarray(capped_prices)
                    return call_prices, ivols_of(call_prices)

            model_prices_ttm, model_ivs_ttm = de_pricer(ff, ff_transf)
            model_prices_ttms.append(np.asarray(model_prices_ttm))
            model_ivs_ttms.append(np.asarray(model_ivs_ttm))
        model_prices_tenors.append(model_prices_ttms)
        model_ivs_tenors.append(model_ivs_ttms)
    return model_prices_tenors, model_ivs_tenors


# ----------------------------------------------------------------------------
# fixed-panel differentiable slice and cube pricers
# ----------------------------------------------------------------------------

def _cube_price(sigma0, beta_xs, volvol_xs, idx_t, CT_loga, a_interp, lo, hi, r, steps,
                phi, pay_re, pay_im, w, moneyness, scalars, TM, K0, K1, K2, V, P, h
                ) -> Tuple[torch.Tensor, torch.Tensor]:
    """(prices (P, K), dead nodes (P, N)) of the cube for the calibratable
    (sigma0, beta_xs, volvol_xs) on the frozen panels; a torch function of
    its tensors, with no read back to the host, so that it captures whole."""
    theta, kappa1, kappa2 = scalars.unbind()
    beta_interp = beta_xs[idx_t]                                     # (P, T, d)
    beta2 = torch.einsum('ptd,ptd->pt', beta_interp, CT_loga)
    zeros = torch.zeros_like(beta2)
    series = _scalar_series(None, a_interp, zeros, beta2 * theta * theta,
                            kappa1 - kappa2 * theta + 2.0 * (kappa2 - beta2) * theta,
                            kappa2 - beta2, beta_interp, volvol_xs[idx_t], zeros,
                            UnderlyingType.SWAP)                     # (P, 7, T)
    return _series_price(series, sigma0 - theta, lo, hi, r, steps, phi, pay_re, pay_im, w,
                         moneyness, TM, K0, K1, K2, V, P, h)


def _series_price(series, y, lo, hi, r, steps, phi, pay_re, pay_im, w, moneyness,
                  TM, K0, K1, K2, V, P, h) -> Tuple[torch.Tensor, torch.Tensor]:
    """(prices (P, K), dead nodes (P, N)) from the seven scalar Riccati
    series (P, 7, T) of each slice: the stage interpolation, the batched
    RK4, the log-MGF at y = sigma0 - theta and the tanh-sinh integral."""
    n = h.shape[0]
    nb_slices, nb_steps = lo.shape[0], lo.shape[1] // 3
    coeffs = interp_series(series, lo, hi, r)                        # (P, 7, 3S)
    stage_coeffs = coeffs.reshape(nb_slices, 7, nb_steps, 3).permute(0, 2, 1, 3)
    a_t0 = torch.zeros((nb_slices, phi.shape[0], n), dtype=torch.complex128, device=phi.device)
    a_t1, dead = rk4_batch(phi, steps, stage_coeffs, a_t0, TM, K0, K1, K2, V, P, h)
    mgf = contract_log_mgf(a_t1, y, n)                               # (P, N)
    z_re = moneyness[:, None, :] * phi.real[None, :, None] + mgf.real[:, :, None]
    z_im = moneyness[:, None, :] * phi.imag[None, :, None] + mgf.imag[:, :, None]
    e = torch.exp(z_re)
    integrand = e * (pay_re[None, :, None] * torch.cos(z_im)
                     - pay_im[None, :, None] * torch.sin(z_im))
    return torch.einsum('n,pnk->pk', w, integrand), dead


def _moneyness_panel(strikes_slices, forwards) -> Tuple[np.ndarray, np.ndarray]:
    """(moneyness K - F (P, K_max), validity mask (P, K_max)) of the padded
    strike axis; padded entries hold moneyness 0."""
    P = len(strikes_slices)
    K_max = max(len(s) for s in strikes_slices)
    moneyness = np.zeros((P, K_max))
    mask = np.zeros((P, K_max), dtype=bool)
    for i, (strikes, fwd) in enumerate(zip(strikes_slices, forwards)):
        k = len(strikes)
        moneyness[i, :k] = np.asarray(strikes, dtype=float) - float(fwd)
        mask[i, :k] = True
    return moneyness, mask


def _node_consts(h: float, x_max: float, on) -> Tuple[torch.Tensor, ...]:
    """(phi = -1/2 + i p, 1/(pi phi^2) re and im, weights) of the fixed
    tanh-sinh panel, as tensors by ``on``."""
    p_nodes, w_nodes = tanh_sinh_nodes(h=h, x_max=x_max)
    phi_re = np.full(p_nodes.shape, -0.5)
    pay_re, pay_im = _payoff_factor(phi_re, p_nodes, futures=False)
    return torch.complex(on(phi_re), on(p_nodes)), on(pay_re), on(pay_im), on(w_nodes)


class SwaptionCubeFn:
    """``price(sigma0, beta_xs, volvol_xs) -> (P, K_max)`` call prices of a
    swaption cube (undiscounted, annuity-normalized), differentiable in all
    three arguments, on frozen annuity-measure panels.

    The panels (host numpy, frozen at build time) are moved to the device
    once.  On a CUDA device each call is one replay of the graph
    ``"rates_cube"`` keyed by the shapes and S (the panels are graph inputs,
    so cubes of one shape share a graph); inside a ``torch.func`` transform
    or a capture it runs eagerly.  ``mask`` is the (P, K_max) validity panel
    of the padded strike axis.
    """

    def __init__(self, params: MultiFactRateLogSvParams, panels, strikes_slices, forwards,
                 nb_steps: int, expansion_order: ExpansionOrder, h: float, x_max: float,
                 device):
        self.device = device = torch.device(device)
        on = lambda a, dtype=torch.float64: torch.as_tensor(np.asarray(a), dtype=dtype,
                                                            device=device)
        n = get_expansion_n(expansion_order)
        P = len(panels)
        T = max(p[1].size for p in panels)
        d = params.basis.nb_factors
        idx_all = np.zeros((P, T), dtype=np.int64)
        ct_all, a_all = np.zeros((P, T, d)), np.zeros((P, T, d))
        interp = np.zeros((3, P, 3 * nb_steps))
        dts = []
        for i, (expiry, times, idx_t, swap_gr, loga_der, C_panel) in enumerate(panels):
            k = times.size
            # pad a short panel with its last row: the brackets never reach it
            rows = np.minimum(np.arange(T), k - 1)
            idx_all[i] = idx_t[rows]
            ct_all[i] = np.einsum('tde,td->te', C_panel, loga_der)[rows]
            a_all[i] = np.einsum('td,tde->te', swap_gr, C_panel)[rows]
            t_eval, dt = stage_times(float(expiry), nb_steps)
            interp[:, i] = stage_brackets(t_eval, times)
            dts.append(dt)
        moneyness, mask = _moneyness_panel(strikes_slices, forwards)
        K_max = mask.shape[1]
        nodes = _node_consts(h, x_max, on)
        theta = float(params.theta)
        self.consts = (
            on(idx_all, torch.int64), on(ct_all), on(a_all), on(interp[0], torch.int64),
            on(interp[1], torch.int64), on(interp[2]), on(step_multipliers(dts)),
        ) + nodes + (
            on(moneyness), on([theta, float(params.kappa1), float(params.kappa2)]),
        ) + templates_on(theta, n, device)
        # the slice axis of each constant (None: shared by every slice)
        self.slice_axes = (0,) * 7 + (None,) * len(nodes) + (0, None) + (None,) * 7
        self.key = (P, T, d, K_max, nb_steps, nodes[0].shape[0], n, str(device))
        self.mask = torch.as_tensor(mask, device=device)
        self.sigma0 = float(params.sigma0)
        self.beta_xs = np.asarray(params.beta.xs, dtype=float)
        self.volvol_xs = np.asarray(params.volvol.xs, dtype=float)

    def primals(self, sigma0=None, beta_xs=None, volvol_xs=None) -> Tuple[torch.Tensor, ...]:
        """the three arguments as float64 tensors on the device (the build's
        parameters where None)."""
        values = (self.sigma0 if sigma0 is None else sigma0,
                  self.beta_xs if beta_xs is None else beta_xs,
                  self.volvol_xs if volvol_xs is None else volvol_xs)
        return tuple(v.to(torch.float64) if isinstance(v, torch.Tensor)
                     else torch.as_tensor(np.asarray(v, dtype=np.float64), device=self.device)
                     for v in values)

    def price_and_dead(self, sigma0, beta_xs, volvol_xs) -> Tuple[torch.Tensor, torch.Tensor]:
        """(prices (P, K_max), dead tanh-sinh nodes (P, N)), through the graph
        on a card."""
        inputs = self.primals(sigma0, beta_xs, volvol_xs) + self.consts
        if graphs.use_graph(inputs[0]):
            return graphs.run_captured("rates_cube", self.key, _cube_price, inputs)
        return _cube_price(*inputs)

    def __call__(self, sigma0, beta_xs, volvol_xs) -> torch.Tensor:
        return self.price_and_dead(sigma0, beta_xs, volvol_xs)[0]


class ShardedSwaptionCube:
    """a cube pricer (:class:`SwaptionCubeFn` or
    :class:`TracedSwaptionCubeFn`) with its slice axis P split over a mesh.

    Device i holds the contiguous slices ``bounds[i]`` of the cube: its part
    of every per-slice constant, its own copy of the shared ones, and its
    own graph on a card (the part's key carries its slice count and
    device).  A call moves the arguments to every part, launches every part
    before reading any back, and gathers the (P, K_max) prices and (P, N)
    dead nodes on the mesh's first device, where ``mask`` lies.  Devices
    left without a slice (P < mesh size) hold no part.
    """

    def __init__(self, cube, mesh: PathMesh):
        assert len(cube.slice_axes) == len(cube.consts)
        self.full = cube
        self.device = mesh.devices[0]
        self.mask = cube.mask
        self.bounds, self.parts = [], []
        for (start, stop), dev in zip(shard_bounds(cube.mask.shape[0], mesh), mesh.devices):
            if stop == start:
                continue
            part = copy.copy(cube)
            part.device = dev
            part.consts = tuple(
                (c if axis is None else c.narrow(axis, start, stop - start).contiguous()).to(dev)
                for c, axis in zip(cube.consts, cube.slice_axes))
            part.key = (stop - start,) + cube.key[1:-1] + (str(dev),)
            part.mask = cube.mask[start:stop].to(dev)
            self.bounds.append((start, stop))
            self.parts.append(part)

    def primals(self, *args) -> Tuple[torch.Tensor, ...]:
        """the whole cube's arguments, on the first device."""
        return self.full.primals(*args)

    def price_and_dead(self, *args) -> Tuple[torch.Tensor, torch.Tensor]:
        """(prices (P, K_max), dead nodes (P, N)) on the first device, each
        part through its graph on a card."""
        args = self.full.primals(*args)
        outs = []
        for part in self.parts:
            with on_device(part.device):
                outs.append(part.price_and_dead(*(a.to(part.device) for a in args)))
        return gather([o[0] for o in outs], self.device), gather([o[1] for o in outs], self.device)

    def __call__(self, *args) -> torch.Tensor:
        return self.price_and_dead(*args)[0]


def _on_mesh(cube, mesh: Optional[PathMesh]):
    """``cube`` split over ``mesh`` where it has more than one device."""
    return cube if mesh is None or mesh.size == 1 else ShardedSwaptionCube(cube, mesh)


def _cube_device(device, mesh: Optional[PathMesh]):
    """where a cube is built: the mesh's first device, else ``device``."""
    return device if mesh is None else check_mesh(mesh).devices[0]


def make_swaption_slice_fn(params: MultiFactRateLogSvParams,
                           t_grid: np.ndarray,
                           ttm: float,
                           tenor: float,
                           forward: float,
                           strikes: np.ndarray,
                           expansion_order: ExpansionOrder = ExpansionOrder.FIRST,
                           x0: Optional[np.ndarray] = None,
                           y0: Optional[np.ndarray] = None,
                           h: float = 0.125,
                           x_max: float = 2.75,
                           engine: str = "auto",
                           device="cuda"):
    """differentiable swaption slice pricer on the fixed tanh-sinh panel.

    Returns ``price(sigma0, beta_xs, volvol_xs) -> (n_strikes,)`` prices,
    with forward- and reverse-mode derivatives in all three arguments.  The
    QA structural panels (mean states, swap gradient, annuity
    log-derivative, factor vols C) are frozen on the host at the current
    parameters; the Riccati RK4 takes max(ceil(360 ttm), 16) steps (the
    single-slice solver's default) on the slice's own ``t_grid``.
    ``engine`` is kept for the signature.
    """
    _check_signature_only(engine)
    t_grid_cut, _, idx_t, swap_gr, loga_der, C_panel = params.qa_structural_panels(
        expiry=float(ttm), tenor=tenor, t_grid=t_grid, x0=x0, y0=y0)
    nb_steps = max(int(np.ceil(360 * float(ttm))), 16)
    cube = SwaptionCubeFn(params, [(float(ttm), np.asarray(t_grid_cut, dtype=float), idx_t,
                                    swap_gr, loga_der, C_panel)],
                          [strikes], [forward], nb_steps, expansion_order, h, x_max, device)

    def price(sigma0, beta_xs, volvol_xs) -> torch.Tensor:
        return cube(sigma0, beta_xs, volvol_xs)[0]

    return price


def make_swaption_cube_fn(params: MultiFactRateLogSvParams,
                          slices,
                          forwards,
                          strikes_slices,
                          expansion_order: ExpansionOrder = ExpansionOrder.FIRST,
                          nb_grid_pts: int = 31,
                          year_steps: int = 48,
                          h: float = 0.125,
                          x_max: float = 2.75,
                          x0: Optional[np.ndarray] = None,
                          y0: Optional[np.ndarray] = None,
                          mesh=None,
                          panel_rtol: float = 1e-3,
                          panel_atol: float = 1e-6,
                          engine: str = "auto",
                          device="cuda") -> Tuple[SwaptionCubeFn, torch.Tensor]:
    """whole-cube swaption pricer: every (expiry, tenor) slice in one program.

    ``slices`` is a sequence of (expiry, tenor) pairs, ``forwards[p]`` and
    ``strikes_slices[p]`` the forward swap rate and strike grid of slice p.
    Per-slice structural panels are frozen on the host as in
    :func:`make_swaption_slice_fn` (``panel_rtol``/``panel_atol`` drive its
    solve_ivp); the P Riccati systems integrate together with a shared step
    count S = max(ceil(year_steps max(expiry)), 16) and per-slice dt, and
    the tanh-sinh inversion broadcasts over (P, N, K).  Returns ``(price,
    mask)``: a :class:`SwaptionCubeFn` and the (P, K_max) validity panel.
    ``mesh`` (a ``PathMesh``) splits the slice axis over its devices, with
    the cube built on the first (``device`` is then unused): a
    :class:`ShardedSwaptionCube` where the mesh has more than one device.
    ``engine`` is kept for the signature.
    """
    _check_signature_only(engine)
    P = len(slices)
    assert len(forwards) == P and len(strikes_slices) == P
    ttms = np.array([float(e) for e, _ in slices])
    nb_steps = max(int(np.ceil(year_steps * float(np.max(ttms)))), 16)
    panels = []
    for (expiry, tenor) in slices:
        t_grid = generate_ttms_grid(np.array([float(expiry)]), nb_pts=nb_grid_pts)
        t_grid_cut, _, idx_t, swap_gr, loga_der, C_panel = params.qa_structural_panels(
            expiry=float(expiry), tenor=float(tenor), t_grid=t_grid, x0=x0, y0=y0,
            rtol=panel_rtol, atol=panel_atol)
        panels.append((float(expiry), np.asarray(t_grid_cut, dtype=float), idx_t, swap_gr,
                       loga_der, C_panel))
    cube = _on_mesh(SwaptionCubeFn(params, panels, strikes_slices, forwards, nb_steps,
                                   expansion_order, h, x_max, _cube_device(device, mesh)), mesh)
    return cube, cube.mask


def _traced_cube_price(sigma0, A_xs, beta_xs, volvol_xs, kappa1, kappa2, *consts
                       ) -> Tuple[torch.Tensor, torch.Tensor]:
    """(prices (P, K), dead nodes (P, N)) of the cube with the structural
    panels traced: the geometry's tensors, then (x0, y0, lo, hi, r, steps,
    phi, pay_re, pay_im, w, moneyness, theta) and the ODE templates; no read
    back to the host, so that it captures whole."""
    nb_geom = len(QAGeometryTensors._fields)
    geom = QAGeometryTensors(*consts[:nb_geom])
    (x0, y0, lo, hi, r, steps, phi, pay_re, pay_im, w, moneyness,
     theta) = consts[nb_geom:nb_geom + 12]
    a_p, k0_p, k1_p, k2_p, beta_p, volvol_p = qa_panels_traced(
        geom, A_xs, kappa1, kappa2, theta, sigma0, beta_xs, volvol_xs, x0=x0, y0=y0)
    zeros = torch.zeros_like(k0_p)
    series = _scalar_series(None, a_p, zeros, k0_p, k1_p, k2_p, beta_p, volvol_p, zeros,
                            UnderlyingType.SWAP)                     # (P, 7, T)
    return _series_price(series, sigma0 - theta, lo, hi, r, steps, phi, pay_re, pay_im, w,
                         moneyness, *consts[nb_geom + 12:])


class TracedSwaptionCubeFn:
    """``price(sigma0, A_xs, beta_xs, volvol_xs, kappa1, kappa2) -> (P,
    K_max)`` call prices of a swaption cube whose annuity-measure structural
    panels (factor vols C(A), the mean-state RK4, the swap-gradient and
    annuity log-derivative panels) are computed from the arguments on the
    device (``qa_traced``), differentiable in all six.

    The static geometry is built on the host once and moved to the device
    with the stage brackets, the tanh-sinh panel and the ODE templates.  On
    a CUDA device each call is one replay of the graph
    ``"rates_cube_traced"``, keyed by the shapes, S, the mean-ODE steps and
    the expansion order (the six arguments and every constant are graph
    inputs); inside a ``torch.func`` transform or a capture it runs eagerly.
    """

    def __init__(self, params: MultiFactRateLogSvParams, slices, forwards, strikes_slices,
                 expansion_order: ExpansionOrder, nb_grid_pts: int, year_steps: int, h: float,
                 x_max: float, x0, y0, n_sub: int, device):
        self.device = device = torch.device(device)
        on = lambda a, dtype=torch.float64: torch.as_tensor(np.asarray(a), dtype=dtype,
                                                            device=device)
        n = get_expansion_n(expansion_order)
        P = len(slices)
        theta = float(params.theta)
        geom = build_qa_geometry(params, slices, nb_grid_pts=nb_grid_pts, n_sub=n_sub)
        d, n_aux = params.basis.nb_factors, params.basis.nb_aux_factors
        ttms = np.array([float(e) for e, _ in slices])
        nb_steps = max(int(np.ceil(year_steps * float(np.max(ttms)))), 16)
        interp = np.zeros((3, P, 3 * nb_steps))
        dts = []
        for i, expiry in enumerate(ttms):
            t_eval, dt = stage_times(float(expiry), nb_steps)
            interp[:, i] = stage_brackets(t_eval, geom.t_grids[i])
            dts.append(dt)
        moneyness, mask = _moneyness_panel(strikes_slices, forwards)
        nodes = _node_consts(h, x_max, on)
        x0 = np.zeros((P, d)) if x0 is None else np.broadcast_to(np.asarray(x0, float), (P, d))
        y0 = (np.zeros((P, n_aux)) if y0 is None
              else np.broadcast_to(np.asarray(y0, float), (P, n_aux)))
        self.consts = tuple(geom.on(device)) + (
            on(x0), on(y0), on(interp[0], torch.int64), on(interp[1], torch.int64),
            on(interp[2]), on(step_multipliers(dts)),
        ) + nodes + (on(moneyness), on(theta)) + templates_on(theta, n, device)
        # the slice axis of each constant (None: shared by every slice); the
        # mean-ODE stage panels are (S, 3, P, ...)
        self.slice_axes = tuple(2 if f in ("seg_stage", "BX_st", "BY_st", "P0r_st")
                                else None if f in ("D_X", "D_Y", "W_omega", "inv_B", "R_chol")
                                else 0 for f in QAGeometryTensors._fields) \
            + (0,) * 6 + (None,) * len(nodes) + (0, None) + (None,) * 7
        self.key = (P, geom.t_grids.shape[1], geom.seg_stage.shape[0], geom.dcf.shape[1], d,
                    n_aux, mask.shape[1], nb_steps, nodes[0].shape[0], n, str(device))
        self.nb_steps = nb_steps
        self.mask = torch.as_tensor(mask, device=device)
        self.defaults = (float(params.sigma0), np.asarray(params.A, dtype=float),
                         np.asarray(params.beta.xs, dtype=float),
                         np.asarray(params.volvol.xs, dtype=float), float(params.kappa1),
                         float(params.kappa2))

    def primals(self, sigma0=None, A_xs=None, beta_xs=None, volvol_xs=None, kappa1=None,
                kappa2=None) -> Tuple[torch.Tensor, ...]:
        """the six arguments as float64 tensors on the device (the build's
        parameters where None)."""
        args = (sigma0, A_xs, beta_xs, volvol_xs, kappa1, kappa2)
        values = (d if a is None else a for a, d in zip(args, self.defaults))
        return tuple(v.to(torch.float64) if isinstance(v, torch.Tensor)
                     else torch.as_tensor(np.asarray(v, dtype=np.float64), device=self.device)
                     for v in values)

    def price_and_dead(self, sigma0, A_xs, beta_xs, volvol_xs, kappa1, kappa2
                       ) -> Tuple[torch.Tensor, torch.Tensor]:
        """(prices (P, K_max), dead tanh-sinh nodes (P, N)), through the graph
        on a card."""
        inputs = self.primals(sigma0, A_xs, beta_xs, volvol_xs, kappa1, kappa2) + self.consts
        if graphs.use_graph(inputs[0]):
            return graphs.run_captured("rates_cube_traced", self.key, _traced_cube_price,
                                       inputs)
        return _traced_cube_price(*inputs)

    def __call__(self, sigma0, A_xs, beta_xs, volvol_xs, kappa1, kappa2) -> torch.Tensor:
        return self.price_and_dead(sigma0, A_xs, beta_xs, volvol_xs, kappa1, kappa2)[0]


def make_swaption_cube_fn_traced(params: MultiFactRateLogSvParams,
                                 slices,
                                 forwards,
                                 strikes_slices,
                                 expansion_order: ExpansionOrder = ExpansionOrder.FIRST,
                                 nb_grid_pts: int = 31,
                                 year_steps: int = 48,
                                 h: float = 0.125,
                                 x_max: float = 2.75,
                                 x0: Optional[np.ndarray] = None,
                                 y0: Optional[np.ndarray] = None,
                                 mesh=None,
                                 n_sub: int = 2,
                                 engine: str = "auto",
                                 device="cuda") -> Tuple[TracedSwaptionCubeFn, torch.Tensor]:
    """whole-cube swaption pricer with the QA structural panels traced.

    The same inversion as :func:`make_swaption_cube_fn`, but the
    annuity-measure structural pipeline (factor vols C(A), the frozen-drift
    mean-state ODE, swap-gradient and annuity log-derivative panels) runs on
    the device (``qa_traced``) instead of being frozen host constants, so
    ``A_xs``, ``kappa1``, ``kappa2`` and ``sigma0`` are calibratable inputs:
    derivatives go through the structure, and an A prefit reprices one
    cached program.  Panel accuracy is that of the fixed-step RK4 of the
    mean ODE (``n_sub`` substeps per grid interval, ~1e-9 from a tight
    ``solve_ivp`` at n_sub = 2), where the frozen cube follows scipy at
    rtol 1e-3.  Returns ``(price, mask)``: a :class:`TracedSwaptionCubeFn`,
    ``price(sigma0, A_xs, beta_xs, volvol_xs, kappa1, kappa2) -> (P,
    K_max)``, and the validity panel.  ``mesh`` splits the slice axis as in
    :func:`make_swaption_cube_fn`; ``engine`` is kept for the signature.
    """
    _check_signature_only(engine)
    assert len(forwards) == len(slices) and len(strikes_slices) == len(slices)
    cube = TracedSwaptionCubeFn(params, slices, forwards, strikes_slices, expansion_order,
                                nb_grid_pts, year_steps, h, x_max, x0, y0, n_sub,
                                _cube_device(device, mesh))
    return _on_mesh(cube, mesh), cube.mask


# ----------------------------------------------------------------------------
# pricer classes
# ----------------------------------------------------------------------------

class RateLogSVPricer(ModelPricer):
    """swaption pricer (Corollary 4.2 on the Theorem 6.1 expansion) on
    ``device``."""

    def price_chain(self, option_chain, params, is_spot_measure: bool = True,
                    **kwargs) -> list:
        """normal ivols [tenor][expiry] of the expiries ``kwargs['idxs']`` by
        the adaptive tanh-sinh pricer on ``kwargs['t_grid']``."""
        t_grid = kwargs['t_grid']
        idxs = kwargs['idxs']
        ttms = np.array(option_chain.ttms[idxs])
        forwards = [option_chain.forwards[i][idxs] for i, _ in enumerate(option_chain.tenors)]
        strikes_ttms = [option_chain.strikes_ttms[i][idxs]
                        for i, _ in enumerate(option_chain.tenors)]
        optiontypes_ttms = option_chain.optiontypes_ttms[idxs]
        return logsv_chain_de_pricer(params=params, t_grid=t_grid, ttms=ttms,
                                     forwards=forwards, strikes_ttms=strikes_ttms,
                                     optiontypes_ttms=optiontypes_ttms,
                                     expansion_order=ExpansionOrder.FIRST,
                                     device=self.device)[1]

    def model_mc_price_chain(self, option_chain, params, nb_path: int = 100000, **kwargs):
        raise NotImplementedError("use factor_hjm_pricer.calc_mc_vols")

    def calibrate_model_params_to_chain(self, option_chain, params0,
                                        max_expiry: Optional[float] = None,
                                        nb_iters: int = 24,
                                        year_steps: int = 360,
                                        **kwargs):
        """joint LM fit of the (beta, volvol) term structure to a
        SwOptionChain cube on ``device``
        (``fast_calibration.calibrate_rate_logsv_cube_lm_on_device``, its
        keywords through ``kwargs``), the expiries cut at ``max_expiry``
        (default: where the parameters' term structure ends).  Returns
        ``(fitted MultiFactRateLogSvParams, LM cost)``."""
        from stochvolmodels_torch.models.factor_hjm.fast_calibration import (
            calibrate_rate_logsv_cube_lm_on_device,
            swaption_chain_to_cube,
        )
        if max_expiry is None:
            max_expiry = float(params0.ts[-1])
        slices, forwards, strikes_slices, ivols_slices = swaption_chain_to_cube(
            option_chain, max_expiry=max_expiry)
        return calibrate_rate_logsv_cube_lm_on_device(
            params0, slices, forwards, strikes_slices, ivols_slices, nb_iters=nb_iters,
            year_steps=year_steps, device=self.device, **kwargs)


class RateFutLogSVPricer(ModelPricer):
    """pricer for rate futures and options on rate futures (Sec. 4.2) on
    ``device``."""

    def price_chain(self, option_chain, params, is_spot_measure: bool = True,
                    **kwargs) -> list:
        t_grid = kwargs['t_grid']
        idxs = kwargs['idxs']
        ttms = np.array(option_chain.ttms[idxs])
        forwards = [option_chain.forwards[idxs]]
        strikes_ttms = [option_chain.strikes_ttms[idxs]]
        optiontypes_ttms = [option_chain.optiontypes_ttms[0]]
        return logsv_chain_de_pricer(
            params=params, t_grid=t_grid, ttms=ttms, forwards=forwards,
            strikes_ttms=strikes_ttms, optiontypes_ttms=optiontypes_ttms,
            underlying_type=UnderlyingType.FUTURES,
            expansion_order=kwargs.get('expansion_order', ExpansionOrder.FIRST),
            x0=kwargs.get('x0'), y0=kwargs.get('y0'), device=self.device)[1]

    def model_mc_price_chain(self, option_chain, params, nb_path: int = 100000, **kwargs):
        raise NotImplementedError

    @classmethod
    def populate_betas(cls, beta: float, basis: NelsonSiegel) -> np.ndarray:
        """per-factor volatility betas from a scalar."""
        if basis.get_nb_factors() == 3:
            return np.array([beta, -0.5 * beta, 0.0])
        if basis.get_nb_factors() == 1:
            return np.array([beta])
        raise NotImplementedError


# ----------------------------------------------------------------------------
# multi-factor Monte Carlo (the Euler scheme of Eq. 124)
# ----------------------------------------------------------------------------

def make_mc_array(x: np.ndarray, nb_path: int) -> np.ndarray:
    """broadcast an initial state vector to a (path, state) panel."""
    return np.tile(np.asarray(x, dtype=float), (nb_path, 1))


def _mf_segment(x, y, I, log_vol, scal, beta_s, volvol_s, C_s, Omega_s, vt2_s, W0, W1,
                D_X, D_Y, B0_X, B0_Y, *extra, measure: Measure, is_dln: bool):
    """``W0.shape[0]`` Euler steps of (X, Y, I, ln sigma) from the carry:
    the per-step slabs (beta, volvol, C, Omega, vartheta^2, the scaled
    normals W0 (L, P, d) and W1 (L, P)), ``scal`` = [dt, kappa1 theta,
    kappa1 - kappa2 theta, kappa2], and ``extra``: the annuity's (dcfs, BPX,
    BPY, df ratio), the T-forward's (BPX,), then the DLN's (A, y const, KX,
    KY, Omega bilinear form, B^-1, chol(R), b).  The arithmetic follows the
    JAX package's scan step in its order; no read back to the host, so that
    it captures whole."""
    dt, kt, k1mk2t, kappa2 = scal.unbind()
    D_XT, D_YT = D_X.T, D_Y.T
    if measure == Measure.ANNUITY:
        dcfs, BPX, BPY, dfr = extra[:4]
        extra = extra[4:]
    elif measure == Measure.FORWARD:
        BPX, = extra[:1]
        extra = extra[1:]
    if is_dln:
        A_s, yconst_s, KX, KY, OmegaGR, inv_B, R_chol, bxs = extra
    for s in range(W0.shape[0]):
        beta_t, volvol_t, C_t, Omega_t, vt2 = beta_s[s], volvol_s[s], C_s[s], Omega_s[s], vt2_s[s]
        w0, w1 = W0[s], W1[s]
        sigma = torch.exp(log_vol)
        sigma2 = sigma * sigma
        adj_x_drift = adj_vol_drift = None
        if measure == Measure.ANNUITY:
            BPX_t, BPY_t, dfr_t = BPX[s], BPY[s], dfr[s]
            bonds = dfr_t[None, :] * torch.exp(-torch.einsum('pd,id->pi', x, BPX_t)
                                               - torch.einsum('pm,im->pi', y, BPY_t))
            ann0 = torch.einsum('i,pi->p', dcfs, bonds)
            ann1 = -torch.einsum('i,pi,id->pd', dcfs, bonds, BPX_t)
            d_loga_dx = ann1 / ann0[:, None]
            adj_x_drift = torch.einsum('pd,ed->pe', d_loga_dx, C_t @ C_t.T) * sigma2[:, None]
            adj_vol_drift = sigma * (d_loga_dx @ (C_t @ beta_t))
        elif measure == Measure.FORWARD:
            BPX_t = BPX[s]
            CxCxB_P = (C_t @ C_t.T) @ BPX_t
            adj_x_drift = -CxCxB_P[None, :] * sigma2[:, None]
            adj_vol_drift = -sigma * (BPX_t @ C_t @ beta_t)

        I = I + dt * (x @ B0_X + y @ B0_Y)
        if is_dln:
            # per-path factor vols C_p = B^-1 diag(v_p) chol(R), v_p = A_t + b
            # .. (key-tenor yields of path p); the SV driver is frozen
            ys = yconst_s[s][None, :] + x @ KX.T + y @ KY.T
            v = A_s[s][None, :] + bxs[None, :] * ys
            omega_p = torch.einsum('mkl,pk,pl->pm', OmegaGR, v, v)
            shock = (v * (w0 @ R_chol.T)) @ inv_B.T
            y = y + dt * (y @ D_YT + omega_p)
            x = x + dt * x @ D_XT + shock * sigma[:, None]
        else:
            y = y + dt * (y @ D_YT + Omega_t[None, :] * sigma2[:, None])
            x = x + dt * x @ D_XT + (w0 @ C_t.T) * sigma[:, None]
            if adj_x_drift is not None:
                x = x + adj_x_drift * dt
            log_vol = (log_vol + ((kt / sigma) - (k1mk2t + 0.5 * vt2) - kappa2 * sigma) * dt
                       + w0 @ beta_t + volvol_t * w1)
            if adj_vol_drift is not None:
                log_vol = log_vol + adj_vol_drift * dt
    return x, y, I, log_vol


def simulate_logsv_MF(ttms: np.ndarray,
                      x0: np.ndarray,
                      y0: np.ndarray,
                      I0: np.ndarray,
                      sigma0: np.ndarray,
                      theta: float,
                      kappa1: float,
                      kappa2: float,
                      ts: np.ndarray,
                      A: np.ndarray,
                      R: np.ndarray,
                      C: np.ndarray,
                      Omega: np.ndarray,
                      betaxs: np.ndarray,
                      volvolxs: np.ndarray,
                      basis: NelsonSiegel,
                      ts_sw: Optional[np.ndarray],
                      T_fwd: Optional[float],
                      ccy: str,
                      measure_type: Measure = Measure.RISK_NEUTRAL,
                      nb_path: int = 100000,
                      seed: Optional[int] = None,
                      year_days: int = 360,
                      bxs: Optional[np.ndarray] = None,
                      W: Optional[Tuple[np.ndarray, np.ndarray]] = None,
                      device="cuda",
                      **kwargs) -> Tuple[list, list, list, list]:
    """joint Euler of (X, Y, I, ln sigma) under the selected measure on
    ``device``: the per-step coefficient panels are made on the host, the
    paths (P, state) live on the device.  Returns the states (x, y, I,
    sigma) at each of ``ttms`` (which must lie on the ``set_time_grid``
    grid of the last one) as lists of numpy arrays.

    ``bxs`` switches on the displaced-log-normal skew branch: per-path factor
    vols C_p = B^-1 diag(A_t + b .. y_p) chol(R) from the simulated key-tenor
    yields y_p, applied as the shock B^-1 (v .. (chol(R) w)) with the per-path
    Omega a fixed (aux, d, d) bilinear form in v; it needs the risk-neutral
    measure and a frozen SV driver, as the JAX package asserts.

    The normals come from a ``torch.Generator`` seeded with ``seed`` (16 when
    None, as the JAX package's key): each segment's (L, P, d) and (L, P)
    standard normals are drawn in two calls before the segment runs, so the
    two packages give different paths from one seed.  ``W`` injects
    unscaled standard normals ((S, P, d), (S, P)) instead, the matched-
    randoms hook.  On a CUDA device each segment between requested
    maturities is one captured graph (``"rates_mc"``, keyed by the measure,
    the branch and the shapes); drawing before the replay keeps the
    generator out of the graph.
    """
    device = torch.device(device)
    ttm = float(ttms[-1])
    nb_factors = basis.get_nb_factors()
    nb_aux = basis.get_nb_aux_factors()
    if x0.ndim == 1:
        x0 = make_mc_array(x0, nb_path)
    if y0.ndim == 1:
        y0 = make_mc_array(y0, nb_path)
    if I0.shape[0] == 1:
        I0 = np.zeros(nb_path)
    if sigma0.ndim == 2:
        sigma0 = sigma0[:, 0]
    if sigma0.shape[0] == 1:
        sigma0 = sigma0 * np.ones(nb_path)

    nb_steps, dt, grid_t = set_time_grid(ttm=ttm, nb_steps_per_year=year_days)
    sdt = float(np.sqrt(dt))
    on = lambda a: torch.as_tensor(np.asarray(a, dtype=np.float64), device=device)

    # per-step coefficient panels
    idx_ts = np.array([bracket(ts[1:], float(t), True) for t in grid_t[:nb_steps]])
    beta_steps = np.asarray(betaxs)[idx_ts]                          # (S, d)
    volvol_steps = np.asarray(volvolxs)[idx_ts]                      # (S,)
    steps = [on(beta_steps), on(volvol_steps), on(np.asarray(C)[idx_ts]),
             on(np.asarray(Omega)[idx_ts])]
    steps.append(torch.einsum('sd,sd->s', steps[0], steps[0]) + steps[1] ** 2)
    consts = [on(basis.get_generating_matrix()), on(basis.get_aux_generating_matrix()),
              on(basis.get_basis(0.0)), on(basis.get_aux_basis(0.0))]
    extra_steps, extra_consts = [], []

    # measure-dependent precomputations
    if measure_type == Measure.ANNUITY:
        assert ts_sw is not None
        n_pmt = ts_sw.size - 1
        BPX_pmt = np.zeros((nb_steps, n_pmt, nb_factors))
        BPY_pmt = np.zeros((nb_steps, n_pmt, nb_aux))
        df_ratio = np.zeros((nb_steps, n_pmt))
        for s, t in enumerate(grid_t[:nb_steps]):
            for i in range(1, ts_sw.size):
                bx, by = basis.bond_coeffs(ts_sw[i] - t)
                BPX_pmt[s, i - 1] = bx
                BPY_pmt[s, i - 1] = by
                df_ratio[s, i - 1] = df_fast(ts_sw[i], ccy) / df_fast(t, ccy)
        extra_consts.append(on(ts_sw[1:] - ts_sw[:-1]))
        extra_steps += [on(BPX_pmt), on(BPY_pmt), on(df_ratio)]
    elif measure_type == Measure.FORWARD:
        assert T_fwd is not None
        BPX_fwd = np.zeros((nb_steps, nb_factors))
        for s, t in enumerate(grid_t[:nb_steps]):
            BPX_fwd[s] = basis.bond_coeffs(T_fwd - t)[0]
        extra_steps.append(on(BPX_fwd))

    is_dln = bxs is not None
    dln_steps, dln_consts = [], []
    if is_dln:
        # the JAX package's preconditions: skew comes only from the DLN
        # displacement, the SV driver is frozen
        assert measure_type == Measure.RISK_NEUTRAL
        assert np.all(np.abs(betaxs) <= 1e-8) and np.all(volvolxs <= 1e-8)
        assert abs(kappa1) <= 1e-8 and abs(kappa2) <= 1e-8
        bxs = np.asarray(bxs, dtype=float)
        assert bxs.shape == (nb_factors,)
        inv_B = np.linalg.inv(basis.get_matrix_B())
        R_chol = np.linalg.cholesky(np.asarray(R, dtype=float))
        key_terms = np.asarray(basis.key_terms, dtype=float)
        # key-tenor yields are affine in the state: y_i = c_i(t) + KX_i.x + KY_i.y
        BPX_tenor = np.stack([basis.bond_coeffs(tau)[0] for tau in key_terms])
        BPY_tenor = np.stack([basis.bond_coeffs(tau)[1] for tau in key_terms])
        y_const = np.zeros((nb_steps, nb_factors))
        for s, t in enumerate(grid_t[:nb_steps]):
            for i, tau in enumerate(key_terms):
                y_const[s, i] = -np.log(df_fast(t + tau, ccy) / df_fast(t, ccy)) / tau
        # Omega_p = calc_Omega(B^-1 diag(v_p) R diag(v_p) B^-T): a bilinear
        # form in v_p, its (aux, d, d) coefficients once
        OmegaG = np.zeros((nb_aux, nb_factors, nb_factors))
        for kk in range(nb_factors):
            for ll in range(nb_factors):
                E = np.zeros((nb_factors, nb_factors))
                E[kk, ll] = 1.0
                OmegaG[:, kk, ll] = basis.calc_Omega(inv_B @ E @ inv_B.T)
        dln_steps = [on(np.asarray(A, dtype=float)[idx_ts]), on(y_const)]
        dln_consts = [on(BPX_tenor / key_terms[:, None]), on(BPY_tenor / key_terms[:, None]),
                      on(OmegaG * np.asarray(R, dtype=float)[None, :, :]), on(inv_B),
                      on(R_chol), on(bxs)]

    scal = on([dt, kappa1 * theta, kappa1 - kappa2 * theta, kappa2])
    if W is None:
        gen = generator_from_seed(16 if seed is None else seed, device=device)
    else:
        W = (on(W[0]) * sdt, on(W[1]) * sdt)

    idx_ttms = [int(np.where(np.isclose(grid_t, t))[0][0]) for t in ttms]
    x0s, y0s, I0s, sigma0s = [], [], [], []
    carry = (on(x0), on(y0), on(I0), torch.log(on(sigma0)))
    if 0 in idx_ttms:
        x0s.append(carry[0].cpu().numpy()), y0s.append(carry[1].cpu().numpy())
        I0s.append(carry[2].cpu().numpy()), sigma0s.append(np.exp(carry[3].cpu().numpy()))

    # run the steps in segments ending at each requested maturity
    run = lambda *a: _mf_segment(*a, measure=measure_type, is_dln=is_dln)
    seg_start = 0
    for idx_ttm in idx_ttms:
        if idx_ttm == 0:
            continue
        L = idx_ttm - seg_start
        if W is None:
            W0 = step_normals(gen, (L, nb_path, nb_factors)) * sdt
            W1 = step_normals(gen, (L, nb_path)) * sdt
        else:
            W0, W1 = W[0][seg_start:idx_ttm], W[1][seg_start:idx_ttm]
        seg = lambda slabs: [a[seg_start:idx_ttm] for a in slabs]
        inputs = (carry + (scal,) + tuple(seg(steps)) + (W0, W1) + tuple(consts)
                  + tuple(extra_consts) + tuple(seg(extra_steps)) + tuple(seg(dln_steps))
                  + tuple(dln_consts))
        if graphs.use_graph(scal):
            key = (measure_type.value, is_dln, L, nb_path, nb_factors, nb_aux,
                   tuple(extra_steps[0].shape[1:]) if extra_steps else (), str(device))
            carry = graphs.run_captured("rates_mc", key, run, inputs)
        else:
            carry = run(*inputs)
        seg_start = idx_ttm
        x0s.append(carry[0].cpu().numpy())
        y0s.append(carry[1].cpu().numpy())
        I0s.append(carry[2].cpu().numpy())
        sigma0s.append(np.exp(carry[3].cpu().numpy())[:, None])
    return x0s, y0s, I0s, sigma0s


def _futures_scan(init, inputs, normals, theta, kappa1, kappa2, *, dt, sdt, nb_path, d):
    """the futures Euler over the S steps of ``inputs`` = (step index, a0,
    a1, beta . eta, eta, beta, volvol, vartheta^2) from ``init`` = (zeta,
    ln sigma): the final carry.  ``normals`` = (W0 (S, P, d), W1 (S, P)) are
    the unscaled standard normals of the steps (the JAX package folds the
    step index into its key instead); ``theta``, ``kappa1`` and ``kappa2``
    are 0-d tensors.  No read back to the host, so that it captures whole."""
    del nb_path, d
    zeta, log_vol = init
    _, a0, a1, adj, eta_s, beta_s, volvol_s, vartheta2_s = inputs
    W0, W1 = normals
    for s in range(a0.shape[0]):
        a0_t, a1_t, adj_t, eta_t = a0[s], a1[s], adj[s], eta_s[s]
        beta_t, volvol_t, vartheta2 = beta_s[s], volvol_s[s], vartheta2_s[s]
        w0 = W0[s] * sdt
        w1 = W1[s] * sdt
        sigma = torch.exp(log_vol)
        sigma2 = sigma * sigma
        drift = -(a0_t @ a0_t) * 0.5 - 0.5 * a1_t * a1_t - (a0_t @ eta_t)
        zeta = zeta + drift * sigma2 * dt + sigma * (w0 @ a0_t) + sigma * w1 * a1_t
        log_vol = (log_vol + ((kappa1 * theta / sigma)
                              - (kappa1 - kappa2 * theta + 0.5 * vartheta2)
                              - (kappa2 + adj_t) * sigma) * dt
                   + w0 @ beta_t + volvol_t * w1)
    return zeta, log_vol


def simulate_logsv_futures_MF(params: MultiFactRateLogSvParams,
                              ttm: float,
                              t_start: float,
                              t_end: float,
                              basis_type: str = "NELSON-SIEGEL",
                              f0: Optional[float] = None,
                              nb_path: int = 100000,
                              seed: Optional[int] = None,
                              year_steps: int = 720,
                              device="cuda") -> np.ndarray:
    """terminal futures rates F_ttm simulated under the T-forward measure on
    ``device``: the log-shifted rate zeta = ln(F + 1/Delta) follows an
    exponential martingale with loadings a0(t) = a(t) + beta(t) h1(t),
    a1(t) = volvol(t) h1(t) from the QT transform and the convexity
    adjustment's dense output, and the vol drift picks up the measure-change
    term beta . eta.  The normals come from a ``torch.Generator`` (seed 16
    when None), the whole path's (S, P, d) and (S, P) drawn in two calls
    before the steps; on a card the steps are one captured graph
    (``"rates_futures_mc"``).  Returns the (nb_path,) rates, numpy."""
    device = torch.device(device)
    Delta = t_end - t_start
    nb_steps, dt, grid_t = set_time_grid(ttm=float(ttm), nb_steps_per_year=year_steps)
    sdt = float(np.sqrt(dt))
    d = params.basis.nb_factors

    _, _, h1_dense, _, _ = futures_conv_adj(
        t_start=t_start, basis_type=basis_type, params=params, t0=0.0, Delta=Delta,
        settlement_type=FutSettleType.EURODOLLAR, expansion_order=ExpansionOrder.ZERO,
        dense_output=True, t_grid=grid_t, device=device)
    a, eta, _, _, _, beta, volvol = params.transform_QT_params(
        expiry=float(ttm), t_start=t_start, t_end=t_end, t_grid=grid_t)

    if f0 is None:
        f0 = float(np.asarray(calc_futures_rate(
            ccy=params.ccy, basis_type=basis_type, params=params,
            x0=np.zeros((1, d)), y0=np.zeros((1, params.basis.nb_aux_factors)),
            sigma0=params.sigma0 * np.ones((1, 1)), t0=0.0, t_start=t_start, t_end=t_end,
            Delta=Delta, settlement_type=FutSettleType.EURODOLLAR,
            expansion_order=ExpansionOrder.FIRST, device=device)[0]).ravel()[0])

    # per-step panels at the step start times
    S = nb_steps
    on = lambda x: torch.as_tensor(np.asarray(x, dtype=np.float64), device=device)
    inputs = (torch.arange(S, device=device),
              on(a[:S] + beta[:S] * np.asarray(h1_dense)[:S, None]),
              on(volvol[:S] * np.asarray(h1_dense)[:S]),
              on(np.einsum('sd,sd->s', beta[:S], eta[:S])), on(eta[:S]), on(beta[:S]),
              on(volvol[:S]), on(np.einsum('sd,sd->s', beta[:S], beta[:S]) + volvol[:S] ** 2))
    init = (torch.full((nb_path,), float(np.log(f0 + 1.0 / Delta)), dtype=torch.float64,
                       device=device),
            torch.full((nb_path,), float(np.log(params.sigma0)), dtype=torch.float64,
                       device=device))
    gen = generator_from_seed(16 if seed is None else seed, device=device)
    normals = (step_normals(gen, (S, nb_path, d)), step_normals(gen, (S, nb_path)))
    scal = (on(params.theta), on(params.kappa1), on(params.kappa2))
    static = dict(dt=float(dt), sdt=sdt, nb_path=nb_path, d=d)
    run = lambda z, lv, *rest: _futures_scan(
        (z, lv), rest[:8], rest[8:10], *rest[10:], **static)
    flat = init + inputs + normals + scal
    if graphs.use_graph(init[0]):
        key = (S, nb_path, d, float(dt), str(device))
        zeta, _ = graphs.run_captured("rates_futures_mc", key, run, flat)
    else:
        zeta, _ = run(*flat)
    return (torch.exp(zeta) - 1.0 / Delta).cpu().numpy()


def calc_futures_mc_vols(params: MultiFactRateLogSvParams,
                         ttm: float,
                         t_start: float,
                         t_end: float,
                         strikes: np.ndarray,
                         optiontypes: np.ndarray,
                         basis_type: str = "NELSON-SIEGEL",
                         nb_path: int = 100000,
                         seed: Optional[int] = None,
                         device="cuda") -> Tuple[float, np.ndarray, np.ndarray]:
    """(f0, MC normal vols, MC stderr of the price) of futures options:
    simulate F_ttm under Q^T on ``device``, average the payoffs on the host
    and imply Bachelier vols on ``device``."""
    f_t = simulate_logsv_futures_MF(params=params, ttm=ttm, t_start=t_start, t_end=t_end,
                                    basis_type=basis_type, nb_path=nb_path, seed=seed,
                                    device=device)
    f0 = float(np.mean(f_t))
    strikes = np.asarray(strikes)
    is_call = np.asarray([str(o) == 'C' for o in np.asarray(optiontypes)])
    payoff = np.where(is_call[:, None],
                      np.maximum(f_t[None, :] - strikes[:, None], 0.0),
                      np.maximum(strikes[:, None] - f_t[None, :], 0.0))
    prices = payoff.mean(axis=1)
    stderrs = payoff.std(axis=1) / np.sqrt(nb_path)
    on = lambda x: torch.as_tensor(np.asarray(x, dtype=np.float64), device=device)
    vols = infer_normal_ivols_from_slice_prices(
        ttm=on(ttm), forward=f0, strikes=strikes, optiontypes=np.asarray(optiontypes),
        model_prices=prices, discfactor=1.0).cpu().numpy()
    return f0, vols, stderrs
