"""
Swaption and rate-futures pricers for the factor HJM model with a LogSV driver
(Sepp & Rakhmonov 2025, RDR 28:12).

PyTorch counterpart of the analytic half of
``stochvolmodels_tpu/models/factor_hjm/rate_logsv_pricer.py``: the adaptive
tanh-sinh chain pricer (swaptions on the normal-moneyness kernel
1/(pi phi^2), futures on the log-shifted kernel 1/(pi phi (phi+1)) with the
convexity adjustment of Theorem 3.3), the fixed-panel differentiable slice
and cube pricers, and the ModelPricer classes.

On a CUDA device a cube reprice is one captured graph (``"rates_cube"``):
all P slices, the S shared RK4 steps, the tanh-sinh inversion and the (P, K)
integral, keyed by the cube's shapes and S, with the frozen panels as graph
inputs; each ``ff`` batch of the adaptive pricer is one graph of the RK4
(``"rates_ode"``), keyed by (padded batch, steps, expansion order).  The
``engine=`` argument of the JAX package ('auto' | 'f64' | 'df32') is
accepted and always runs float64/complex128; ``mesh=`` must be None.

Not ported yet (ROADMAP section 1, item 4): the traced-panel cube
(``make_swaption_cube_fn_traced``, it needs ``qa_traced``), the cube
calibration (``RateLogSVPricer.calibrate_model_params_to_chain``, it needs
``fast_calibration``'s cube LM) and the multi-factor Monte Carlo; each
raises ``NotImplementedError``.
"""
from __future__ import annotations

from enum import Enum
from typing import Optional, Tuple

import numpy as np
import torch

from stochvolmodels_torch.models.factor_hjm.conv_adj import conv_adj_linear_block, solve_conv_adj
from stochvolmodels_torch.models.factor_hjm.double_exp_pricer import de_pricer, tanh_sinh_nodes
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
from stochvolmodels_torch.utils.rate_core import generate_ttms_grid, get_futures_start_and_pmt

NOT_PORTED = "not ported yet: ROADMAP section 1, item 4"
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


def _check_signature_only(engine: str, mesh) -> None:
    """``engine`` and ``mesh`` are kept for the JAX package's signature."""
    if engine not in ENGINES:
        raise ValueError(f"engine must be one of {ENGINES}, got {engine!r}")
    if mesh is not None:
        raise NotImplementedError("mesh: the port prices a cube on one device; pass mesh=None")


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
    n = h.shape[0]
    nb_slices, nb_steps = lo.shape[0], lo.shape[1] // 3
    beta_interp = beta_xs[idx_t]                                     # (P, T, d)
    beta2 = torch.einsum('ptd,ptd->pt', beta_interp, CT_loga)
    zeros = torch.zeros_like(beta2)
    series = _scalar_series(None, a_interp, zeros, beta2 * theta * theta,
                            kappa1 - kappa2 * theta + 2.0 * (kappa2 - beta2) * theta,
                            kappa2 - beta2, beta_interp, volvol_xs[idx_t], zeros,
                            UnderlyingType.SWAP)                     # (P, 7, T)
    coeffs = interp_series(series, lo, hi, r)                        # (P, 7, 3S)
    stage_coeffs = coeffs.reshape(nb_slices, 7, nb_steps, 3).permute(0, 2, 1, 3)
    a_t0 = torch.zeros((nb_slices, phi.shape[0], n), dtype=torch.complex128, device=phi.device)
    a_t1, dead = rk4_batch(phi, steps, stage_coeffs, a_t0, TM, K0, K1, K2, V, P, h)
    mgf = contract_log_mgf(a_t1, sigma0 - theta, n)                  # (P, N)
    z_re = moneyness[:, None, :] * phi.real[None, :, None] + mgf.real[:, :, None]
    z_im = moneyness[:, None, :] * phi.imag[None, :, None] + mgf.imag[:, :, None]
    e = torch.exp(z_re)
    integrand = e * (pay_re[None, :, None] * torch.cos(z_im)
                     - pay_im[None, :, None] * torch.sin(z_im))
    return torch.einsum('n,pnk->pk', w, integrand), dead


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
        K_max = max(len(s) for s in strikes_slices)
        moneyness = np.zeros((P, K_max))
        mask = np.zeros((P, K_max), dtype=bool)
        for i, (strikes, fwd) in enumerate(zip(strikes_slices, forwards)):
            k = len(strikes)
            moneyness[i, :k] = np.asarray(strikes, dtype=float) - float(fwd)
            mask[i, :k] = True
        p_nodes, w_nodes = tanh_sinh_nodes(h=h, x_max=x_max)
        phi_re = np.full(p_nodes.shape, -0.5)
        pay_re, pay_im = _payoff_factor(phi_re, p_nodes, futures=False)
        theta = float(params.theta)
        self.consts = (
            on(idx_all, torch.int64), on(ct_all), on(a_all), on(interp[0], torch.int64),
            on(interp[1], torch.int64), on(interp[2]), on(step_multipliers(dts)),
            torch.complex(on(phi_re), on(p_nodes)), on(pay_re), on(pay_im), on(w_nodes),
            on(moneyness), on([theta, float(params.kappa1), float(params.kappa2)]),
        ) + templates_on(theta, n, device)
        self.key = (P, T, d, K_max, nb_steps, p_nodes.size, n, str(device))
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
    _check_signature_only(engine, None)
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
    ``engine`` and ``mesh`` (which must be None) are kept for the signature.
    """
    _check_signature_only(engine, mesh)
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
    cube = SwaptionCubeFn(params, panels, strikes_slices, forwards, nb_steps, expansion_order,
                          h, x_max, device)
    return cube, cube.mask


def make_swaption_cube_fn_traced(*args, **kwargs):
    """the cube with the QA structural panels traced: not ported yet (it
    needs ``qa_traced``)."""
    raise NotImplementedError(f"make_swaption_cube_fn_traced is {NOT_PORTED}")


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

    def calibrate_model_params_to_chain(self, option_chain, params0=None, **kwargs):
        """the joint cube LM fit: not ported yet (it needs
        ``fast_calibration``'s cube LM)."""
        raise NotImplementedError(f"RateLogSVPricer.calibrate_model_params_to_chain is "
                                  f"{NOT_PORTED}")


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
# multi-factor Monte Carlo: not ported yet
# ----------------------------------------------------------------------------

def make_mc_array(x: np.ndarray, nb_path: int) -> np.ndarray:
    """broadcast an initial state vector to a (path, state) panel."""
    return np.tile(np.asarray(x, dtype=float), (nb_path, 1))


def simulate_logsv_MF(*args, **kwargs):
    """the joint factor/vol Monte Carlo: not ported yet."""
    raise NotImplementedError(f"simulate_logsv_MF is {NOT_PORTED}")


def simulate_logsv_futures_MF(*args, **kwargs):
    """the futures Monte Carlo: not ported yet."""
    raise NotImplementedError(f"simulate_logsv_futures_MF is {NOT_PORTED}")


def calc_futures_mc_vols(*args, **kwargs):
    """the futures Monte Carlo vols: not ported yet."""
    raise NotImplementedError(f"calc_futures_mc_vols is {NOT_PORTED}")
