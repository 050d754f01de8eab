"""
Hawkes jump-diffusion pricer with self- and cross-exciting jump intensities
(Liu, Packham & Sepp 2025, arXiv:2510.21297).

PyTorch counterpart of ``stochvolmodels_tpu/models/hawkes_jd.py`` for the
serving path.  The model is affine: its log-MGF solves a 3-dim complex
Riccati system, integrated by a float64 RK4 over the whole (N, 3) complex128
transform grid at once, with the ODE state chained across maturities.  The
risk-premia pricer shifts the payoff kernel by gamma and prices against the
gamma-forwards.  Monte Carlo runs intensity thinning at 1800 steps/yr,
either eagerly in float64 (``engine='scan'``) or through the hand-written
CUDA kernel ``csrc/hawkes_mc.cu`` and its plain version (``engine='cuda'``).
Calibration is not ported yet and raises.
"""
from __future__ import annotations

from dataclasses import asdict, dataclass
from typing import Any, Dict, List, Optional, Tuple

import numpy as np
import torch

from stochvolmodels_torch.config import VariableType
from stochvolmodels_torch.data.option_chain import ChainGrid, OptionChain
from stochvolmodels_torch.models.model_pricer import ModelParams, ModelPricer
from stochvolmodels_torch.ops import mgf
from stochvolmodels_torch.ops.cuda_mc import engine_setup, simulate_hawkesjd_terminal_kernel
from stochvolmodels_torch.ops.payoffs import compute_mc_vars_payoff
from stochvolmodels_torch.ops.random import generator_from_seed
from stochvolmodels_torch.utils.funcs import set_time_grid, timer

MAX_PHI = 500  # transform grid size
MC_STEPS_PER_YEAR = 5 * 360  # small dt for large intensities

# steps per year of the Riccati RK4 for each precision
_YEAR_STEPS = {"exact": 1440, "fast": 720}

# the dynamics of the model, as the MC path loops take them
_SIM_KEYS = ("mu", "sigma", "shift_p", "mean_p", "shift_m", "mean_m", "theta_p", "kappa_p",
             "beta1_p", "beta2_p", "theta_m", "kappa_m", "beta1_m", "beta2_m")


@dataclass
class HawkesJDParams(ModelParams):
    """2-factor Hawkes JD parameters; BTC daily-frequency defaults."""
    mu: float = 0.0
    sigma: float = 0.45
    shift_p: float = 0.06
    mean_p: float = 0.03
    shift_m: float = -0.06
    mean_m: float = -0.03
    lambda_p: float = 6.55
    theta_p: float = 6.55
    kappa_p: float = 22.29
    beta1_p: float = 76.0
    beta2_p: float = -67.58
    lambda_m: float = 8.50
    theta_m: float = 8.50
    kappa_m: float = 29.0
    beta1_m: float = 104.55
    beta2_m: float = -109.6
    risk_premia_gamma: Optional[float] = None

    def __post_init__(self):
        self.compensator_p = np.exp(self.shift_p) / (1.0 - self.mean_p) - 1.0
        self.compensator_m = np.exp(self.shift_m) / (1.0 - self.mean_m) - 1.0

    def to_dict(self) -> Dict[str, Any]:
        d = asdict(self)
        d.pop('compensator_p', None)
        d.pop('compensator_m', None)
        return d

    def print(self) -> None:
        for k, v in self.to_dict().items():
            print(f"{k}={v}")
        print('conditions')
        print(f"jump1={self.jump1_cond:0.4f} > 0")
        print(f"jump2={self.jump2_cond:0.4f} > 0")

    @property
    def exp_jump_p(self) -> float:
        return self.shift_p + self.mean_p

    @property
    def exp_jump_m(self) -> float:
        return self.shift_m + self.mean_m

    @property
    def jump1_cond(self) -> float:
        """stationarity margin of the positive-jump intensity."""
        return self.kappa_p - self.beta1_p * self.exp_jump_p - self.beta2_p * self.exp_jump_m

    @property
    def jump2_cond(self) -> float:
        """stationarity margin of the negative-jump intensity."""
        return self.kappa_m - self.beta2_m * self.exp_jump_m - self.beta1_m * self.exp_jump_p

    @property
    def jumps_var_p(self) -> float:
        return float(np.square(self.shift_p) + np.square(self.mean_p))

    @property
    def jumps_var_m(self) -> float:
        return float(np.square(self.shift_m) + np.square(self.mean_m))

    def sim_params(self) -> Dict[str, float]:
        """the dynamics the MC path loops take, by name."""
        return {k: float(getattr(self, k)) for k in _SIM_KEYS}


def set_vol_scaler(sigma0: float, ttm: float) -> float:
    """grid scaler: sigma clipped to [0.2, 0.5], times sqrt(min(ttm, 1/12))."""
    return float(np.clip(sigma0, 0.2, 0.5) * np.sqrt(np.minimum(ttm, 1.0 / 12.0)))


# ----------------------------------------------------------------------------
# Riccati ODE over the transform grid
# ----------------------------------------------------------------------------

def _ode_params(model_params: HawkesJDParams) -> Dict[str, float]:
    """the 13 dynamics values and the two compensators the Riccati system takes."""
    d = model_params.to_dict()
    p = {k: float(d[k]) for k in ('sigma', 'shift_p', 'mean_p', 'shift_m', 'mean_m', 'kappa_p',
                                  'theta_p', 'beta1_p', 'beta2_p', 'kappa_m', 'theta_m',
                                  'beta1_m', 'beta2_m')}
    p['compensator_p'] = float(model_params.compensator_p)
    p['compensator_m'] = float(model_params.compensator_m)
    return p


def _rhs_constants(phi: torch.Tensor, psi: torch.Tensor, p: Dict[str, float]
                   ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """the A-free terms of the right-hand side, taken once per solve:
    (phi (phi + 1)/2 - psi) sigma^2, phi compensator_p, phi compensator_m."""
    sigma2 = p['sigma'] * p['sigma']
    return ((phi * (phi + 1.0) * 0.5 - psi) * sigma2, phi * p['compensator_p'],
            phi * p['compensator_m'])


def _jump_mgf_minus_one(shift: float, mean: float, arg: torch.Tensor) -> torch.Tensor:
    """e^{-s a}/(1 + m a) - 1 in the cancellation-free form
    (expm1(-s a) - m a)/(1 + m a)."""
    ma = arg * mean
    return (torch.expm1(arg * (-shift)) - ma) / (ma + 1.0)


def _hawkes_rhs(A: torch.Tensor, phi: torch.Tensor, consts: Tuple[torch.Tensor, ...],
                p: Dict[str, float]) -> torch.Tensor:
    """Riccati right-hand side for the whole (N, 3) complex panel; ``consts``
    are the :func:`_rhs_constants` of the grid."""
    c0, c_p, c_m = consts
    a1, a2 = A[:, 1], A[:, 2]
    arg_p = phi - a1 * p['beta1_p'] - a2 * p['beta1_m']
    arg_m = phi - a1 * p['beta2_p'] - a2 * p['beta2_m']
    j_p = _jump_mgf_minus_one(p['shift_p'], p['mean_p'], arg_p)
    j_m = _jump_mgf_minus_one(p['shift_m'], p['mean_m'], arg_m)
    r0 = a1 * (p['kappa_p'] * p['theta_p']) + a2 * (p['kappa_m'] * p['theta_m']) + c0
    r1 = j_p - a1 * p['kappa_p'] + c_p
    r2 = j_m - a2 * p['kappa_m'] + c_m
    return torch.stack([r0, r1, r2], dim=1)


def solve_a_ode_grid(phi_grid: torch.Tensor,
                     ttm: float,
                     model_params: HawkesJDParams,
                     psi_grid: Optional[torch.Tensor] = None,
                     a_t0: Optional[torch.Tensor] = None,
                     nb_steps: Optional[int] = None,
                     year_steps: int = 1440
                     ) -> torch.Tensor:
    """batched RK4 of the Riccati system over the complex128 Phi grid (N,),
    from ``a_t0`` (default 0) over ``ttm`` in max(ceil(year_steps ttm), 16)
    steps; returns A(ttm), (N, 3) complex128 on the grid's device."""
    n_grid = phi_grid.shape[0]
    if psi_grid is None:
        psi_grid = torch.zeros_like(phi_grid)
    if a_t0 is None:
        a_t0 = torch.zeros((n_grid, 3), dtype=phi_grid.dtype, device=phi_grid.device)
    if nb_steps is None:
        nb_steps = max(int(np.ceil(year_steps * float(ttm))), 16)
    dt = float(ttm) / nb_steps
    return _solve_a_ode_grid_p(phi_grid, psi_grid, a_t0, nb_steps, dt, _ode_params(model_params))


def _solve_a_ode_grid_p(phi_grid: torch.Tensor, psi_grid: torch.Tensor, a_t0: torch.Tensor,
                        nb_steps: int, dt: float, p: Dict[str, float]) -> torch.Tensor:
    """RK4 core over a params dict, one eager step at a time."""
    consts = _rhs_constants(phi_grid, psi_grid, p)
    rhs = lambda A: _hawkes_rhs(A, phi_grid, consts, p)
    A = a_t0
    for _ in range(nb_steps):
        k1 = rhs(A)
        k2 = rhs(A + k1 * (0.5 * dt))
        k3 = rhs(A + k2 * (0.5 * dt))
        k4 = rhs(A + k3 * dt)
        A = A + (k1 + k2 * 2.0 + k3 * 2.0 + k4) * (dt / 6.0)
    return A


def compute_hawkes_a_mgf_grid(ttm: float,
                              phi_grid: torch.Tensor,
                              model_params: HawkesJDParams,
                              psi_grid: Optional[torch.Tensor] = None,
                              a_t0: Optional[torch.Tensor] = None,
                              year_steps: int = 1440
                              ) -> Tuple[torch.Tensor, torch.Tensor]:
    """(A(tau), log MGF = A0 + A1 lambda_p + A2 lambda_m)."""
    a_t1 = solve_a_ode_grid(phi_grid=phi_grid, psi_grid=psi_grid, ttm=ttm,
                            model_params=model_params, a_t0=a_t0, year_steps=year_steps)
    log_mgf = (a_t1[:, 0] + a_t1[:, 1] * float(model_params.lambda_p)
               + a_t1[:, 2] * float(model_params.lambda_m))
    return a_t1, log_mgf


# ----------------------------------------------------------------------------
# chain pricers
# ----------------------------------------------------------------------------

def _ttms_of(grid: ChainGrid) -> List[float]:
    return [float(t) for t in grid.ttms.cpu().numpy()]


def hawkesjd_chain_pricer(grid: ChainGrid,
                          model_params: HawkesJDParams,
                          is_spot_measure: bool = True,
                          vol_scaler: Optional[float] = None,
                          year_steps: int = 1440) -> torch.Tensor:
    """Fourier prices of the padded chain panel on the grid's device; returns
    (n_ttm, max_strikes) float64 prices.  Each slice advances the previous slice's
    Riccati state A by ``ttm_i - ttm_{i-1}``."""
    ttms = _ttms_of(grid)
    if vol_scaler is None:
        vol_scaler = set_vol_scaler(sigma0=model_params.sigma, ttm=np.min(ttms))
    phi_grid, _, _ = mgf.get_transform_var_grid(max_phi=MAX_PHI, vol_scaler=vol_scaler,
                                                device=grid.device)
    a_t = None
    ttm0 = 0.0
    prices = []
    for i, ttm in enumerate(ttms):
        a_t, log_mgf = compute_hawkes_a_mgf_grid(ttm=ttm - ttm0, phi_grid=phi_grid,
                                                 model_params=model_params, a_t0=a_t,
                                                 year_steps=year_steps)
        prices.append(mgf.vanilla_prices_with_mgf_grid(
            log_mgf_grid=log_mgf, phi_grid=phi_grid, forwards=grid.forwards[i],
            strikes=grid.strikes[i], optiontypes=grid.optioncodes[i],
            discfactors=grid.discfactors[i], is_spot_measure=is_spot_measure))
        ttm0 = ttm
    return torch.stack(prices, dim=0)


def hawkesjd_forwards_under_risk_kernel(model_params: HawkesJDParams,
                                        risk_premia_gamma: float,
                                        ttms: np.ndarray,
                                        forwards: np.ndarray,
                                        device="cuda"
                                        ) -> Tuple[np.ndarray, np.ndarray]:
    """normalizers and gamma-forwards from the real MGF at -gamma and
    -gamma - 1, each maturity solved from 0 at 1440 steps/yr.  The two
    points are solved together as one 2-point grid."""
    phi = torch.tensor([-risk_premia_gamma, -risk_premia_gamma - 1.0],
                       dtype=torch.complex128, device=device)
    normalizers, gamma_forwards = np.ones_like(ttms), np.ones_like(ttms)
    for idx, (ttm, forward) in enumerate(zip(ttms, forwards)):
        _, log_mgf = compute_hawkes_a_mgf_grid(ttm=float(ttm), phi_grid=phi,
                                               model_params=model_params)
        lm0, lm1 = log_mgf.real.cpu().numpy()
        normalizer = 1.0 / np.exp(float(lm0))
        gamma_forwards[idx] = forward * np.exp(float(lm1)) * normalizer
        normalizers[idx] = normalizer
    return normalizers, gamma_forwards


def hawkesjd_chain_pricer_with_risk_premia(grid: ChainGrid,
                                           model_params: HawkesJDParams,
                                           is_spot_measure: bool = True,
                                           vol_scaler: Optional[float] = None,
                                           year_steps: int = 1440) -> torch.Tensor:
    """risk-premia-gamma prices of the padded chain panel on the grid's
    device.  The K^(1+gamma) payoff kernel is dimensionally consistent on
    forward-normalised chains only (strikes ~ 1; see
    ``OptionChain.to_forward_normalised_strikes``).  At gamma = 0 it reduces
    to the standard pricer."""
    ttms = _ttms_of(grid)
    if vol_scaler is None:
        vol_scaler = set_vol_scaler(sigma0=model_params.sigma, ttm=np.min(ttms))
    gamma = float(model_params.risk_premia_gamma)
    forwards = grid.forwards.cpu().numpy()
    normalizers, gamma_forwards = hawkesjd_forwards_under_risk_kernel(
        model_params=model_params, risk_premia_gamma=gamma, ttms=np.asarray(ttms),
        forwards=forwards, device=grid.device)
    phi_grid, _, _ = mgf.get_transform_var_grid(max_phi=MAX_PHI, vol_scaler=vol_scaler,
                                                real_phi=-0.5 - gamma, device=grid.device)
    a_t = None
    ttm0 = 0.0
    prices = []
    for i, ttm in enumerate(ttms):
        a_t, log_mgf = compute_hawkes_a_mgf_grid(ttm=ttm - ttm0, phi_grid=phi_grid,
                                                 model_params=model_params, a_t0=a_t,
                                                 year_steps=year_steps)
        prices.append(mgf.slice_pricer_with_mgf_grid_with_gamma(
            log_mgf_grid=log_mgf, phi_grid=phi_grid, risk_premia_gamma=gamma, ttm=ttm,
            forward=float(forwards[i]), normalizer=float(normalizers[i]),
            gamma_forward=float(gamma_forwards[i]), strikes=grid.strikes[i],
            optiontypes=grid.optioncodes[i], is_spot_measure=is_spot_measure))
        ttm0 = ttm
    return torch.stack(prices, dim=0)


# ----------------------------------------------------------------------------
# Monte Carlo with intensity thinning
# ----------------------------------------------------------------------------

def simulate_hawkesjd_terminal(gen: torch.Generator,
                               ttm: float,
                               x0: torch.Tensor,
                               lambda_p0: torch.Tensor,
                               lambda_m0: torch.Tensor,
                               mu: float,
                               sigma: float,
                               shift_p: float,
                               mean_p: float,
                               shift_m: float,
                               mean_m: float,
                               theta_p: float,
                               kappa_p: float,
                               beta1_p: float,
                               beta2_p: float,
                               theta_m: float,
                               kappa_m: float,
                               beta1_m: float,
                               beta2_m: float,
                               nb_steps_per_year: int = MC_STEPS_PER_YEAR
                               ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Euler with thinning to the horizon ``ttm``, one eager step at a time in
    the dtype of ``x0``: a jump fires when lambda > -ln(U)/dt, U clamped at
    1e-16.  Each step draws, from ``gen`` in this order, the normal, the two
    thinning uniforms and the two exponential jump sizes."""
    nb_steps, dt, _ = set_time_grid(ttm=ttm, nb_steps_per_year=nb_steps_per_year)
    sdt = float(np.sqrt(dt))
    nb_path = x0.shape[0]
    compensator_p_dt = dt * (np.exp(shift_p) / (1.0 - mean_p) - 1.0)
    compensator_m_dt = dt * (np.exp(shift_m) / (1.0 - mean_m) - 1.0)
    drift_dt = (mu - 0.5 * sigma * sigma) * dt
    draw = dict(generator=gen, dtype=x0.dtype, device=x0.device)
    thin = lambda: -torch.log(torch.clamp(torch.rand(nb_path, **draw), min=1e-16)) / dt
    expo = lambda: torch.empty(nb_path, dtype=x0.dtype, device=x0.device).exponential_(
        generator=gen)
    x, lam_p, lam_m = x0, lambda_p0, lambda_m0
    for _ in range(nb_steps):
        w0 = torch.randn(nb_path, **draw) * sdt
        u_p, u_m = thin(), thin()
        j_p = shift_p + expo() * mean_p
        j_m = shift_m - expo() * (-mean_m)
        diffusion = drift_dt - compensator_p_dt * lam_p - compensator_m_dt * lam_m + sigma * w0
        jump_p = torch.where(lam_p > u_p, j_p, 0.0)
        jump_m = torch.where(lam_m > u_m, j_m, 0.0)
        x = x + diffusion + jump_p + jump_m
        load_p = beta1_p * jump_p + beta2_p * jump_m
        load_m = beta1_m * jump_p + beta2_m * jump_m
        lam_p = lam_p + kappa_p * (theta_p - lam_p) * dt + load_p
        lam_m = lam_m + kappa_m * (theta_m - lam_m) * dt + load_m
    return x, lam_p, lam_m


def hawkesjd_mc_chain_pricer(ttms: np.ndarray,
                             forwards: np.ndarray,
                             discfactors: np.ndarray,
                             strikes_ttms,
                             optiontypes_ttms,
                             lambda_p: float,
                             lambda_m: float,
                             mu: float,
                             sigma: float,
                             shift_p: float,
                             mean_p: float,
                             shift_m: float,
                             mean_m: float,
                             theta_p: float,
                             kappa_p: float,
                             beta1_p: float,
                             beta2_p: float,
                             theta_m: float,
                             kappa_m: float,
                             beta1_m: float,
                             beta2_m: float,
                             nb_path: int = 100000,
                             variable_type: VariableType = VariableType.LOG_RETURN,
                             seed: Optional[int] = None,
                             engine: str = "scan",
                             device="cuda"
                             ) -> Tuple[List[np.ndarray], List[np.ndarray]]:
    """chain MC with the state (x, lambda_p, lambda_m) carried across
    maturities; returns ragged (prices, stderrs).

    ``engine='cuda'`` (alias ``'pallas'``) runs each slice in float32
    through the hand-written CUDA kernel on a CUDA ``device`` and through its
    plain version on the CPU; slice ``i`` takes the seed ``base + 7919*i``.
    ``engine='scan'`` (default) runs the float64 eager loop with draws from a
    generator seeded by ``seed``.
    """
    if engine == "pallas":
        engine = "cuda"
    if engine not in ("scan", "cuda"):
        raise NotImplementedError(f"engine={engine}")
    device = torch.device(device)
    sim_params = dict(mu=mu, sigma=sigma, shift_p=shift_p, mean_p=mean_p, shift_m=shift_m,
                      mean_m=mean_m, theta_p=theta_p, kappa_p=kappa_p, beta1_p=beta1_p,
                      beta2_p=beta2_p, theta_m=theta_m, kappa_m=kappa_m, beta1_m=beta1_m,
                      beta2_m=beta2_m)
    if engine == "cuda":
        nb_pad, base_seed = engine_setup(seed, nb_path)
        dtype = torch.float32
    else:
        nb_pad, gen = nb_path, generator_from_seed(seed, device=device)
        dtype = torch.float64
    x = torch.zeros(nb_pad, dtype=dtype, device=device)
    lam_p = torch.full((nb_pad,), float(lambda_p), dtype=dtype, device=device)
    lam_m = torch.full((nb_pad,), float(lambda_m), dtype=dtype, device=device)
    ttm0 = 0.0
    option_prices_ttm, option_std_ttm = [], []
    for i, ttm in enumerate(ttms):
        if engine == "cuda":
            x, lam_p, lam_m = simulate_hawkesjd_terminal_kernel(
                seed=base_seed + 7919 * i, x0=x, lambda_p0=lam_p, lambda_m0=lam_m,
                ttm=float(ttm - ttm0), **sim_params)
        else:
            x, lam_p, lam_m = simulate_hawkesjd_terminal(
                gen=gen, ttm=float(ttm - ttm0), x0=x, lambda_p0=lam_p, lambda_m0=lam_m,
                **sim_params)
        ttm0 = float(ttm)
        xp = x[:nb_path]
        prices, stds = compute_mc_vars_payoff(
            x0=xp, sigma0=xp, qvar0=xp, ttm=ttm, forward=forwards[i],
            strikes_ttm=strikes_ttms[i], optiontypes_ttm=optiontypes_ttms[i],
            discfactor=discfactors[i], variable_type=variable_type)
        option_prices_ttm.append(prices)
        option_std_ttm.append(stds)
    return option_prices_ttm, option_std_ttm


# ----------------------------------------------------------------------------
# pricer class
# ----------------------------------------------------------------------------

class HawkesJDPricer(ModelPricer):
    """ModelPricer for the Hawkes jump-diffusion model; tensors live on
    ``device``."""

    def price_chain(self, option_chain: OptionChain, params: HawkesJDParams,
                    is_spot_measure: bool = True,
                    variable_type: VariableType = VariableType.LOG_RETURN,
                    vol_scaler: Optional[float] = None,
                    precision: str = "exact",
                    **kwargs) -> List[np.ndarray]:
        """analytic chain prices in float64; the risk-premia pricer when
        ``params.risk_premia_gamma`` is set.

        ``precision='exact'`` (default) runs the Riccati RK4 at 1440
        steps/yr.  ``'fast'`` (mixed precision in the JAX package, standard
        measure only) runs the same float64 path at 720 steps/yr; with a
        gamma it runs the exact path, as in the JAX package.  ``year_steps=``
        overrides.
        """
        if precision not in _YEAR_STEPS:
            raise NotImplementedError(f"precision={precision}")
        if variable_type != VariableType.LOG_RETURN:
            raise NotImplementedError(f"variable_type={variable_type}")
        gamma = params.risk_premia_gamma
        default_steps = _YEAR_STEPS[precision if gamma is None else "exact"]
        year_steps = kwargs.pop("year_steps", default_steps)
        if vol_scaler is None:
            vol_scaler = set_vol_scaler(sigma0=params.sigma, ttm=np.min(option_chain.ttms))
        grid = option_chain.to_grid(device=self.device)
        price_grid = (hawkesjd_chain_pricer if gamma is None
                      else hawkesjd_chain_pricer_with_risk_premia)
        prices = price_grid(grid, params, is_spot_measure=is_spot_measure,
                            vol_scaler=float(vol_scaler), year_steps=year_steps)
        return option_chain.unpad_panel(prices)

    def compute_chain_prices_with_vols(self, option_chain: OptionChain,
                                       params: HawkesJDParams, **kwargs
                                       ) -> Tuple[List[np.ndarray], List[np.ndarray]]:
        """prices and implied vols; under the risk kernel the vols are
        implied against the gamma-forwards."""
        model_prices = self.price_chain(option_chain=option_chain, params=params, **kwargs)
        model_forwards = None
        if params.risk_premia_gamma is not None:
            _, model_forwards = hawkesjd_forwards_under_risk_kernel(
                model_params=params, risk_premia_gamma=params.risk_premia_gamma,
                ttms=option_chain.ttms, forwards=option_chain.forwards, device=self.device)
        model_ivols = option_chain.compute_model_ivols_from_chain_data(
            model_prices=model_prices, forwards=model_forwards, device=self.device)
        return model_prices, model_ivols

    @timer
    def model_mc_price_chain(self, option_chain: OptionChain, params: HawkesJDParams,
                             nb_path: int = 100000, seed: Optional[int] = None,
                             variable_type: VariableType = VariableType.LOG_RETURN,
                             **kwargs) -> Tuple[List[np.ndarray], List[np.ndarray]]:
        """MC chain prices and standard errors at 1800 steps/yr on the
        pricer's device (``engine='scan'`` or ``'cuda'``/``'pallas'``)."""
        return hawkesjd_mc_chain_pricer(
            ttms=option_chain.ttms, forwards=option_chain.forwards,
            discfactors=option_chain.discfactors, strikes_ttms=option_chain.strikes_ttms,
            optiontypes_ttms=option_chain.optiontypes_ttms, nb_path=nb_path, seed=seed,
            variable_type=variable_type, engine=kwargs.get("engine", "scan"),
            device=self.device, lambda_p=params.lambda_p, lambda_m=params.lambda_m,
            **params.sim_params())

    @timer
    def simulate_terminal_values(self, params: HawkesJDParams, ttm: float = 1.0,
                                 nb_path: int = 100000, seed: Optional[int] = None, **kwargs
                                 ) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
        """terminal (x, lambda_p, lambda_m) of the float64 eager engine, as numpy."""
        f64 = dict(dtype=torch.float64, device=self.device)
        x, lam_p, lam_m = simulate_hawkesjd_terminal(
            gen=generator_from_seed(seed, device=self.device), ttm=ttm,
            x0=torch.zeros(nb_path, **f64),
            lambda_p0=torch.full((nb_path,), float(params.lambda_p), **f64),
            lambda_m0=torch.full((nb_path,), float(params.lambda_m), **f64),
            **params.sim_params())
        return x.cpu().numpy(), lam_p.cpu().numpy(), lam_m.cpu().numpy()

    def calibrate_model_params_to_chain(self, option_chain: OptionChain,
                                        params0: HawkesJDParams, **kwargs) -> HawkesJDParams:
        """the 8-parameter SLSQP and LM fits are not ported yet."""
        raise NotImplementedError("Hawkes JD calibration is not ported yet")

    def calibrate_risk_premia_gamma_to_chain(self, option_chain: OptionChain,
                                             params0: HawkesJDParams,
                                             **kwargs) -> HawkesJDParams:
        """the (sigma, gamma) risk-premia fit is not ported yet."""
        raise NotImplementedError("Hawkes JD risk-premia calibration is not ported yet")
