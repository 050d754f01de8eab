"""
Model-consistent chain greeks by automatic differentiation.

PyTorch counterpart of ``stochvolmodels_tpu/models/greeks.py``.  Every
analytic chain pricer of the port is a differentiable torch program, so the
forward delta and gamma and the parameter sensitivities of the *model* price
come from ``torch.func.jvp``: delta is one jvp against the per-maturity
forwards (row i of the price panel depends on ``forwards[i]`` only, so the
all-ones tangent reads out dP_ij/dF_i), gamma a jvp of that jvp, and each
parameter greek one jvp.  ``in_vols=True`` differentiates the BSM implied
vols of the prices instead (the fast IV with its second-order implicit
derivatives, so gamma in vol space is exact too).  Calendar theta
(``'theta_calendar'``, dP/dt = -dP/dttm) is a central difference in maturity
between two programs at shifted maturities: the maturities fix the step
counts on the host.

Each model wrapper builds one program for the price panel and every greek
panel of a padded :class:`ChainGrid`, cached per (chain shape, maturities,
greek set, solver configuration) in a bounded FIFO cache.  On a card each
program is captured whole as one CUDA graph per cache key (the jvps inside
it), so repricing the same chain with new parameters is one replay.  The
default ``vol_scaler`` comes from the chain's ATM vol, not from the
parameters, so the key does not move with them.

``logsv_mc_chain_greeks`` is the pathwise estimator: the jvp runs through
the float64 eager Euler loop at a fixed seed (every evaluation draws the same
normals), not through the CUDA kernel.  The factor-HJM
``swaption_cube_greeks`` differentiates the swaption cube pricer by one jvp
a greek, on the pricer's frozen panels, each captured as one CUDA graph on a
card.
"""
from __future__ import annotations

import dataclasses
from typing import Callable, Dict, List, Optional, Tuple

import numpy as np
import torch
from torch.func import jvp

from stochvolmodels_torch.data.option_chain import ChainGrid, OptionChain
from stochvolmodels_torch.ops import bsm, graphs

#: greek name -> the model parameter it aliases ('vega' is the vol state)
_LOGSV_VEGA = "sigma0"
_HESTON_VEGA = "v0"
_LOGSV_PARAMS = ("sigma0", "theta", "kappa1", "kappa2", "beta", "volvol")
_HESTON_PARAMS = ("v0", "theta", "kappa", "rho", "volvol")

_PROGRAM_CACHE: Dict[tuple, "_Program"] = {}
_PROGRAM_CACHE_MAX = 64


def _resolve_names(greeks: Tuple[str, ...], vega_param: str,
                   param_names: Tuple[str, ...]) -> List[Tuple[str, str]]:
    """the requested greeks as (output key, target) pairs, the target
    'delta', 'gamma' or a model parameter ('theta_calendar' is handled by
    the callers, never resolved here)."""
    out = []
    for g in greeks:
        target = vega_param if g == "vega" else g
        if target not in ("delta", "gamma") and target not in param_names:
            raise ValueError(f"unknown greek {g!r}; expected 'delta', 'gamma', "
                             f"'vega' or one of {param_names}")
        out.append((g, target))
    return out


def _theta_dt(ttms) -> float:
    """the step of calendar theta: one day, capped so that ttm - dt stays positive."""
    return float(min(1.0 / 365.0, 0.25 * float(np.min(ttms))))


def _chain_atm0(option_chain: OptionChain, fallback: float) -> float:
    """the chain's first-maturity ATM vol, or ``fallback`` where the chain
    carries no usable vols: the default vol scaler, so that the program's
    cache key does not move with the parameters being differentiated."""
    try:
        atm0 = float(option_chain.get_chain_atm_vols()[0])
    except (ValueError, TypeError, AttributeError, IndexError, KeyError):
        atm0 = float("nan")
    if not np.isfinite(atm0) or atm0 <= 0.0:
        atm0 = float(fallback)
    return atm0


def _invert_to_ivols(grid: ChainGrid, prices: torch.Tensor) -> torch.Tensor:
    """the fast IV of a price panel, with derivatives of both orders."""
    return bsm.infer_bsm_implied_vol_fast(
        forward=grid.forwards[:, None], ttm=grid.ttms[:, None], strike=grid.strikes,
        given_price=prices, discfactor=grid.discfactors[:, None],
        optiontype=grid.optioncodes, higher_order=True)


class _Program:
    """the price panel and every requested greek panel of ``price_fn``.

    ``price_fn(grid, params) -> (n_ttm, max_strikes)`` is a torch function of
    the grid's tensors and the 0-dim parameters, with no read back to the
    host, so that the whole program captures as one graph.
    """

    def __init__(self, price_fn: Callable, names: List[Tuple[str, str]],
                 param_keys: Tuple[str, ...], in_vols: bool):
        self.price_fn = price_fn
        self.targets = list(dict.fromkeys(t for _, t in names))
        self.param_keys = param_keys
        self.in_vols = in_vols
        self.out_keys = ["price"] + (["ivol"] if in_vols else []) + self.targets

    def panels(self, grid: ChainGrid, pvec: torch.Tensor) -> Dict[str, torch.Tensor]:
        params = dict(zip(self.param_keys, pvec.unbind()))

        def target_of(g, p):
            prices = self.price_fn(g, p)
            return _invert_to_ivols(g, prices) if self.in_vols else prices

        def f_of_forwards(fwds):
            return target_of(dataclasses.replace(grid, forwards=fwds), params)

        ones = torch.ones_like(grid.forwards)
        out: Dict[str, torch.Tensor] = {}
        base = None
        if "delta" in self.targets or "gamma" in self.targets:
            base, delta = jvp(f_of_forwards, (grid.forwards,), (ones,))
            if "delta" in self.targets:
                out["delta"] = delta
            if "gamma" in self.targets:
                def dfn(fwds):
                    return jvp(f_of_forwards, (fwds,), (torch.ones_like(fwds),))[1]
                out["gamma"] = jvp(dfn, (grid.forwards,), (ones,))[1]
        for target in self.targets:
            if target in ("delta", "gamma"):
                continue

            def f_of_param(v, target=target):
                return target_of(grid, {**params, target: v})
            base_p, out[target] = jvp(f_of_param, (params[target],),
                                      (torch.ones_like(params[target]),))
            if base is None:
                base = base_p
        if self.in_vols:
            prices = self.price_fn(grid, params)
            out["price"] = prices
            out["ivol"] = base if base is not None else _invert_to_ivols(grid, prices)
        else:
            out["price"] = base if base is not None else self.price_fn(grid, params)
        return out

    def __call__(self, key: tuple, grid: ChainGrid, pvec: torch.Tensor
                 ) -> Dict[str, torch.Tensor]:
        """the panels, through one CUDA graph per ``key`` on a card."""
        inputs = (grid.ttms, grid.forwards, grid.discfactors, grid.strikes,
                  grid.optioncodes, grid.mask, pvec)

        def fn(*t):
            panels = self.panels(ChainGrid(*t[:6]), t[6])
            return tuple(panels[k] for k in self.out_keys)
        if graphs.use_graph(pvec):
            outs = graphs.run_captured("greeks", key + (str(pvec.device),), fn, inputs)
        else:
            outs = fn(*inputs)
        return dict(zip(self.out_keys, outs))


def _unpad(panel: torch.Tensor, grid: ChainGrid) -> List[np.ndarray]:
    mask = grid.mask.cpu().numpy()
    p = panel.detach().cpu().numpy()
    return [p[i, mask[i]] for i in range(p.shape[0])]


def _run(cache_key: tuple, price_fn, names, grid: ChainGrid,
         params: Dict[str, float], greeks: Tuple[str, ...],
         in_vols: bool = False) -> Dict[str, List[np.ndarray]]:
    """the program of ``cache_key`` (built at its first use, FIFO-evicted
    past 64) on the grid and the parameters; ragged numpy panels."""
    cache_key = cache_key + (in_vols,)
    program = _PROGRAM_CACHE.get(cache_key)
    if program is None:
        program = _Program(price_fn, names, tuple(params), in_vols)
        while len(_PROGRAM_CACHE) >= _PROGRAM_CACHE_MAX:
            _PROGRAM_CACHE.pop(next(iter(_PROGRAM_CACHE)))
        _PROGRAM_CACHE[cache_key] = program
    pvec = torch.tensor([float(v) for v in params.values()], dtype=torch.float64,
                        device=grid.device)
    panels = program(cache_key, grid, pvec)
    out = {"price": _unpad(panels["price"], grid)}
    if in_vols:
        out["ivol"] = _unpad(panels["ivol"], grid)
    for g, target in names:
        out[g] = _unpad(panels[target], grid)
    return out


def _calendar_theta(make_price_fn, key_prefix: tuple, option_chain: OptionChain,
                    grid: ChainGrid, values: Dict[str, float],
                    ttms_static: Tuple[float, ...], in_vols: bool) -> List[np.ndarray]:
    """calendar theta dP/dt (= -dP/dttm) by a central difference in maturity
    between two cached price-only programs.

    Forwards are held fixed and the discount factors re-expressed at fixed
    continuous rates, df(ttm +- dt) = exp(-r (ttm +- dt)) with r = -ln(df)/ttm,
    so the carry part of theta is the model's own discounting.
    """
    dt = _theta_dt(np.asarray(ttms_static))
    rates = -np.log(option_chain.discfactors) / option_chain.ttms
    sides = []
    for sign in (1.0, -1.0):
        ttms_s = tuple(float(t) + sign * dt for t in ttms_static)
        g = dataclasses.replace(
            grid,
            ttms=torch.as_tensor(np.asarray(ttms_s), dtype=torch.float64, device=grid.device),
            discfactors=torch.as_tensor(np.exp(-rates * np.asarray(ttms_s)),
                                        dtype=torch.float64, device=grid.device))
        out = _run(key_prefix + (ttms_s,), make_price_fn(ttms_s), [], g, values, (),
                   in_vols=in_vols)
        sides.append(out["ivol" if in_vols else "price"])
    return [np.asarray(-(up - dn) / (2.0 * dt)) for up, dn in zip(sides[0], sides[1])]


def logsv_chain_greeks(option_chain: OptionChain,
                       params,
                       greeks: Tuple[str, ...] = ("delta", "gamma", "vega"),
                       vol_scaler: Optional[float] = None,
                       is_spot_measure: bool = True,
                       expansion_order=None,
                       year_steps: int = 240,
                       in_vols: bool = False,
                       device="cuda",
                       ) -> Dict[str, List[np.ndarray]]:
    """model-consistent greeks of the LogSV analytic chain prices.

    ``greeks`` may hold ``'delta'`` (dP/dF per maturity), ``'gamma'``
    (d2P/dF2), ``'vega'`` (alias of ``sigma0``), any of the parameter names
    ``sigma0/theta/kappa1/kappa2/beta/volvol`` and ``'theta_calendar'`` (the
    calendar decay dP/dt; the vol backbone's etas stay at the unshifted
    maturities).  Returns ``{'price': [...], greek: [...]}``, per-maturity
    arrays over the chain's ragged strikes, all from one program on
    ``device``.  ``in_vols=True`` expresses every greek in BSM implied vol
    (adds an ``'ivol'`` panel): delta becomes dIV/dF, the model's smile
    dynamics, and gamma the second total derivative.
    """
    from stochvolmodels_torch.models.logsv import affine as afe
    from stochvolmodels_torch.models.logsv.pricer import logsv_chain_price_grid, set_vol_scaler

    if expansion_order is None:
        expansion_order = afe.ExpansionOrder.SECOND
    if vol_scaler is None:
        vol_scaler = set_vol_scaler(sigma0=_chain_atm0(option_chain, fallback=params.sigma0),
                                    ttm=np.min(option_chain.ttms))
    grid = option_chain.to_grid(device=device)
    ttms_static = tuple(float(t) for t in option_chain.ttms)
    etas = tuple(float(e) for e in params.get_vol_backbone_etas(ttms=option_chain.ttms))
    greeks = tuple(greeks)
    want_theta = "theta_calendar" in greeks
    rest = tuple(g for g in greeks if g != "theta_calendar")
    names = _resolve_names(rest, _LOGSV_VEGA, _LOGSV_PARAMS)
    need = tuple(sorted({t for _, t in names}))

    def make_price_fn(tts: Tuple[float, ...]):
        def price_fn(g: ChainGrid, p: Dict[str, torch.Tensor]) -> torch.Tensor:
            return logsv_chain_price_grid(
                g, sigma0=p["sigma0"], theta=p["theta"], kappa1=p["kappa1"],
                kappa2=p["kappa2"], beta=p["beta"], volvol=p["volvol"],
                vol_backbone_etas=np.asarray(etas), vol_scaler=float(vol_scaler),
                ttms_static=tts, is_spot_measure=is_spot_measure,
                expansion_order=expansion_order, year_steps=year_steps)
        return price_fn

    key = ("logsv", ttms_static, grid.max_strikes, need, float(vol_scaler), is_spot_measure,
           expansion_order, year_steps, etas)
    values = {k: getattr(params, k) for k in _LOGSV_PARAMS}
    out = _run(key, make_price_fn(ttms_static), names, grid, values, rest, in_vols=in_vols)
    if want_theta:
        key_theta = ("logsv-theta", grid.max_strikes, float(vol_scaler), is_spot_measure,
                     expansion_order, year_steps, etas)
        out["theta_calendar"] = _calendar_theta(make_price_fn, key_theta, option_chain, grid,
                                                values, ttms_static, in_vols)
    return out


def logsv_mc_chain_greeks(option_chain: OptionChain,
                          params,
                          greeks: Tuple[str, ...] = ("delta", "vega"),
                          nb_path: int = 100000,
                          nb_steps_per_year: int = 360,
                          seed=None,
                          is_spot_measure: bool = True,
                          dtype: torch.dtype = torch.float64,
                          device="cuda",
                          ) -> Dict[str, List[np.ndarray]]:
    """pathwise Monte-Carlo greeks by forward-mode AD through the LogSV Euler
    loop.

    The whole chain MC (the normals of a generator seeded with ``seed``, the
    Euler steps, the terminal state carried across maturities, the forward
    recentring, payoff and discounting) is one differentiable program, so a
    jvp at a fixed seed gives the pathwise estimator of dPrice/dF and
    dPrice/dparam; a central difference at the same seed agrees to o(eps).
    Valid greeks: ``'delta'`` and any of ``sigma0/theta/kappa1/kappa2/beta/
    volvol`` (``'vega'`` = sigma0).  ``'gamma'`` is rejected: the pathwise
    estimator of a kinked payoff's second derivative is biased.  Runs
    eagerly in ``dtype`` on ``device`` (``nb_path`` paths held in memory).
    """
    from stochvolmodels_torch.models.logsv.pricer import simulate_logsv_terminal
    from stochvolmodels_torch.ops.payoffs import mc_vars_payoff
    from stochvolmodels_torch.ops.random import generator_from_seed

    if "gamma" in greeks:
        raise ValueError("pathwise MC gamma is biased for kinked payoffs; "
                         "use logsv_chain_greeks for gamma")
    names = _resolve_names(tuple(greeks), _LOGSV_VEGA, _LOGSV_PARAMS)
    grid = option_chain.to_grid(device=device)
    ttms_static = tuple(float(t) for t in option_chain.ttms)
    etas = tuple(float(e) for e in params.get_vol_backbone_etas(ttms=option_chain.ttms))

    def price_fn(g: ChainGrid, p: Dict[str, torch.Tensor]) -> torch.Tensor:
        gen = generator_from_seed(seed, device=g.device)
        x = torch.zeros(nb_path, dtype=dtype, device=g.device)
        sigma = torch.ones(nb_path, dtype=dtype, device=g.device) * p["sigma0"]
        qvar = torch.zeros_like(x)
        ttm0 = 0.0
        rows = []
        for i, ttm in enumerate(ttms_static):
            x, sigma, qvar = simulate_logsv_terminal(
                gen=gen, x0=x, sigma0=sigma, qvar0=qvar, ttm=ttm - ttm0, theta=p["theta"],
                kappa1=p["kappa1"], kappa2=p["kappa2"], beta=p["beta"], volvol=p["volvol"],
                vol_backbone_eta=etas[i], is_spot_measure=is_spot_measure,
                nb_steps_per_year=nb_steps_per_year)
            ttm0 = ttm
            prices, _ = mc_vars_payoff(x, qvar, ttm, g.forwards[i], g.strikes[i],
                                       g.optioncodes[i], discfactor=g.discfactors[i])
            rows.append(prices)
        return torch.stack(rows, dim=0)

    cache_key = ("logsv_mc", ttms_static, grid.max_strikes,
                 tuple(sorted({t for _, t in names})), nb_path, nb_steps_per_year, str(seed),
                 is_spot_measure, str(dtype), etas)
    values = {k: getattr(params, k) for k in _LOGSV_PARAMS}
    with graphs.eager():
        return _run(cache_key, price_fn, names, grid, values, tuple(greeks))


def heston_chain_greeks(option_chain: OptionChain,
                        params,
                        greeks: Tuple[str, ...] = ("delta", "gamma", "vega"),
                        vol_scaler: Optional[float] = None,
                        is_spot_measure: bool = True,
                        in_vols: bool = False,
                        device="cuda",
                        ) -> Dict[str, List[np.ndarray]]:
    """model-consistent greeks of the Heston analytic chain prices.

    ``'vega'`` aliases ``v0`` (dP/dv0, variance units); the other parameter
    names are ``v0/theta/kappa/rho/volvol``; ``'theta_calendar'`` and
    ``in_vols`` as in :func:`logsv_chain_greeks`.
    """
    from stochvolmodels_torch.models.heston import heston_chain_price_grid

    if vol_scaler is None:
        atm0 = _chain_atm0(option_chain, fallback=np.sqrt(params.v0))
        vol_scaler = float(np.minimum(0.3, atm0 * np.sqrt(float(np.min(option_chain.ttms)))))
    grid = option_chain.to_grid(device=device)
    ttms_static = tuple(float(t) for t in option_chain.ttms)
    greeks = tuple(greeks)
    want_theta = "theta_calendar" in greeks
    rest = tuple(g for g in greeks if g != "theta_calendar")
    names = _resolve_names(rest, _HESTON_VEGA, _HESTON_PARAMS)
    need = tuple(sorted({t for _, t in names}))

    def make_price_fn(tts: Tuple[float, ...]):
        def price_fn(g: ChainGrid, p: Dict[str, torch.Tensor]) -> torch.Tensor:
            return heston_chain_price_grid(
                g, v0=p["v0"], theta=p["theta"], kappa=p["kappa"], volvol=p["volvol"],
                rho=p["rho"], vol_scaler=float(vol_scaler), is_spot_measure=is_spot_measure,
                ttms_static=tts)
        return price_fn

    key = ("heston", ttms_static, grid.max_strikes, need, float(vol_scaler), is_spot_measure)
    values = {k: getattr(params, k) for k in _HESTON_PARAMS}
    out = _run(key, make_price_fn(ttms_static), names, grid, values, rest, in_vols=in_vols)
    if want_theta:
        key_theta = ("heston-theta", grid.max_strikes, float(vol_scaler), is_spot_measure)
        out["theta_calendar"] = _calendar_theta(make_price_fn, key_theta, option_chain, grid,
                                                values, ttms_static, in_vols)
    return out


#: the cube greeks: the argument of the cube pricer (sigma0, beta_xs,
#: volvol_xs) that each one bumps by +1 throughout
_CUBE_GREEKS = {"vega": 0, "beta_shift": 1, "volvol_shift": 2}
#: the same for the traced cube (sigma0, A_xs, beta_xs, volvol_xs, kappa1,
#: kappa2), which has three greeks more
_CUBE_GREEKS_TRACED = {"vega": 0, "A_shift": 1, "beta_shift": 2, "volvol_shift": 3,
                       "kappa1": 4, "kappa2": 5}


def _cube_greek_panels(greek: str, *inputs, traced: bool = False):
    """(price, d price) of the cube's ``_cube_price`` (or, ``traced``, its
    ``_traced_cube_price``) along ``greek``'s tangent: ones on the bumped
    argument, zeros on the others."""
    from stochvolmodels_torch.models.factor_hjm.rate_logsv_pricer import (
        _cube_price,
        _traced_cube_price,
    )

    nb_args, which = ((6, _CUBE_GREEKS_TRACED[greek]) if traced else (3, _CUBE_GREEKS[greek]))
    price_fn = _traced_cube_price if traced else _cube_price
    primals, consts = inputs[:nb_args], inputs[nb_args:]
    tangents = tuple(torch.ones_like(x) if i == which else torch.zeros_like(x)
                     for i, x in enumerate(primals))
    price, sens = jvp(lambda *args: price_fn(*args, *consts)[0], primals, tangents)
    return price, sens


def swaption_cube_greeks(params,
                         slices,
                         forwards,
                         strikes_slices,
                         greeks: Tuple[str, ...] = ("vega", "beta_shift", "volvol_shift"),
                         traced: bool = False,
                         device="cuda",
                         **cube_kwargs):
    """model-consistent swaption-cube sensitivities of the factor-HJM rate
    LogSV model, by ``torch.func.jvp`` over the cube pricer
    (``factor_hjm.rate_logsv_pricer.make_swaption_cube_fn``).

    Greeks:

    - ``'vega'``          dP/d(sigma0), the volatility-state vega;
    - ``'beta_shift'``    dP/d(parallel shift of the skew term structure
                          beta(t), all segments and factors bumped +1
                          together);
    - ``'volvol_shift'``  dP/d(parallel shift of volvol(t)).

    Returns ``(panels, mask)``: ``panels['price']`` and one (P, K_max) panel
    per greek (annuity-normalized price units, as the cube pricer's), numpy,
    and ``mask`` the strike-validity panel.  Every greek runs on the same
    frozen structural panels as the pricer; on a card each is one captured
    CUDA graph (``"rates_cube_greeks"``, keyed by the cube's shapes and the
    greek), so a warm reprice costs one replay a greek.

    ``traced=True`` goes through ``make_swaption_cube_fn_traced`` instead:
    the structural panels (mean-state ODE, swap gradient, annuity
    log-derivative, factor vols C) are inside the jvp, so every greek is
    exact through the structure, and three more greeks are available:

    - ``'A_shift'``      dP/d(parallel shift of the factor-vol levels A);
    - ``'kappa1'``       dP/d(kappa1);
    - ``'kappa2'``       dP/d(kappa2).

    Each is one graph on a card (``"rates_cube_greeks_traced"``).
    """
    from stochvolmodels_torch.models.factor_hjm.rate_logsv_pricer import (
        make_swaption_cube_fn,
        make_swaption_cube_fn_traced,
    )
    allowed = tuple(_CUBE_GREEKS_TRACED if traced else _CUBE_GREEKS)
    for g in greeks:
        if g not in allowed:
            raise ValueError(
                f"unknown greek {g!r}; expected one of {allowed}"
                + (" (A_shift/kappa1/kappa2 need traced=True)"
                   if g in _CUBE_GREEKS_TRACED and not traced else ""))
    build = make_swaption_cube_fn_traced if traced else make_swaption_cube_fn
    cube, mask = build(params, slices, forwards, strikes_slices, device=device, **cube_kwargs)
    inputs = cube.primals() + cube.consts
    name = "rates_cube_greeks_traced" if traced else "rates_cube_greeks"
    panels: Dict[str, np.ndarray] = {}
    for g in greeks:
        fn = lambda *t, g=g: _cube_greek_panels(g, *t, traced=traced)
        if graphs.use_graph(inputs[0]):
            price, sens = graphs.run_captured(name, cube.key + (g,), fn, inputs)
        else:
            price, sens = fn(*inputs)
        panels.setdefault("price", price.detach().cpu().numpy())
        panels[g] = sens.detach().cpu().numpy()
    if "price" not in panels:
        panels["price"] = cube(*inputs[:6 if traced else 3]).cpu().numpy()
    return panels, mask.cpu().numpy()
