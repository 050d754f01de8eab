"""
On-device Levenberg-Marquardt calibration of the multi-factor rate LogSV
term structure.

PyTorch counterpart of ``stochvolmodels_tpu/models/factor_hjm/fast_calibration.py``:

* :func:`calibrate_rate_logsv_lm_on_device`: the per-expiry LM of one
  segment ``[beta_idx (d,), volvol_idx]`` over the smiles of every tenor at
  that expiry, on the frozen-panel slice pricers (360 RK4 steps/yr);
* :func:`calibrate_rate_logsv_term_structure`: the left-to-right bootstrap
  of those fits along the term structure;
* :func:`calibrate_rate_logsv_cube_lm_on_device`: the joint LM over a whole
  swaption cube, on the frozen cube or (``fit_A=True``) on the traced cube
  with the factor-vol levels A free;
* :func:`prefit_A_to_atm`: the fix-point prefit of A to the ATM normal vols
  (traced cube, one program for every outer iteration; or the frozen cube
  re-frozen each iteration);
* :func:`calibrate_rate_logsv_full`: prefit and cube LM in alternation.

The residuals are weighted normal-vol errors by the fast implied normal vol
(a NaN model vol counts as the market's).  Each LM iteration takes the
residuals and their Jacobian in one ``torch.func.jacfwd`` pass over the
cube and its inversion (``ops/lm.py``).  On a CUDA device the initial state
is one captured graph and the iteration another, replayed ``nb_iters``
times (names ``"rates_lm_init"`` and ``"rates_lm_step"``, keyed by the
cube's shapes, the free vector and the fit's kind): a whole 24-iteration fit
would be ~10^6 kernel nodes, over three times the LogSV fit's.  Every input
of a graph is a tensor argument, so fits of one shape share their graphs.

With ``mesh=`` the cube LM splits the slice axis over the mesh's devices
(:class:`~stochvolmodels_torch.models.factor_hjm.rate_logsv_pricer.ShardedSwaptionCube`):
each device evaluates the residuals and Jacobian rows of its slices through
its own graphs (``"rates_lm_jac"``, ``"rates_lm_res"``), the rows are
gathered on the first device, where the damped step is solved
(``lm_propose``, ``lm_accept``), and the candidate goes back to every device
for its residuals.
"""
from __future__ import annotations

import copy
from typing import List, Optional, Sequence, Tuple

import numpy as np
import torch

from stochvolmodels_torch.models.factor_hjm.rate_logsv_params import MultiFactRateLogSvParams
from stochvolmodels_torch.models.factor_hjm.rate_logsv_pricer import (
    ShardedSwaptionCube,
    SwaptionCubeFn,
    _cube_price,
    _traced_cube_price,
    make_swaption_cube_fn,
    make_swaption_cube_fn_traced,
)
from stochvolmodels_torch.models.logsv.affine import ExpansionOrder
from stochvolmodels_torch.ops import graphs
from stochvolmodels_torch.ops.bachelier import (
    infer_normal_implied_vol,
    infer_normal_implied_vol_fast,
)
from stochvolmodels_torch.ops.lm import (
    lm_accept,
    lm_init,
    lm_propose,
    lm_step,
    residuals_and_jacobian,
)
from stochvolmodels_torch.parallel.mesh import gather, on_device
from stochvolmodels_torch.utils.rate_core import generate_ttms_grid

# the number of leading problem tensors before the cube's constants
_NB_PROBLEM = 16


def _residuals_fn(fit_A: bool, nb_free: int, d: int, problem):
    """the LM residual function of the free vector ``[beta (nb_free, d),
    volvol (nb_free,)[, A (nb_free, d)]]``: the free segments are placed into
    the term structures by a one-hot (n_seg, nb_free) matrix (exact), the
    cube reprices, the fast implied normal vols invert, and the weighted
    errors at the entries ``take`` form the vector."""
    (beta0, volvol0, A0, sigma0, kappa1, kappa2, rows, free_rows, market, weights, fwd,
     strike, ttm, disc, codes, take) = problem[:_NB_PROBLEM]
    consts = problem[_NB_PROBLEM:]
    nb_beta = nb_free * d

    def place(full, free):
        return torch.where(free_rows.reshape((-1,) + (1,) * (full.ndim - 1)), rows @ free, full)

    def residuals(pars):
        beta_xs = place(beta0, pars[:nb_beta].reshape(nb_free, d))
        volvol_xs = place(volvol0, pars[nb_beta:nb_beta + nb_free])
        if fit_A:
            A_xs = place(A0, pars[nb_beta + nb_free:].reshape(nb_free, d))
            prices = _traced_cube_price(sigma0, A_xs, beta_xs, volvol_xs, kappa1, kappa2,
                                        *consts)[0]
        else:
            prices = _cube_price(sigma0, beta_xs, volvol_xs, *consts)[0]
        ivols = infer_normal_implied_vol_fast(forward=fwd, ttm=ttm, strike=strike,
                                              given_price=prices, discfactor=disc,
                                              optiontype=codes)
        clean = torch.where(torch.isnan(ivols), market, ivols)
        return (weights * (clean - market)).reshape(-1).index_select(0, take)

    return residuals


def _lm_run(p0, lower, upper, problem, nb_iters: int, fit_A: bool, nb_free: int, d: int,
            key) -> Tuple[torch.Tensor, ...]:
    """``nb_iters`` LM iterations from ``p0``: the final state (pars, lam,
    best_pars, best_cost).  On a card the initial state and the iteration
    are each one captured graph, the iteration's replayed per iteration."""
    init = lambda p, *prob: lm_init(_residuals_fn(fit_A, nb_free, d, prob), p)
    step = lambda pars, lam, best, cost, lo, up, *prob: lm_step(
        _residuals_fn(fit_A, nb_free, d, prob), (pars, lam, best, cost), lo, up)
    if graphs.use_graph(p0):
        key = (fit_A, nb_free, d) + tuple(key)
        state = graphs.run_captured("rates_lm_init", key, init, (p0,) + problem)
        for _ in range(nb_iters):
            state = graphs.run_captured("rates_lm_step", key, step,
                                        state + (lower, upper) + problem)
        return state
    state = init(p0, *problem)
    for _ in range(nb_iters):
        state = step(*state, lower, upper, *problem)
    return state


def _lm_run_sharded(p0, lower, upper, problems, keys, nb_iters: int, fit_A: bool,
                    nb_free: int, d: int) -> Tuple[torch.Tensor, ...]:
    """:func:`_lm_run` with the residuals split over devices: ``problems[i]``
    holds device i's slices.  Each evaluation runs every part on its device
    (one graph each on a card) before gathering the rows on ``p0``'s
    device, where the LM state lives and the step is solved."""
    first = p0.device
    jac = lambda pars, *prob: residuals_and_jacobian(_residuals_fn(fit_A, nb_free, d, prob), pars)
    res = lambda pars, *prob: (_residuals_fn(fit_A, nb_free, d, prob)(pars),)

    def on_parts(name, fn, pars):
        outs = []
        for prob, key in zip(problems, keys):
            dev = prob[0].device
            with on_device(dev):
                inputs = (pars.to(dev),) + prob
                outs.append(graphs.run_captured(name, key, fn, inputs)
                            if graphs.use_graph(inputs[0]) else fn(*inputs))
        return [gather([o[k] for o in outs], first) for k in range(len(outs[0]))]

    def cost_at(pars):
        return torch.sum(torch.square(on_parts("rates_lm_res", res, pars)[0]))

    lam = torch.full((), 1e-2, dtype=p0.dtype, device=first)
    state = (p0, lam, p0, cost_at(p0))
    for _ in range(nb_iters):
        J, r = on_parts("rates_lm_jac", jac, state[0])
        cost, cand = lm_propose(state, J, r, lower, upper)
        state = lm_accept(state, cost, cand, cost_at(cand))
    return state


def _quote_panels(cube, forwards, strikes_slices, market_ivols_slices, ttms,
                  weights_slices=None) -> Tuple[np.ndarray, ...]:
    """(market, weights, forward, strike, ttm) (P, K_max) panels of the
    cube's quotes; padded entries have weight 0 and the JAX package's
    priceable dummy (forward 0, strike 0, ttm 1), so no NaN circulates."""
    mask = cube.mask.cpu().numpy()
    P, K_max = mask.shape
    market, weights = np.zeros((P, K_max)), np.zeros((P, K_max))
    fwd, strike, ttm = np.zeros((P, K_max)), np.zeros((P, K_max)), np.zeros((P, K_max))
    for p, (iv, strikes, f) in enumerate(zip(market_ivols_slices, strikes_slices, forwards)):
        k = len(strikes)
        market[p, :k] = np.asarray(iv, dtype=float)
        weights[p, :k] = 1.0 if weights_slices is None else np.asarray(weights_slices[p], float)
        fwd[p, :k] = float(f)
        strike[p, :k] = np.asarray(strikes, dtype=float)
        ttm[p, :k] = float(ttms[p])
    weights = np.where(mask, weights, 0.0)
    ttm = np.where(ttm > 0.0, ttm, 1.0)
    return market, weights, fwd, strike, ttm


def _fit_segments(params: MultiFactRateLogSvParams, cube, fit_A: bool, segments: Sequence[int],
                  quotes, take: np.ndarray, nb_iters: int, beta_bound: float,
                  volvol_bounds: Tuple[float, float], A_bounds: Tuple[float, float]
                  ) -> Tuple[MultiFactRateLogSvParams, float]:
    """LM over the free segments ``segments`` of the (beta, volvol[, A])
    term structures through ``cube``; a copy of ``params`` with the best
    point written in, and the best cost."""
    device = cube.device
    f64 = lambda a: torch.as_tensor(np.asarray(a, dtype=np.float64), device=device)
    d = params.basis.get_nb_factors()
    n_seg = params.beta.xs.shape[0]
    segments = [int(s) for s in segments]
    assert len(set(segments)) == len(segments), f"segments repeat: {segments}"
    nb_free = len(segments)
    rows = np.zeros((n_seg, nb_free))
    rows[segments, np.arange(nb_free)] = 1.0
    beta0 = np.asarray(params.beta.xs, dtype=float)
    volvol0 = np.asarray(params.volvol.xs, dtype=float)
    A0 = np.asarray(params.A, dtype=float)
    market, weights, fwd, strike, ttm = quotes
    problem = (f64(beta0), f64(volvol0), f64(A0), f64(params.sigma0), f64(params.kappa1),
               f64(params.kappa2), f64(rows), torch.as_tensor(rows.any(axis=1), device=device),
               f64(market), f64(weights), f64(fwd), f64(strike), f64(ttm),
               f64(np.ones_like(market)),
               torch.ones(market.shape, dtype=torch.int8, device=device),   # calls
               torch.as_tensor(take, dtype=torch.int64, device=device))
    p0 = [beta0[segments].ravel(), volvol0[segments]]
    lower = [np.full(nb_free * d, -beta_bound), np.full(nb_free, volvol_bounds[0])]
    upper = [np.full(nb_free * d, beta_bound), np.full(nb_free, volvol_bounds[1])]
    if fit_A:
        p0.append(A0[segments].ravel())
        lower.append(np.full(nb_free * d, A_bounds[0]))
        upper.append(np.full(nb_free * d, A_bounds[1]))
    p0, lower, upper = (f64(np.concatenate(v)) for v in (p0, lower, upper))
    if isinstance(cube, ShardedSwaptionCube):
        # every quote of the cube, in order: each part takes its slices' rows
        assert np.array_equal(take, np.arange(market.size)), "a sharded fit takes every quote"
        K_max = market.shape[1]
        problems, keys = [], []
        for (start, stop), part in zip(cube.bounds, cube.parts):
            dev = part.device
            panels = tuple(t[start:stop].to(dev) for t in problem[8:15])
            take_part = torch.arange((stop - start) * K_max, device=dev)
            problems.append(tuple(t.to(dev) for t in problem[:8]) + panels + (take_part,)
                            + part.consts)
            keys.append((fit_A, nb_free, d) + part.key + (take_part.numel(),))
        state = _lm_run_sharded(p0, lower, upper, problems, keys, nb_iters, fit_A, nb_free, d)
    else:
        state = _lm_run(p0, lower, upper, problem + cube.consts, nb_iters, fit_A, nb_free, d,
                        cube.key + (take.size,))
    best = state[2].cpu().numpy()
    fitted = copy.deepcopy(params)
    for j, seg in enumerate(segments):
        fitted.update_params(
            idx=seg, beta_idx=best[j * d:(j + 1) * d], volvol_idx=float(best[nb_free * d + j]),
            A_idx=(best[nb_free * (d + 1) + j * d:nb_free * (d + 1) + (j + 1) * d]
                   if fit_A else None))
    return fitted, float(state[3])


def calibrate_rate_logsv_lm_on_device(
        params: MultiFactRateLogSvParams,
        t_grid: np.ndarray,
        expiry: float,
        idx: int,
        tenors: Sequence[float],
        forwards: Sequence[float],
        strikes_tenors: Sequence[np.ndarray],
        market_ivols_tenors: Sequence[np.ndarray],
        weights_tenors: Optional[Sequence[np.ndarray]] = None,
        nb_iters: int = 24,
        beta_bound: float = 2.0,
        volvol_bounds: Tuple[float, float] = (0.01, 2.0),
        x0: Optional[np.ndarray] = None,
        y0: Optional[np.ndarray] = None,
        device="cuda",
) -> Tuple[MultiFactRateLogSvParams, float]:
    """fit ``(beta.xs[idx], volvol.xs[idx])`` to the smiles at one expiry.

    ``strikes_tenors[i]`` and ``market_ivols_tenors[i]`` are the strike grid
    and market normal ivols of tenor ``tenors[i]`` at ``expiry``; the
    residual vector stacks all tenors (flat weights unless
    ``weights_tenors``).  Each tenor prices on its frozen slice panels on
    ``t_grid`` at max(ceil(360 expiry), 16) RK4 steps, as
    ``make_swaption_slice_fn``; the tenors go through one batched cube.
    Segments before ``idx`` are held (bootstrap), later ones are inactive.
    Returns ``(updated params copy, best cost)``.
    """
    panels = []
    for tenor in tenors:
        t_grid_cut, _, idx_t, swap_gr, loga_der, C_panel = params.qa_structural_panels(
            expiry=float(expiry), tenor=float(tenor), t_grid=t_grid, x0=x0, y0=y0)
        panels.append((float(expiry), np.asarray(t_grid_cut, dtype=float), idx_t, swap_gr,
                       loga_der, C_panel))
    nb_steps = max(int(np.ceil(360 * float(expiry))), 16)
    strikes_tenors = [np.asarray(s, dtype=float) for s in strikes_tenors]
    cube = SwaptionCubeFn(params, panels, strikes_tenors, [float(f) for f in forwards],
                          nb_steps, ExpansionOrder.FIRST, 0.125, 2.75, device)
    quotes = _quote_panels(cube, forwards, strikes_tenors, market_ivols_tenors,
                           [float(expiry)] * len(tenors), weights_tenors)
    take = np.flatnonzero(cube.mask.cpu().numpy())      # the tenors' quotes, in order
    return _fit_segments(params, cube, False, [idx], quotes, take, nb_iters, beta_bound,
                         volvol_bounds, (0.0, 0.0))


def calibrate_rate_logsv_term_structure(
        params0: MultiFactRateLogSvParams,
        expiries: Sequence[float],
        tenors: Sequence[float],
        forwards_expiries: Sequence[Sequence[float]],
        strikes_expiries: Sequence[Sequence[np.ndarray]],
        market_ivols_expiries: Sequence[Sequence[np.ndarray]],
        t_grid_pts: int = 31,
        nb_iters: int = 24,
        **kwargs,
) -> Tuple[MultiFactRateLogSvParams, List[float]]:
    """bootstrap the full ``(beta, volvol)`` term structure expiry by expiry
    with :func:`calibrate_rate_logsv_lm_on_device` (``kwargs`` go there,
    ``device`` among them).  Row ``i`` of the market inputs holds, per tenor,
    the smile at ``expiries[i]``.  Returns the fitted parameter set and the
    per-expiry LM costs."""
    params = copy.deepcopy(params0)
    costs: List[float] = []
    for i, expiry in enumerate(expiries):
        seg = np.searchsorted(np.asarray(params.ts), float(expiry)) - 1
        seg = int(np.clip(seg, 0, params.beta.xs.shape[0] - 1))
        t_grid = generate_ttms_grid(np.array([float(expiry)]), nb_pts=t_grid_pts)
        params, cost = calibrate_rate_logsv_lm_on_device(
            params, t_grid, expiry=float(expiry), idx=seg, tenors=tenors,
            forwards=forwards_expiries[i], strikes_tenors=strikes_expiries[i],
            market_ivols_tenors=market_ivols_expiries[i], nb_iters=nb_iters, **kwargs)
        costs.append(cost)
    return params, costs


def calibrate_rate_logsv_cube_lm_on_device(
        params: MultiFactRateLogSvParams,
        slices: Sequence[Tuple[float, float]],
        forwards: Sequence[float],
        strikes_slices: Sequence[np.ndarray],
        market_ivols_slices: Sequence[np.ndarray],
        segments: Optional[Sequence[int]] = None,
        weights_slices: Optional[Sequence[np.ndarray]] = None,
        nb_iters: int = 24,
        beta_bound: float = 2.0,
        volvol_bounds: Tuple[float, float] = (0.01, 2.0),
        year_steps: int = 48,
        nb_grid_pts: int = 31,
        mesh=None,
        fit_A: bool = False,
        A_bounds: Tuple[float, float] = (1e-5, 0.2),
        device="cuda",
        **cube_kwargs,
) -> Tuple[MultiFactRateLogSvParams, float]:
    """joint fit of the (beta, volvol) term structure to a whole swaption
    cube in one LM solve on the device.

    The residuals of every (expiry, tenor, strike) quote go through one cube
    reprice (:func:`make_swaption_cube_fn`, frozen panels) per evaluation.
    ``segments`` selects the free term-structure segments (default: every
    segment the expiries reach).  ``fit_A=True`` adds the per-segment
    factor-vol levels A (bounded by ``A_bounds``) and prices through the
    traced cube (:func:`make_swaption_cube_fn_traced`), so the Jacobian goes
    through the structural panels.  The cube builders' own keywords pass
    through ``cube_kwargs``; those of the other builder (``panel_rtol`` and
    ``panel_atol`` of the frozen one, ``n_sub`` of the traced one) are
    dropped, so that toggling ``fit_A`` never raises.  ``mesh`` (a
    ``PathMesh``) splits the cube's slices over its devices, with the LM
    state on the first (``device`` is then unused); on one device it is the
    unsharded fit.  Returns ``(updated params copy, best cost)``.
    """
    n_seg = params.beta.xs.shape[0]
    if segments is None:
        last = max(int(np.searchsorted(np.asarray(params.ts), float(e)) - 1) for e, _ in slices)
        segments = list(range(0, min(last, n_seg - 1) + 1))
    cube_kwargs = dict(cube_kwargs)
    for k in (("panel_rtol", "panel_atol") if fit_A else ("n_sub",)):
        cube_kwargs.pop(k, None)
    build = make_swaption_cube_fn_traced if fit_A else make_swaption_cube_fn
    cube, mask = build(params, slices, forwards, strikes_slices, year_steps=year_steps,
                       nb_grid_pts=nb_grid_pts, mesh=mesh, device=device, **cube_kwargs)
    quotes = _quote_panels(cube, forwards, strikes_slices, market_ivols_slices,
                           [e for e, _ in slices], weights_slices)
    return _fit_segments(params, cube, fit_A, segments, quotes, np.arange(mask.numel()),
                         nb_iters, beta_bound, volvol_bounds, A_bounds)


def swaption_chain_to_cube(swaption_chain,
                           max_expiry: Optional[float] = None):
    """flatten a SwOptionChain into (slices, forwards, strikes_slices,
    market_ivols_slices) rows, one per (expiry, tenor), optionally capped
    at ``max_expiry`` (e.g. where the parameter term structure ends)."""
    slices, forwards, strikes_slices, ivols_slices = [], [], [], []
    for i, tenor in enumerate(np.asarray(swaption_chain.tenors, dtype=float)):
        for j, ttm in enumerate(np.asarray(swaption_chain.ttms, dtype=float)):
            if max_expiry is not None and ttm > float(max_expiry):
                continue
            slices.append((float(ttm), float(tenor)))
            forwards.append(float(swaption_chain.forwards[i][j]))
            strikes_slices.append(np.asarray(swaption_chain.strikes_ttms[i][j]))
            ivols_slices.append(np.asarray(swaption_chain.bid_ivs[i][j]))
    return slices, forwards, strikes_slices, ivols_slices


def prefit_A_to_atm(params: MultiFactRateLogSvParams,
                    slices: Sequence[Tuple[float, float]],
                    forwards: Sequence[float],
                    strikes_slices: Sequence[np.ndarray],
                    market_ivols_slices: Sequence[np.ndarray],
                    nb_outer: int = 4,
                    year_steps: int = 48,
                    damping: float = 1.0,
                    traced: bool = True,
                    device="cuda",
                    ) -> Tuple[MultiFactRateLogSvParams, float]:
    """fix-point prefit of the per-segment factor-vol levels A to the ATM
    normal vols of the cube (the paper's stage-1 calibration).

    Each tenor maps to its nearest basis key term; each outer iteration
    reprices the cube once and scales ``A[seg][j] *= (mkt_atm /
    model_atm)``, averaged over the slices that inform it, for the latest
    segment covering the expiry.  With ``traced=True`` the cube prices
    through ``make_swaption_cube_fn_traced`` with A as an input, so every
    outer iteration replays one program; ``traced=False`` writes A into the
    parameters and re-freezes the host panels each iteration.  The ATM
    quotes of all slices invert in one batched bisection per iteration (a
    non-finite model vol skips its slice).  Returns ``(updated params copy,
    max ATM error in bp)``.
    """
    params = copy.deepcopy(params)
    key_terms = np.asarray(params.basis.key_terms, dtype=float)
    expiries = sorted({e for e, _ in slices})
    # latest term-structure segment covering each expiry
    seg_of = {e: int(np.clip(np.searchsorted(np.asarray(params.ts), e) - 1,
                             0, params.A.shape[0] - 1)) for e in expiries}
    # ATM quote (nearest strike to forward) per slice
    atm_mkt, atm_strike = [], []
    for (e, tenor), fwd, strikes, ivs in zip(slices, forwards, strikes_slices,
                                             market_ivols_slices):
        k = int(np.argmin(np.abs(np.asarray(strikes) - fwd)))
        atm_strike.append(k)
        atm_mkt.append(float(np.asarray(ivs)[k]))

    device = torch.device(device)
    f64 = lambda a: torch.as_tensor(np.asarray(a, dtype=np.float64), device=device)
    rows = torch.arange(len(slices), device=device)
    cols = torch.as_tensor(atm_strike, device=device)
    atm_fwd = f64([float(f) for f in forwards])
    atm_ttm = f64([float(e) for e, _ in slices])
    atm_k = f64([float(np.asarray(s)[k]) for s, k in zip(strikes_slices, atm_strike)])
    if traced:
        cube, _ = make_swaption_cube_fn_traced(params, slices, forwards, strikes_slices,
                                               year_steps=year_steps, device=device)
        sigma0, _, beta, volvol, k1, k2 = cube.primals()
    A = params.A.copy()

    max_err_bp = np.inf
    for _ in range(nb_outer):
        if traced:
            px = cube(sigma0, f64(A), beta, volvol, k1, k2)
        else:
            for seg in range(A.shape[0]):
                params.update_params(idx=seg, A_idx=A[seg])
            fn, _ = make_swaption_cube_fn(params, slices, forwards, strikes_slices,
                                          year_steps=year_steps, device=device)
            px = fn(params.sigma0, params.beta.xs, params.volvol.xs)
        model_atms = infer_normal_implied_vol(forward=atm_fwd, ttm=atm_ttm, strike=atm_k,
                                              given_price=px[rows, cols]).cpu().numpy()
        # per (segment, key-term) multiplicative updates, averaged over the
        # slices that inform them
        ratios = {}
        errs = []
        for p, (e, tenor) in enumerate(slices):
            model_atm = float(model_atms[p])
            if not np.isfinite(model_atm):
                continue
            j = int(np.argmin(np.abs(key_terms - tenor)))
            ratios.setdefault((seg_of[e], j), []).append(atm_mkt[p] / model_atm)
            errs.append(abs(model_atm - atm_mkt[p]) * 1e4)
        max_err_bp = float(np.max(errs)) if errs else np.inf
        new_A = A.copy()
        for (seg, j), rs in ratios.items():
            r = float(np.mean(rs)) ** damping
            new_A[seg, j] = A[seg, j] * r
        A = new_A
    for seg in range(A.shape[0]):
        params.update_params(idx=seg, A_idx=A[seg])
    return params, max_err_bp


def calibrate_rate_logsv_full(params0: MultiFactRateLogSvParams,
                              slices: Sequence[Tuple[float, float]],
                              forwards: Sequence[float],
                              strikes_slices: Sequence[np.ndarray],
                              market_ivols_slices: Sequence[np.ndarray],
                              nb_rounds: int = 2,
                              nb_outer_atm: int = 4,
                              nb_iters_lm: int = 24,
                              year_steps: int = 48,
                              device="cuda",
                              **lm_kwargs,
                              ) -> Tuple[MultiFactRateLogSvParams, float]:
    """two-stage cube calibration from scratch: the ATM prefit of A
    (:func:`prefit_A_to_atm`) and the joint (beta, volvol) cube LM
    (:func:`calibrate_rate_logsv_cube_lm_on_device`) in alternation, for
    ``nb_rounds`` rounds (the second re-levels A under the fitted skew).
    Returns ``(fitted params, final LM cost)``."""
    params, cost = params0, np.inf
    for _ in range(nb_rounds):
        params, _ = prefit_A_to_atm(params, slices, forwards, strikes_slices,
                                    market_ivols_slices, nb_outer=nb_outer_atm,
                                    year_steps=year_steps, device=device)
        params, cost = calibrate_rate_logsv_cube_lm_on_device(
            params, slices, forwards, strikes_slices, market_ivols_slices,
            nb_iters=nb_iters_lm, year_steps=year_steps, device=device, **lm_kwargs)
    return params, cost
