"""The CUDA graphs of the launch-bound calls (``stochvolmodels_torch/ops/graphs.py``).

On the CPU nothing is captured: the calls run eagerly because their tensors
lie on the CPU, and the guards that make a misplaced capture raise hold.
The LM loop split into ``lm_init`` and ``lm_step`` (so that one iteration
can be a graph) gives the fit of the loop it replaced, bit for bit.  On a
card (``gpu``-marked, skipped here) the captured bisection, LogSV and Heston
LM fits, Hawkes reprices (plain and risk-premia) and Hawkes LM iteration
equal the eager calls bit for bit.
"""
import numpy as np
import pytest
import torch
from torch.func import jacfwd

from _torch_port import btc_chains, cuda_device  # noqa: F401

import stochvolmodels_torch as svt
from stochvolmodels_torch.models import hawkes_jd, heston
from stochvolmodels_torch.ops import graphs, lm

PARAMS0 = dict(sigma0=0.8, theta=1.0, kappa1=2.21, kappa2=2.18, beta=0.15, volvol=1.85)


def test_calls_on_cpu_tensors_are_not_captured():
    cpu = torch.zeros(3, dtype=torch.float64)
    assert not graphs.use_graph(cpu)
    with graphs.eager():
        assert not graphs.use_graph(cpu)
    before = dict(graphs.REPLAYS)
    _, ct = btc_chains()
    svt.LogSVPricer(device="cpu").compute_model_ivols_for_chain(ct, svt.LOGSV_BTC_PARAMS)
    assert dict(graphs.REPLAYS) == before


def test_hawkes_and_heston_calls_on_cpu_tensors_are_not_captured():
    before = dict(graphs.REPLAYS)
    _, ct = btc_chains()
    two = svt.OptionChain.get_slices_as_chain(ct, ids=ct.ids[:2])
    svt.HawkesJDPricer(device="cpu").price_chain(two, svt.HawkesJDParams(), year_steps=60)
    svt.calibrate_hawkesjd_lm_on_device(two, svt.HawkesJDParams(), nb_iters=1, year_steps=60,
                                        device="cpu")
    svt.calibrate_heston_lm(two, svt.BTC_HESTON_PARAMS, nb_iters=1, device="cpu")
    assert dict(graphs.REPLAYS) == before


def loop_before_the_split(residuals_fn, p0, lower, upper, nb_iters, lam0=1e-2):
    """``ops/lm.py::lm_minimize`` as one loop, before its split into
    ``lm_init`` and ``lm_step``."""
    n = p0.shape[0]
    eye = torch.eye(n, dtype=p0.dtype, device=p0.device)
    jac_and_res = jacfwd(lambda p: (lambda r: (r, r))(residuals_fn(p)), has_aux=True)
    pars, best_pars = p0, p0
    lam = torch.full((), lam0, dtype=p0.dtype, device=p0.device)
    best_cost = torch.sum(torch.square(residuals_fn(p0)))
    for _ in range(nb_iters):
        J, r = jac_and_res(pars)
        cost = torch.sum(r * r)
        g = J.T @ r
        JTJ = J.T @ J
        D = torch.diag(torch.clamp(torch.diagonal(JTJ), min=1e-10))
        step = lm.cg_solve(JTJ + lam * D + 1e-12 * eye, -g, iters=n + 3)
        cand = torch.clamp(pars + step, lower, upper)
        new_cost = torch.sum(torch.square(residuals_fn(cand)))
        accept = new_cost < cost
        pars = torch.where(accept, cand, pars)
        lam = torch.where(accept, torch.clamp(lam / 3.0, min=1e-8),
                          torch.clamp(lam * 4.0, max=1e6))
        better = new_cost < best_cost
        best_pars = torch.where(better, cand, best_pars)
        best_cost = torch.where(better, new_cost, best_cost)
    return best_pars, best_cost


def test_lm_split_gives_the_fit_of_the_loop_it_replaced():
    """the Heston LM residuals on the BTC chain, 4 iterations."""
    _, ct = btc_chains()
    p0 = np.array([0.8, 1.0, 2.0, 0.1, 1.5])
    grid, market, weights, vol_scaler = heston._calibration_targets(ct, p0, True, False, "cpu")
    residuals = heston._heston_residuals(
        grid.ttms, grid.forwards, grid.discfactors, grid.strikes, grid.optioncodes, grid.mask,
        market, torch.sqrt(weights), torch.tensor(vol_scaler, dtype=torch.float64),
        ttms_static=tuple(float(t) for t in ct.ttms))
    f64 = lambda a: torch.tensor(a, dtype=torch.float64)
    box = (f64([b[0] for b in heston.HESTON_BOUNDS]), f64([b[1] for b in heston.HESTON_BOUNDS]))
    before = loop_before_the_split(residuals, f64(p0), *box, nb_iters=4)
    after = lm.lm_minimize(residuals, f64(p0), *box, nb_iters=4)
    state = lm.lm_init(residuals, f64(p0))
    for _ in range(4):
        state = lm.lm_step(residuals, state, *box)
    for b, a, s in zip(before, after, state[2:]):
        assert torch.equal(b, a) and torch.equal(b, s)
    assert float(before[1]) < float(torch.sum(residuals(f64(p0)) ** 2))


def test_eager_restores_capture_after_an_error():
    with pytest.raises(ValueError):
        with graphs.eager():
            raise ValueError
    assert graphs._capture_enabled


def test_a_graph_cannot_run_inside_a_torch_func_transform():
    def inside(x):
        return graphs.run_captured("probe", (), lambda a: (a,), (x,))[0]

    with pytest.raises(RuntimeError, match="torch.func"):
        torch.func.vmap(inside)(torch.zeros(2, 3, dtype=torch.float64))


@pytest.mark.gpu
def test_captured_bisection_equals_eager(cuda_device):  # noqa: F811
    _, ct = btc_chains()
    pricer = svt.LogSVPricer(device=cuda_device)
    prices = pricer.price_chain(ct, svt.LOGSV_BTC_PARAMS)
    with graphs.eager():
        eager = ct.compute_model_ivols_from_chain_data(prices, device=cuda_device)
    before = graphs.REPLAYS["bisection"]
    captured = ct.compute_model_ivols_from_chain_data(prices, device=cuda_device)
    assert graphs.REPLAYS["bisection"] == before + 1
    for a, b in zip(captured, eager):
        np.testing.assert_array_equal(a, b)


@pytest.mark.gpu
def test_captured_lm_fit_equals_eager(cuda_device):  # noqa: F811
    _, ct = btc_chains()
    kw = dict(nb_iters=2, year_steps=60, device=cuda_device)
    with graphs.eager():
        eager_fit, eager_cost = svt.calibrate_logsv_lm_on_device(ct, svt.LogSvParams(**PARAMS0),
                                                                 **kw)
    fit, cost = svt.calibrate_logsv_lm_on_device(ct, svt.LogSvParams(**PARAMS0), **kw)
    assert cost == eager_cost and fit.to_dict() == eager_fit.to_dict()


@pytest.mark.gpu
def test_captured_heston_lm_fit_equals_eager(cuda_device):  # noqa: F811
    _, ct = btc_chains()
    p0 = svt.HestonParams(v0=0.8, theta=1.0, kappa=2.0, rho=0.1, volvol=1.5)
    with graphs.eager():
        eager = svt.calibrate_heston_lm(ct, p0, nb_iters=3, device=cuda_device)
    before = graphs.REPLAYS["heston_lm"]
    captured = svt.calibrate_heston_lm(ct, p0, nb_iters=3, device=cuda_device)
    assert graphs.REPLAYS["heston_lm"] == before + 1
    assert captured[1] == eager[1] and captured[0] == eager[0]


@pytest.mark.gpu
@pytest.mark.parametrize("gamma", [None, 0.5])
def test_captured_hawkes_reprice_equals_eager(cuda_device, gamma):  # noqa: F811
    _, ct = btc_chains()
    if gamma is not None:
        ct = svt.OptionChain.to_forward_normalised_strikes(ct)
    params = svt.HawkesJDParams(risk_premia_gamma=gamma)
    pricer = svt.HawkesJDPricer(device=cuda_device)
    with graphs.eager():
        eager = pricer.compute_chain_prices_with_vols(ct, params)
    before = graphs.REPLAYS["hawkes_price"]
    captured = pricer.compute_chain_prices_with_vols(ct, params)
    assert graphs.REPLAYS["hawkes_price"] == before + 1
    for a, b in zip(captured[0] + captured[1], eager[0] + eager[1]):
        np.testing.assert_array_equal(a, b)


@pytest.mark.gpu
def test_captured_hawkes_lm_iteration_equals_eager(cuda_device):  # noqa: F811
    _, ct = btc_chains()
    two = svt.OptionChain.get_slices_as_chain(ct, ids=ct.ids[:2])
    kw = dict(nb_iters=2, year_steps=60, device=cuda_device)
    with graphs.eager():
        eager = svt.calibrate_hawkesjd_lm_on_device(two, svt.HawkesJDParams(), **kw)
    before = graphs.REPLAYS["hawkes_lm_step"]
    captured = svt.calibrate_hawkesjd_lm_on_device(two, svt.HawkesJDParams(), **kw)
    assert graphs.REPLAYS["hawkes_lm_step"] == before + 2
    assert captured[1] == eager[1] and captured[0] == eager[0]
    assert hawkes_jd.HAWKES_LM_LOWER[0] <= captured[0].sigma <= hawkes_jd.HAWKES_LM_UPPER[0]


@pytest.mark.gpu
@pytest.mark.parametrize("in_vols", [False, True])
def test_captured_greeks_program_equals_eager(cuda_device, in_vols):  # noqa: F811
    _, ct = btc_chains()
    two = svt.OptionChain.get_slices_as_chain(ct, ids=ct.ids[:2])
    pricer = svt.LogSVPricer(device=cuda_device)
    names = ("delta", "gamma", "vega", "theta_calendar")
    with graphs.eager():
        eager = pricer.compute_chain_greeks(two, svt.LOGSV_BTC_PARAMS, greeks=names,
                                            in_vols=in_vols)
    before = graphs.REPLAYS["greeks"]
    captured = pricer.compute_chain_greeks(two, svt.LOGSV_BTC_PARAMS, greeks=names,
                                           in_vols=in_vols)
    assert graphs.REPLAYS["greeks"] == before + 3   # the greeks and theta's two programs
    assert sorted(captured) == sorted(eager)
    for key in eager:
        for a, b in zip(captured[key], eager[key]):
            np.testing.assert_array_equal(a, b)


@pytest.mark.gpu
def test_captured_analytic_ode_and_heston_qmc_equal_eager(cuda_device):  # noqa: F811
    from stochvolmodels_torch.models.logsv import affine
    from stochvolmodels_torch.ops import mgf

    P = svt.LOGSV_BTC_PARAMS
    phi = mgf.get_phi_grid(vol_scaler=0.2, device=cuda_device)
    kw = dict(ttm=0.1, phi_grid=phi, psi_grid=torch.zeros_like(phi), theta_grid=torch.zeros_like(phi),
              sigma0=P.sigma0, theta=P.theta, kappa1=P.kappa1, kappa2=P.kappa2, beta=P.beta,
              volvol=P.volvol, is_analytic=True, vol_scaler=0.2)
    with graphs.eager():
        eager = affine.compute_logsv_a_mgf_grid(**kw)[1]
    before = graphs.REPLAYS["logsv_analytic_ode"]
    captured = affine.compute_logsv_a_mgf_grid(**kw)[1]
    assert graphs.REPLAYS["logsv_analytic_ode"] == before + 1
    assert torch.equal(captured, eager)
    _, ct = btc_chains()
    pricer = svt.HestonPricer(device=cuda_device)
    qmc = dict(engine="qmc", nb_path=1 << 12, qmc_replicates=4, seed=3)
    with graphs.eager():
        eager = pricer.model_mc_price_chain(ct, svt.BTC_HESTON_PARAMS, **qmc)
    before = graphs.REPLAYS["heston_qmc"]
    captured = pricer.model_mc_price_chain(ct, svt.BTC_HESTON_PARAMS, **qmc)
    assert graphs.REPLAYS["heston_qmc"] == before + len(ct.ttms)
    for a, b in zip(captured[0] + captured[1], eager[0] + eager[1]):
        np.testing.assert_array_equal(a, b)
