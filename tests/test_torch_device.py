"""The port's entry points run on the card unless the caller asks for the CPU.

(a) no public function, method or class of ``stochvolmodels_torch`` has a
    ``device`` parameter whose default is the CPU (or ``None``, PyTorch's
    CPU default): each default names a CUDA device;
(b) on a PyTorch without CUDA, as here, a call on the default device raises
    instead of running on the CPU: the pricers, the fast implied vol, and
    the calibrations (LogSV SLSQP, LM and Adam; Heston SLSQP and LM; Hawkes
    SLSQP, LM and the risk-premia fit), the Q_VAR pricer and the densities,
    the QMC chain MC, the vol paths and the MC calibration, the Bachelier
    and Student-t analytics, the GMM and Student-t pricers and fits, the
    LogSV and Heston LM sweeps, and the factor-HJM swaption slice and cube
    pricers, the cube greeks, the adaptive tanh-sinh pricer and both rate
    pricers; the traced cube and its greeks, the five cube calibrations and
    the pricer's, the multi-factor, futures and swaption Monte Carlo, and
    the futures chain's vegas.
"""
import importlib
import inspect
import pkgutil

import numpy as np
import pytest
import torch

import stochvolmodels_torch as svt
from stochvolmodels_torch.ops import random as port_random
from stochvolmodels_torch.parallel.sweep import calibrate_heston_lm_sweep as heston_lm_sweep
from stochvolmodels_torch.parallel.sweep import calibrate_logsv_lm_sweep as logsv_lm_sweep


def public_callables():
    """(qualified name, callable) of every public function, class and method
    defined in the port's modules."""
    found = {}
    for info in pkgutil.walk_packages(svt.__path__, prefix="stochvolmodels_torch."):
        module = importlib.import_module(info.name)
        for name, obj in vars(module).items():
            if name.startswith("_") or getattr(obj, "__module__", None) != module.__name__:
                continue
            if inspect.isfunction(obj):
                found[f"{module.__name__}.{name}"] = obj
            elif inspect.isclass(obj):
                for attr, member in vars(obj).items():
                    public = attr == "__init__" or not attr.startswith("_")
                    if inspect.isfunction(member) and public:
                        found[f"{module.__name__}.{name}.{attr}"] = member
    return found


def test_no_device_parameter_defaults_to_the_cpu():
    with_device = {}
    for name, fn in public_callables().items():
        param = inspect.signature(fn).parameters.get("device")
        if param is not None and param.default is not inspect.Parameter.empty:
            with_device[name] = param.default
    # the pricers, the chain lowering, the grids, the MC chain pricers, the
    # generator, the LM and Adam calibrations
    assert len(with_device) >= 18, sorted(with_device)
    for name in ("models.logsv.fast_calibration.calibrate_logsv_lm_on_device",
                 "models.heston.calibrate_heston_lm",
                 "models.hawkes_jd.calibrate_hawkesjd_lm_on_device",
                 "models.hawkes_jd.hawkesjd_forwards_under_risk_kernel",
                 "ops.bachelier.compute_normal_deltas_ttms",
                 "models.gmm.gmm_vanilla_chain_pricer",
                 "models.tdist.tdist_vanilla_chain_pricer",
                 "parallel.sweep.calibrate_logsv_lm_sweep",
                 "parallel.sweep.calibrate_heston_lm_sweep",
                 "models.factor_hjm.rate_logsv_pricer.make_swaption_slice_fn",
                 "models.factor_hjm.rate_logsv_pricer.make_swaption_cube_fn",
                 "models.factor_hjm.rate_logsv_pricer.logsv_chain_de_pricer",
                 "models.factor_hjm.rate_logsv_pricer.futures_conv_adj",
                 "models.greeks.swaption_cube_greeks",
                 "models.factor_hjm.rate_logsv_pricer.make_swaption_cube_fn_traced",
                 "models.factor_hjm.rate_logsv_pricer.simulate_logsv_MF",
                 "models.factor_hjm.rate_logsv_pricer.simulate_logsv_futures_MF",
                 "models.factor_hjm.rate_logsv_pricer.calc_futures_mc_vols",
                 "models.factor_hjm.fast_calibration.calibrate_rate_logsv_lm_on_device",
                 "models.factor_hjm.fast_calibration.calibrate_rate_logsv_cube_lm_on_device",
                 "models.factor_hjm.fast_calibration.prefit_A_to_atm",
                 "models.factor_hjm.fast_calibration.calibrate_rate_logsv_full",
                 "models.factor_hjm.factor_hjm_pricer.do_mc_simulation",
                 "models.factor_hjm.factor_hjm_pricer.calc_mc_vols",
                 "data.option_chain.FutOptionChain.get_chain_vegas"):
        assert f"stochvolmodels_torch.{name}" in with_device, name
    not_cuda = {name: d for name, d in with_device.items()
                if d is None or torch.device(d).type != "cuda"}
    assert not not_cuda, not_cuda


def default_device_calls():
    chain = svt.get_btc_test_chain_data()
    return {
        "LogSVPricer.price_chain": lambda: svt.LogSVPricer().price_chain(
            chain, svt.LOGSV_BTC_PARAMS),
        "HestonPricer.price_chain": lambda: svt.HestonPricer().price_chain(
            chain, svt.BTC_HESTON_PARAMS),
        "HawkesJDPricer.model_mc_price_chain": lambda: svt.HawkesJDPricer().model_mc_price_chain(
            chain, svt.HawkesJDParams(), nb_path=256, engine="cuda"),
        "OptionChain.to_grid": chain.to_grid,
        "get_phi_grid": svt.get_phi_grid,
        "compute_bsm_vanilla_price": lambda: svt.compute_bsm_vanilla_price(
            np.ones(3), np.ones(3), np.ones(3), np.full(3, 0.5)),
        "generator_from_seed": lambda: port_random.generator_from_seed(7),
        "infer_bsm_implied_vol_fast": lambda: svt.infer_bsm_implied_vol_fast(
            np.ones(3), np.ones(3), np.ones(3), np.full(3, 0.1)),
        "LogSVPricer.compute_model_ivols_for_chain(fast)":
            lambda: svt.LogSVPricer().compute_model_ivols_for_chain(
                chain, svt.LOGSV_BTC_PARAMS, precision="fast"),
        "LogSVPricer.calibrate_model_params_to_chain(slsqp)":
            lambda: svt.LogSVPricer().calibrate_model_params_to_chain(chain, svt.LOGSV_BTC_PARAMS),
        "LogSVPricer.calibrate_model_params_to_chain(lm)":
            lambda: svt.LogSVPricer().calibrate_model_params_to_chain(
                chain, svt.LOGSV_BTC_PARAMS, method="lm"),
        "calibrate_logsv_lm_on_device": lambda: svt.calibrate_logsv_lm_on_device(
            chain, svt.LOGSV_BTC_PARAMS),
        "calibrate_logsv_on_device": lambda: svt.calibrate_logsv_on_device(
            chain, svt.LOGSV_BTC_PARAMS),
        "HestonPricer.compute_model_ivols_for_chain(fast)":
            lambda: svt.HestonPricer().compute_model_ivols_for_chain(
                chain, svt.BTC_HESTON_PARAMS, precision="fast"),
        "HestonPricer.calibrate_model_params_to_chain(slsqp)":
            lambda: svt.HestonPricer().calibrate_model_params_to_chain(chain, svt.BTC_HESTON_PARAMS),
        "HestonPricer.calibrate_model_params_to_chain(lm)":
            lambda: svt.HestonPricer().calibrate_model_params_to_chain(
                chain, svt.BTC_HESTON_PARAMS, method="lm"),
        "calibrate_heston_lm": lambda: svt.calibrate_heston_lm(chain, svt.BTC_HESTON_PARAMS),
        "HawkesJDPricer.price_chain": lambda: svt.HawkesJDPricer().price_chain(
            chain, svt.HawkesJDParams()),
        "HawkesJDPricer.compute_model_ivols_for_chain(fast)":
            lambda: svt.HawkesJDPricer().compute_model_ivols_for_chain(
                chain, svt.HawkesJDParams(), precision="fast"),
        "HawkesJDPricer.calibrate_model_params_to_chain(slsqp)":
            lambda: svt.HawkesJDPricer().calibrate_model_params_to_chain(
                chain, svt.HawkesJDParams()),
        "HawkesJDPricer.calibrate_model_params_to_chain(lm)":
            lambda: svt.HawkesJDPricer().calibrate_model_params_to_chain(
                chain, svt.HawkesJDParams(), method="lm"),
        "HawkesJDPricer.calibrate_risk_premia_gamma_to_chain":
            lambda: svt.HawkesJDPricer().calibrate_risk_premia_gamma_to_chain(
                chain, svt.HawkesJDParams(risk_premia_gamma=0.5)),
        "calibrate_hawkesjd_lm_on_device": lambda: svt.calibrate_hawkesjd_lm_on_device(
            chain, svt.HawkesJDParams()),
        "LogSVPricer.price_chain(Q_VAR)": lambda: svt.LogSVPricer().price_chain(
            chain, svt.LOGSV_BTC_PARAMS, variable_type=svt.VariableType.Q_VAR),
        "logsv_pdfs": lambda: svt.logsv_pdfs(svt.LOGSV_BTC_PARAMS, 0.1, np.linspace(-1, 1, 5)),
        "LogSVPricer.model_mc_price_chain(qmc)": lambda: svt.LogSVPricer().model_mc_price_chain(
            chain, svt.LOGSV_BTC_PARAMS, nb_path=256, engine="qmc"),
        "LogSVPricer.simulate_vol_paths": lambda: svt.LogSVPricer().simulate_vol_paths(
            svt.LOGSV_BTC_PARAMS, ttm=0.1, nb_path=16),
        "LogSVPricer.calibrate_model_params_to_chain(MC)":
            lambda: svt.LogSVPricer().calibrate_model_params_to_chain(
                chain, svt.LOGSV_BTC_PARAMS, calibration_engine=svt.CalibrationEngine.MC,
                nb_path=256),
        "compute_normal_price": lambda: svt.compute_normal_price(
            np.ones(3), np.ones(3), np.ones(3), np.full(3, 0.05)),
        "infer_normal_implied_vol": lambda: svt.infer_normal_implied_vol(
            np.ones(3), np.ones(3), np.ones(3), np.full(3, 0.01)),
        "infer_normal_implied_vol_fast": lambda: svt.infer_normal_implied_vol_fast(
            np.ones(3), np.ones(3), np.ones(3), np.full(3, 0.01)),
        "compute_vanilla_price_tdist": lambda: svt.compute_vanilla_price_tdist(
            1.0, np.ones(3), 0.25, 0.8),
        "infer_implied_vol_tdist": lambda: svt.infer_implied_vol_tdist(
            1.0, 0.25, np.ones(3), np.full(3, 0.1)),
        "GmmPricer.price_chain": lambda: svt.GmmPricer().price_chain(
            chain, svt.GmmParams(np.array([0.5, 0.5]), np.zeros(2), np.array([0.5, 1.0]), 0.1)),
        "GmmPricer.calibrate_model_params_to_chain": lambda: svt.GmmPricer(
            ).calibrate_model_params_to_chain(chain),
        "TdistPricer.price_chain": lambda: svt.TdistPricer().price_chain(
            chain, svt.TdistParams(drift=0.0, vol=0.8, nu=4.0, ttm=0.1)),
        "TdistPricer.calibrate_model_params_to_chain": lambda: svt.TdistPricer(
            ).calibrate_model_params_to_chain(chain),
        "calibrate_logsv_lm_sweep": lambda: logsv_lm_sweep([chain, chain], svt.LOGSV_BTC_PARAMS),
        "calibrate_heston_lm_sweep": lambda: heston_lm_sweep([chain, chain],
                                                             svt.BTC_HESTON_PARAMS),
        **rate_default_device_calls(),
    }


def rate_default_device_calls():
    from stochvolmodels_torch.models.factor_hjm import rate_logsv_pricer as rates
    from stochvolmodels_torch.utils.rate_core import generate_ttms_grid

    ts = np.array([0.0, 1.0, 2.0])
    params = svt.MultiFactRateLogSvParams(
        sigma0=1.0, theta=1.0, kappa1=1.0, kappa2=1.0,
        beta=svt.TermStructure(ts=ts, xs=np.array([[0.1, -0.05, 0.0]] * 2)),
        volvol=svt.TermStructure(ts=ts, xs=np.array([0.3, 0.3])), A=np.full(3, 0.01),
        R=np.eye(3), basis=svt.NelsonSiegel(meanrev=0.25, key_terms=np.array([1.0, 5.0, 10.0])),
        ccy="USD")
    strikes = np.array([-0.01, 0.0, 0.01])
    t_grid = generate_ttms_grid(np.array([1.0]))
    chain = svt.SwOptionChain(
        ccy="USD", ttms=np.array([1.0]), tenors=np.array([1.0, 5.0, 10.0]), ttms_ids=["1y"],
        tenors_ids=["1y", "5y", "10y"], forwards=[np.zeros(1)] * 3,
        strikes_ttms=[[strikes]] * 3, bid_ivs=[[np.full(3, 0.01)]] * 3,
        ask_ivs=[[np.full(3, 0.01)]] * 3)
    futures = type("FuturesRows", (), dict(ttms=np.array([1.0]), forwards=np.array([0.045]),
                                           strikes_ttms=[0.045 + strikes],
                                           optiontypes_ttms=[np.repeat('C', 3)]))
    return {
        "make_swaption_slice_fn": lambda: rates.make_swaption_slice_fn(
            params, t_grid, ttm=1.0, tenor=1.0, forward=0.0, strikes=strikes),
        "make_swaption_cube_fn": lambda: rates.make_swaption_cube_fn(
            params, [(1.0, 1.0)], [0.0], [strikes]),
        "swaption_cube_greeks": lambda: svt.swaption_cube_greeks(
            params, [(1.0, 1.0)], [0.0], [strikes]),
        "logsv_chain_de_pricer": lambda: rates.logsv_chain_de_pricer(
            params, t_grid, np.array([1.0]), [np.zeros(1)] * 3, [[strikes]] * 3,
            [np.repeat('C', 3)]),
        "RateLogSVPricer.price_chain": lambda: svt.RateLogSVPricer().price_chain(
            chain, params, t_grid=t_grid, idxs=slice(0, 1)),
        "RateFutLogSVPricer.price_chain": lambda: svt.RateFutLogSVPricer().price_chain(
            futures, params, t_grid=t_grid, idxs=slice(0, 1)),
        **rate_suite_default_device_calls(params, strikes, t_grid, chain),
    }


def rate_suite_default_device_calls(params, strikes, t_grid, chain):
    """the traced cube, the cube calibration, the Monte Carlo and the futures
    chain's vegas, each on its default device."""
    from stochvolmodels_torch.models.factor_hjm import factor_hjm_pricer as mc
    from stochvolmodels_torch.models.factor_hjm import fast_calibration as fc
    from stochvolmodels_torch.models.factor_hjm import rate_logsv_pricer as rates

    cube = ([(1.0, 1.0)], [0.0], [strikes], [np.full(3, 0.01)])
    mf = dict(ttms=np.array([1.0]), x0=np.zeros(3), y0=np.zeros(8), I0=np.zeros(1),
              sigma0=np.ones(1), theta=1.0, kappa1=1.0, kappa2=1.0, ts=params.ts, A=params.A,
              R=params.R, C=params.C, Omega=params.Omega, betaxs=params.beta.xs,
              volvolxs=params.volvol.xs, basis=params.basis, ts_sw=None, T_fwd=None,
              ccy="USD", nb_path=8)
    fut_chain = svt.FutOptionChain(
        ccy="USD", ttms=np.array([0.5]), forwards=np.array([0.05]), strikes_ttms=[0.05 + strikes],
        ttms_ids=np.array(["M"]), ivs_call_ttms=[np.full(3, 0.01)],
        ivs_put_ttms=[np.full(3, 0.01)])
    mc_vols = dict(basis_type="NELSON-SIEGEL", params=params, ttm=1.0, tenors=np.array([1.0]),
                   forwards=[np.array([0.04])], strikes_ttms=[[0.04 + strikes]],
                   optiontypes=np.repeat('C', 3), is_annuity_measure=False, nb_path=8)
    return {
        "make_swaption_cube_fn_traced": lambda: rates.make_swaption_cube_fn_traced(
            params, *cube[:3]),
        "swaption_cube_greeks(traced)": lambda: svt.swaption_cube_greeks(
            params, *cube[:3], traced=True),
        "calibrate_rate_logsv_lm_on_device": lambda: fc.calibrate_rate_logsv_lm_on_device(
            params, t_grid, 1.0, 0, [1.0], [0.0], [strikes], [np.full(3, 0.01)]),
        "calibrate_rate_logsv_term_structure": lambda: fc.calibrate_rate_logsv_term_structure(
            params, [1.0], [1.0], [[0.0]], [[strikes]], [[np.full(3, 0.01)]]),
        "calibrate_rate_logsv_cube_lm_on_device":
            lambda: fc.calibrate_rate_logsv_cube_lm_on_device(params, *cube),
        "prefit_A_to_atm(traced)": lambda: fc.prefit_A_to_atm(params, *cube),
        "prefit_A_to_atm(frozen)": lambda: fc.prefit_A_to_atm(params, *cube, traced=False),
        "calibrate_rate_logsv_full": lambda: fc.calibrate_rate_logsv_full(params, *cube),
        "RateLogSVPricer.calibrate_model_params_to_chain":
            lambda: svt.RateLogSVPricer().calibrate_model_params_to_chain(chain, params),
        "simulate_logsv_MF": lambda: rates.simulate_logsv_MF(**mf),
        "simulate_logsv_futures_MF": lambda: rates.simulate_logsv_futures_MF(
            params, 0.5, 0.5, 0.75, nb_path=8),
        "calc_futures_mc_vols": lambda: rates.calc_futures_mc_vols(
            params, 0.5, 0.5, 0.75, strikes=0.05 + strikes, optiontypes=np.repeat('C', 3),
            nb_path=8),
        "do_mc_simulation": lambda: mc.do_mc_simulation(
            "NELSON-SIEGEL", "USD", np.array([1.0]), np.zeros((8, 3)), np.zeros((8, 8)),
            np.zeros(8), np.ones((8, 1)), params, nb_path=8),
        "calc_mc_vols": lambda: mc.calc_mc_vols(**mc_vols),
        "FutOptionChain.get_chain_vegas": fut_chain.get_chain_vegas,
    }


RATE_SUITE_CALLS = ["make_swaption_cube_fn_traced", "swaption_cube_greeks(traced)",
                    "calibrate_rate_logsv_lm_on_device", "calibrate_rate_logsv_term_structure",
                    "calibrate_rate_logsv_cube_lm_on_device", "prefit_A_to_atm(traced)",
                    "prefit_A_to_atm(frozen)", "calibrate_rate_logsv_full",
                    "RateLogSVPricer.calibrate_model_params_to_chain", "simulate_logsv_MF",
                    "simulate_logsv_futures_MF", "calc_futures_mc_vols", "do_mc_simulation",
                    "calc_mc_vols", "FutOptionChain.get_chain_vegas"]


@pytest.mark.parametrize("name", ["LogSVPricer.price_chain", "HestonPricer.price_chain",
                                  "HawkesJDPricer.model_mc_price_chain", "OptionChain.to_grid",
                                  "get_phi_grid", "compute_bsm_vanilla_price",
                                  "generator_from_seed", "infer_bsm_implied_vol_fast",
                                  "LogSVPricer.compute_model_ivols_for_chain(fast)",
                                  "LogSVPricer.calibrate_model_params_to_chain(slsqp)",
                                  "LogSVPricer.calibrate_model_params_to_chain(lm)",
                                  "calibrate_logsv_lm_on_device", "calibrate_logsv_on_device",
                                  "HestonPricer.compute_model_ivols_for_chain(fast)",
                                  "HestonPricer.calibrate_model_params_to_chain(slsqp)",
                                  "HestonPricer.calibrate_model_params_to_chain(lm)",
                                  "calibrate_heston_lm", "HawkesJDPricer.price_chain",
                                  "HawkesJDPricer.compute_model_ivols_for_chain(fast)",
                                  "HawkesJDPricer.calibrate_model_params_to_chain(slsqp)",
                                  "HawkesJDPricer.calibrate_model_params_to_chain(lm)",
                                  "HawkesJDPricer.calibrate_risk_premia_gamma_to_chain",
                                  "calibrate_hawkesjd_lm_on_device",
                                  "LogSVPricer.price_chain(Q_VAR)", "logsv_pdfs",
                                  "LogSVPricer.model_mc_price_chain(qmc)",
                                  "LogSVPricer.simulate_vol_paths",
                                  "LogSVPricer.calibrate_model_params_to_chain(MC)",
                                  "compute_normal_price", "infer_normal_implied_vol",
                                  "infer_normal_implied_vol_fast", "compute_vanilla_price_tdist",
                                  "infer_implied_vol_tdist", "GmmPricer.price_chain",
                                  "GmmPricer.calibrate_model_params_to_chain",
                                  "TdistPricer.price_chain",
                                  "TdistPricer.calibrate_model_params_to_chain",
                                  "calibrate_logsv_lm_sweep", "calibrate_heston_lm_sweep",
                                  "make_swaption_slice_fn", "make_swaption_cube_fn",
                                  "swaption_cube_greeks", "logsv_chain_de_pricer",
                                  "RateLogSVPricer.price_chain",
                                  "RateFutLogSVPricer.price_chain"] + RATE_SUITE_CALLS)
def test_default_device_call_raises_without_a_card(name):
    if torch.cuda.is_available():
        pytest.skip("this PyTorch has a CUDA device: the default device runs")
    with pytest.raises((AssertionError, RuntimeError)):
        default_device_calls()[name]()
