"""Options on quadratic variance and the model densities of the PyTorch port
against the JAX package (CPU, float64).

* the Psi (40,000 points) and Theta (5,000 points) grids, and their Simpson
  weights: bit for bit;
* the graded-warmup step schedule of the stiff SIGMA/Q_VAR starts: exact;
* the SIGMA and Q_VAR log MGF from ``compute_logsv_a_mgf_grid`` with float
  parameters on a short horizon: 1e-10 relative to max|logMGF| on live lanes;
* Q_VAR chain prices on the QV chain's 1w and 2w slices over the full grid:
  1e-10 x forward; the 1m slice at the port's default of 720 RK4 steps/yr
  (the JAX package's 240 diverges there): sane, and equal to the JAX
  package's at 720;
* the digital MGF pricer against the BSM digital through the BSM MGF (the
  JAX test's oracle, 1e-6) and against the JAX digital pricer (1e-12);
* densities of the log-return, the quadratic variance and the vol at n = 50
  points: 1e-10 absolute (the densities are masses per cell, O(0.1));
* the Fourier Q_VAR call struck near 0 within 2% of the analytic expected
  QV, as ``tests/test_logsv.py`` checks the JAX package (at 0.25y here).
"""
import numpy as np
import pytest
import torch
from _torch_port import README_PARAMS, param_pair

import stochvolmodels_torch as svt
import stochvolmodels_tpu as svj
from stochvolmodels_tpu.config import VariableType as JVT
from stochvolmodels_tpu.models.logsv import affine as jafe
from stochvolmodels_tpu.models.logsv.pricer import logsv_pdfs as j_logsv_pdfs
from stochvolmodels_tpu.ops import bsm as jbsm
from stochvolmodels_tpu.ops import mgf as jmgf
from stochvolmodels_tpu.utils.cplx import Cplx
from stochvolmodels_torch.config import VariableType as TVT
from stochvolmodels_torch.models.logsv import affine as tafe
from stochvolmodels_torch.models.logsv.pricer import LogSVPricer
from stochvolmodels_torch.models.logsv.pricer import logsv_pdfs as t_logsv_pdfs
from stochvolmodels_torch.models.logsv.vol_moments import compute_analytic_qvar
from stochvolmodels_torch.ops import bsm as tbsm
from stochvolmodels_torch.ops import mgf as tmgf

# the stiff paper parameters of tests/test_logsv.py's density test
STIFF = dict(sigma0=0.8327, theta=1.0139, kappa1=4.8609, kappa2=4.7940, beta=0.1988,
             volvol=2.3694)


def _np(c) -> np.ndarray:
    if isinstance(c, Cplx):
        return np.asarray(c.re) + 1j * np.asarray(c.im)
    return c.numpy()


def test_psi_theta_grids_and_weights_exact():
    for jg, tg in ((jmgf.get_psi_grid(), tmgf.get_psi_grid(device="cpu")),
                   (jmgf.get_theta_grid(), tmgf.get_theta_grid(device="cpu"))):
        np.testing.assert_array_equal(_np(tg), _np(jg))
        np.testing.assert_array_equal(tmgf.compute_integration_weights(tg).numpy(),
                                      np.asarray(jmgf.compute_integration_weights(jg)))
    for vt in (JVT.Q_VAR, JVT.SIGMA):
        for spot in (True, False):
            jgrids = jmgf.get_transform_var_grid(variable_type=vt, is_spot_measure=spot)
            tgrids = tmgf.get_transform_var_grid(variable_type=TVT[vt.name],
                                                 is_spot_measure=spot, device="cpu")
            for jg, tg in zip(jgrids, tgrids):
                np.testing.assert_array_equal(_np(tg), _np(jg))


@pytest.mark.parametrize("ttm, scale", [(0.25, 24040.0), (0.02, 160040.0), (0.5, 10.0)])
def test_warmup_schedule_exact(ttm, scale, monkeypatch):
    """the port's schedule is the list of steps the JAX package's
    ``_solve_a_ode_grid_dts`` receives."""
    seen = {}
    monkeypatch.setattr(jafe, "_solve_a_ode_grid_dts",
                        lambda dts, *a, **k: seen.setdefault("dts", np.asarray(dts)))
    dt = ttm / max(int(np.ceil(720 * ttm)), 16)
    grid = jmgf.get_theta_grid(max_theta=4)
    jafe.solve_a_ode_grid(phi_grid=Cplx(grid.re * 0.0, grid.im * 0.0), psi_grid=grid,
                          ttm=ttm, theta=1.0, kappa1=2.0, kappa2=2.0, beta=0.2, volvol=2.0,
                          a_t0=Cplx(np.zeros((4, 5)), np.zeros((4, 5))), warmup_scale=scale)
    ours = tafe.warmup_dts(ttm, dt, scale)
    if "dts" not in seen:
        assert ours is None
    else:
        np.testing.assert_array_equal(np.asarray(ours), seen["dts"])


@pytest.mark.parametrize("variable_type", ["SIGMA", "Q_VAR"])
def test_a_mgf_grid_matches_jax(variable_type):
    """float parameters on both sides (the JAX eager branch of the warmup),
    on 400 points of the standard span, over 3 days."""
    p = dict(README_PARAMS)
    ttm = 3.0 / 365.0
    if variable_type == "SIGMA":
        jg, tg = jmgf.get_theta_grid(max_theta=400), tmgf.get_theta_grid(max_theta=400,
                                                                          device="cpu")
        jgrids = (Cplx(jg.re * 0.0, jg.im * 0.0), Cplx(jg.re * 0.0, jg.im * 0.0), jg)
        tgrids = (torch.zeros_like(tg), torch.zeros_like(tg), tg)
    else:
        jg, tg = jmgf.get_psi_grid(max_psi=400), tmgf.get_psi_grid(max_psi=400, device="cpu")
        jgrids = (Cplx(jg.re * 0.0, jg.im * 0.0), jg, Cplx(jg.re * 0.0, jg.im * 0.0))
        tgrids = (torch.zeros_like(tg), tg, torch.zeros_like(tg))
    _, jl = jafe.compute_logsv_a_mgf_grid(ttm, *jgrids, variable_type=JVT[variable_type], **p)
    _, tl = tafe.compute_logsv_a_mgf_grid(ttm, *tgrids, variable_type=TVT[variable_type], **p)
    jl, tl = _np(jl), _np(tl)
    live = np.abs(jl) < 1e5
    assert live.mean() > 0.9
    scale = np.max(np.abs(jl[live]))
    np.testing.assert_allclose(tl[live], jl[live], rtol=0, atol=1e-10 * scale)


def test_qvar_chain_prices_match_jax():
    cj = svj.get_qv_options_test_chain_data()
    cj = svj.OptionChain.get_slices_as_chain(cj, ids=["1w", "2w"])
    ct = svt.OptionChain.get_slices_as_chain(svt.get_qv_options_test_chain_data(),
                                             ids=["1w", "2w"])
    pj, pt = param_pair(**README_PARAMS)
    jp = svj.LogSVPricer().price_chain(cj, pj, variable_type=JVT.Q_VAR, year_steps=720)
    tp = LogSVPricer(device="cpu").price_chain(ct, pt, variable_type=TVT.Q_VAR)
    for a, b, fwd in zip(tp, jp, cj.forwards):
        assert np.all(np.isfinite(a))
        np.testing.assert_allclose(a, np.asarray(b), rtol=0, atol=1e-10 * fwd)


def test_qvar_default_steps_stable_on_1m():
    """the JAX package's default of 240 RK4 steps/yr prices the QV chain's
    1m and 3m slices at ~4e248 and ~8e269; the port's Q_VAR default is 720,
    where the 1m slice is sane and equals the JAX package's at 720 steps/yr."""
    cj = svj.OptionChain.get_slices_as_chain(svj.get_qv_options_test_chain_data(), ids=["1m"])
    ct = svt.OptionChain.get_slices_as_chain(svt.get_qv_options_test_chain_data(), ids=["1m"])
    pj, pt = param_pair(**README_PARAMS)
    tp = LogSVPricer(device="cpu").price_chain(ct, pt, variable_type=TVT.Q_VAR)[0]
    jp = np.asarray(svj.LogSVPricer().price_chain(cj, pj, variable_type=JVT.Q_VAR,
                                                  year_steps=720)[0])
    assert np.all((tp > 0.0) & (tp < 1.0)) and np.all(np.diff(tp) < 0.0), tp
    np.testing.assert_allclose(tp, jp, rtol=0, atol=1e-10)
    # the reason for the port's default: the JAX package at its own 240
    # diverges on the whole chain's 1m and 3m slices
    chain = svj.get_qv_options_test_chain_data()
    j240 = svj.LogSVPricer().price_chain(chain, pj, variable_type=JVT.Q_VAR)
    for slice_id in ("1m", "3m"):
        p = np.asarray(j240[list(chain.ids).index(slice_id)])
        assert np.any(~np.isfinite(p) | (np.abs(p) > 1e100)), (slice_id, p)


def test_qvar_fourier_forward_vs_analytic():
    _, pt = param_pair(**README_PARAMS)
    ttm = 0.25
    fwd = compute_analytic_qvar(params=pt, ttm=ttm, n_terms=4)
    chain = svt.OptionChain.slice_to_chain(ttm=ttm, forward=fwd,
                                           strikes=np.array([1e-8, 0.5 * fwd]),
                                           optiontypes=np.array(['C', 'C']))
    prices = LogSVPricer(device="cpu").price_chain(chain, pt, variable_type=TVT.Q_VAR)[0]
    assert abs(prices[0] - fwd) / fwd < 0.02
    assert abs(prices[1] - 0.5 * fwd) / fwd < 0.02


def _bsm_log_mgf(phi_grid, ttm, vol):
    """log E[exp(-phi X)] of the BSM log-return under the spot measure."""
    return 0.5 * vol * vol * ttm * phi_grid * (phi_grid + 1.0)


@pytest.mark.parametrize("types", ["C", "P"])
def test_digital_pricer_vs_bsm_digital(types):
    ttm, vol, forward = 0.5, 0.4, 1.0
    strikes = np.linspace(0.7, 1.4, 8)
    optiontypes = np.full(8, types)
    phi = tmgf.get_phi_grid(is_spot_measure=True, vol_scaler=vol * np.sqrt(1.0 / 12.0),
                            device="cpu")
    prices = tmgf.digital_slice_pricer_with_mgf_grid(
        log_mgf_grid=_bsm_log_mgf(phi, ttm, vol), phi_grid=phi, forward=forward,
        strikes=strikes, optiontypes=optiontypes).numpy()
    expected = tbsm.compute_bsm_digital_price(
        torch.tensor(forward, dtype=torch.float64), torch.as_tensor(strikes),
        torch.tensor(ttm, dtype=torch.float64), torch.tensor(vol, dtype=torch.float64),
        optiontypes).numpy()
    np.testing.assert_allclose(prices, expected, atol=1e-6)
    jphi = jmgf.get_phi_grid(is_spot_measure=True, vol_scaler=vol * np.sqrt(1.0 / 12.0))
    jl = Cplx(0.5 * vol * vol * ttm * (jphi.re * jphi.re - jphi.im * jphi.im + jphi.re),
              0.5 * vol * vol * ttm * (2.0 * jphi.re * jphi.im + jphi.im))
    jprices = np.asarray(jmgf.digital_slice_pricer_with_mgf_grid(
        log_mgf_grid=jl, phi_grid=jphi, forward=forward, strikes=strikes,
        optiontypes=optiontypes))
    np.testing.assert_allclose(prices, jprices, rtol=0, atol=1e-12)
    np.testing.assert_allclose(expected, np.asarray(jbsm.compute_bsm_digital_price(
        forward, strikes, ttm, vol, optiontypes)), rtol=0, atol=1e-13)


@pytest.mark.parametrize("variable_type, ttm", [("LOG_RETURN", 0.25), ("SIGMA", 0.25),
                                                ("Q_VAR", 0.02)])
def test_pdfs_match_jax(variable_type, ttm):
    pj, pt = param_pair(**STIFF)
    grid = pt.get_variable_space_grid(variable_type=TVT[variable_type], ttm=ttm, n=50,
                                      n_stdevs=4.5)
    np.testing.assert_array_equal(grid, pj.get_variable_space_grid(
        variable_type=JVT[variable_type], ttm=ttm, n=50, n_stdevs=4.5))
    jpdf = j_logsv_pdfs(params=pj, ttm=ttm, space_grid=grid, variable_type=JVT[variable_type])
    tpdf = t_logsv_pdfs(params=pt, ttm=ttm, space_grid=grid, variable_type=TVT[variable_type],
                        device="cpu")
    assert np.all(np.isfinite(tpdf))
    np.testing.assert_allclose(tpdf, jpdf, rtol=0, atol=1e-10)
    if variable_type != "Q_VAR":   # the QV grid of a 0.02y horizon misses most of the mass
        mass = float(np.sum(tpdf))
        assert 0.9 < mass < 1.1, mass
