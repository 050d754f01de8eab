"""The factor-HJM rate core, bases and parameters of the PyTorch port against
the JAX package.

The port keeps its own host-numpy copies of ``utils/rate_core.py``,
``models/factor_hjm/rate_factor_basis.py`` and ``rate_logsv_params.py``; the
same seeded numpy inputs go through both packages on the CPU:

* rate conventions, bond coefficients, Omega, bonds, annuities and swap
  rates (value and gradient) of the three bases: 1e-14 relative;
* the annuity- and T-forward-measure transforms, the QA mean-state ODE and
  the structural panels (scipy ``solve_ivp`` at rtol 1e-3, whose adaptive
  steps follow the right-hand side's rounding): 1e-12;
* ``rate_params_from_numpy`` builds the same factor vols C, covariances M
  and Omega as the JAX package's constructor: 1e-12.

The helpers here (the parameter pair and the USD cube of the factor-HJM
paper) are imported by the other ``test_torch_rates_*`` files.
"""
import numpy as np
import pytest

from stochvolmodels_tpu.models.factor_hjm import rate_factor_basis as jbasis
from stochvolmodels_tpu.models.factor_hjm import rate_logsv_params as jparams
from stochvolmodels_tpu.utils import rate_core as jcore
from stochvolmodels_torch import interop
from stochvolmodels_torch.models.factor_hjm import rate_factor_basis as tbasis
from stochvolmodels_torch.models.factor_hjm import rate_logsv_params as tparams
from stochvolmodels_torch.utils import rate_core as tcore

KEY_TERMS = np.array([1.0, 5.0, 10.0])


def close(a, b, rtol):
    a, b = np.asarray(a, dtype=float), np.asarray(b, dtype=float)
    np.testing.assert_allclose(a, b, rtol=rtol, atol=rtol * max(np.max(np.abs(b)), 1e-300))


def as_numpy_dict(p) -> dict:
    """what ``rate_params_from_numpy`` reads, from a JAX-package
    ``MultiFactRateLogSvParams`` (Nelson-Siegel or CheyettePEND basis)."""
    d = dict(sigma0=p.sigma0, theta=p.theta, kappa1=p.kappa1, kappa2=p.kappa2, q=p.q,
             beta_ts=p.beta.ts, beta_xs=p.beta.xs, volvol_ts=p.volvol.ts,
             volvol_xs=p.volvol.xs, A=p.A, R=p.R, ccy=p.ccy, key_terms=p.basis.key_terms,
             vol_interpolation=p.vol_interpolation)
    if isinstance(p.basis, jbasis.NelsonSiegel):
        d.update(basis="NELSON-SIEGEL", meanrev=p.basis.meanrev)
    else:
        d.update(basis="CHEYETTE-PEND", mrv0=p.basis.mrv0, mrv_delta=p.basis.mrv_delta)
    return d


def rate_param_pair(beta_xs=None, volvol_xs=None, ts=(0.0, 1.0, 2.0, 5.0), sigma0=1.0,
                    theta=1.0, kappa1=1.0, kappa2=1.0, A=(0.01, 0.01, 0.01), R=None,
                    meanrev=0.25):
    """the same Nelson-Siegel parameters in both packages, the port's built by
    ``rate_params_from_numpy`` from the JAX object's arrays."""
    ts = np.asarray(ts, dtype=float)
    if beta_xs is None:
        beta_xs = np.array([[0.25, -0.1, 0.0], [0.1, 0.05, -0.05], [0.0, 0.0, 0.0]])
    if volvol_xs is None:
        volvol_xs = np.array([0.4, 0.3, 0.3])
    pj = jparams.MultiFactRateLogSvParams(
        sigma0=sigma0, theta=theta, kappa1=kappa1, kappa2=kappa2,
        beta=jparams.TermStructure(ts=ts, xs=np.array(beta_xs, dtype=float)),
        volvol=jparams.TermStructure(ts=ts, xs=np.array(volvol_xs, dtype=float)),
        A=np.array(A, dtype=float), R=np.eye(3) if R is None else np.array(R),
        basis=jbasis.NelsonSiegel(meanrev=meanrev, key_terms=KEY_TERMS.copy()), ccy="USD")
    return pj, interop.rate_params_from_numpy(as_numpy_dict(pj))


def usd_cube_pair():
    """the USD swaption cube of 18 Aug 2023 and the paper's fitted
    parameters (papers/sv_for_factor_hjm/calibration_fig_5_6_7.py): (JAX
    chain, JAX params, port chain, port params)."""
    from papers.sv_for_factor_hjm.calibration_fig_5_6_7 import (
        get_calib_rate_logsv_params,
        get_swaption_data,
    )
    from stochvolmodels_torch.data.option_chain import SwOptionChain

    cj = get_swaption_data()
    pj = get_calib_rate_logsv_params()["USD"]
    ct = SwOptionChain(ccy=cj.ccy, ttms=cj.ttms.copy(), tenors=cj.tenors.copy(),
                       ttms_ids=list(cj.ttms_ids), tenors_ids=list(cj.tenors_ids),
                       forwards=[np.array(f) for f in cj.forwards],
                       strikes_ttms=[[np.array(s) for s in row] for row in cj.strikes_ttms],
                       bid_ivs=[[np.array(v) for v in row] for row in cj.bid_ivs],
                       ask_ivs=[[np.array(v) for v in row] for row in cj.ask_ivs],
                       ticker=cj.ticker)
    return cj, pj, ct, interop.rate_params_from_numpy(as_numpy_dict(pj))


# ----------------------------------------------------------------------------
# rate_core
# ----------------------------------------------------------------------------

@pytest.mark.parametrize("t", [-0.5, 0.0, 0.3, 1.0, 2.5, 5.0, 7.0])
def test_bracket_and_pw_const(t):
    ts = np.array([0.0, 1.0, 2.0, 5.0])
    vs = np.array([0.1, 0.2, 0.3])
    assert tcore.bracket(ts, t) == jcore.bracket(ts, t)
    for flat in (False, True):
        if t <= 5.0 or flat:
            assert tcore.pw_const(ts, vs, t, flat, shift=1) == jcore.pw_const(ts, vs, t, flat,
                                                                             shift=1)
    if t > 5.0:
        with pytest.raises(ValueError):
            tcore.bracket(ts, t, throw_if_not_found=True)


@pytest.mark.parametrize("ccy", ["USD", "JPY", "USD_NS"])
def test_discount_factors_and_curve_rates(ccy):
    t = np.linspace(0.0, 12.0, 49)
    close(tcore.df_fast(t, ccy), jcore.df_fast(t, ccy), 1e-14)
    ts_sw = tcore.get_default_swap_term_structure(1.5, 5.0)
    np.testing.assert_array_equal(ts_sw, jcore.get_default_swap_term_structure(1.5, 5.0))
    close(tcore.swap_rate(ccy, 0.5, ts_sw), jcore.swap_rate(ccy, 0.5, ts_sw), 1e-14)
    close(tcore.libor_rate(ccy, 1.25, 0.25), jcore.libor_rate(ccy, 1.25, 0.25), 1e-14)


def test_grids_and_small_helpers():
    ttms = np.array([0.25, 1.0, 2.0, 5.0])
    for nb in (5, 11, 31):
        np.testing.assert_array_equal(tcore.generate_ttms_grid(ttms, nb),
                                      jcore.generate_ttms_grid(ttms, nb))
    assert tcore.get_futures_start_and_pmt(1.0, 0.1) == jcore.get_futures_start_and_pmt(1.0, 0.1)
    assert tcore.to_yearfrac(0.5, 1.75) == jcore.to_yearfrac(0.5, 1.75)
    close(tcore.G(0.3, np.linspace(0, 2, 9), 2.5), jcore.G(0.3, np.linspace(0, 2, 9), 2.5), 1e-14)
    rng = np.random.default_rng(0)
    a2, a1 = rng.normal(size=(7, 3)), rng.uniform(1, 2, size=7)
    close(tcore.divide_mc(a2, a1), jcore.divide_mc(a2, a1), 1e-14)
    close(tcore.prod_mc(a2, a1), jcore.prod_mc(a2, a1), 1e-14)
    close(tcore.bond_grad(a1, a2[0]), jcore.bond_grad(a1, a2[0]), 1e-14)
    n0, d0 = rng.normal(size=7), rng.uniform(1, 2, size=7)
    n1, d1 = rng.normal(size=(7, 3)), rng.normal(size=(7, 3))
    close(tcore.swap_grad(n0, n1, d0, d1), jcore.swap_grad(n0, n1, d0, d1), 1e-14)
    close(tcore.swap_grad(1.0, 2.0, 3.0, 4.0), jcore.swap_grad(1.0, 2.0, 3.0, 4.0), 1e-14)


# ----------------------------------------------------------------------------
# bases
# ----------------------------------------------------------------------------

def basis_pairs():
    return {"cheyette1d": (jbasis.Cheyette1D(meanrev=0.4), tbasis.Cheyette1D(meanrev=0.4)),
            "nelson-siegel": (jbasis.NelsonSiegel(meanrev=0.55, key_terms=np.array([2., 5., 10.])),
                              tbasis.NelsonSiegel(meanrev=0.55, key_terms=np.array([2., 5., 10.]))),
            "cheyette-pend": (jbasis.CheyettePEND(0.2, 0.3, key_terms=np.array([1., 5., 10.])),
                              tbasis.CheyettePEND(0.2, 0.3, key_terms=np.array([1., 5., 10.])))}


@pytest.mark.parametrize("kind", ["cheyette1d", "nelson-siegel", "cheyette-pend"])
def test_bond_coefficients_bonds_annuities_and_swap_rates(kind):
    bj, bt = basis_pairs()[kind]
    for tau in (0.0, 0.25, 1.0, 3.7, 10.0):
        for a, b in zip(bt.bond_coeffs(tau), bj.bond_coeffs(tau)):
            close(a, b, 1e-14)
    rng = np.random.default_rng(1)
    nx, ny = bj.nb_factors, bj.nb_aux_factors
    x, y = 0.01 * rng.normal(size=(5, nx)), 1e-4 * rng.normal(size=(5, ny))
    ts_sw = jcore.get_default_swap_term_structure(1.0, 5.0)
    for m in (0, 1):
        close(bt.bond(0.5, 3.0, x, y, ccy="USD", m=m), bj.bond(0.5, 3.0, x, y, ccy="USD", m=m),
              1e-14)
        close(bt.annuity(0.5, ts_sw, x, y, ccy="USD", m=m),
              bj.annuity(0.5, ts_sw, x, y, ccy="USD", m=m), 1e-14)
    for a, b in zip(bt.swap_rate(0.5, ts_sw, x, y, ccy="USD"),
                    bj.swap_rate(0.5, ts_sw, x, y, ccy="USD")):
        close(a, b, 1e-14)
    close(bt.libor_rate(0.5, 1.0, 1.25, x, y, ccy="USD"),
          bj.libor_rate(0.5, 1.0, 1.25, x, y, ccy="USD"), 1e-14)
    I0 = 0.01 * rng.normal(size=5)
    for a, b in zip(bt.calculate_swap_rate(1.0, x, y, I0, ts_sw, "USD"),
                    bj.calculate_swap_rate(1.0, x, y, I0, ts_sw, "USD")):
        close(a, b, 1e-14)


@pytest.mark.parametrize("kind", ["nelson-siegel", "cheyette-pend"])
def test_basis_functions_generators_and_omega(kind):
    bj, bt = basis_pairs()[kind]
    for tau in (0.0, 0.5, 2.0, 7.5):
        close(bt.get_basis(tau), bj.get_basis(tau), 1e-14)
        close(bt.get_aux_basis(tau), bj.get_aux_basis(tau), 1e-14)
    close(bt.get_generating_matrix(), bj.get_generating_matrix(), 1e-14)
    close(bt.get_aux_generating_matrix(), bj.get_aux_generating_matrix(), 1e-14)
    close(bt.get_matrix_B(), bj.get_matrix_B(), 1e-14)
    rng = np.random.default_rng(2)
    C = rng.normal(size=(3, 3)) * 0.01
    close(bt.calc_Omega(C @ C.T), bj.calc_Omega(C @ C.T), 1e-14)


# ----------------------------------------------------------------------------
# parameters and measure transforms
# ----------------------------------------------------------------------------

def test_term_structure():
    ts = np.array([0.0, 1.0, 2.0, 5.0])
    for flat in (False, True):
        tj = jparams.TermStructure(ts=ts, xs=np.array([0.1, 0.2, 0.3]), flat_extrapol=flat)
        tt = tparams.TermStructure(ts=ts, xs=np.array([0.1, 0.2, 0.3]), flat_extrapol=flat)
        times = np.linspace(0.0, 5.0 if not flat else 6.0, 13)
        np.testing.assert_array_equal(tt.interpolate(times), tj.interpolate(times))
    mj = jparams.TermStructure.create_multi_fact_from_vec(ts, np.array([0.1, -0.2, 0.3]))
    mt = tparams.TermStructure.create_multi_fact_from_vec(ts, np.array([0.1, -0.2, 0.3]))
    np.testing.assert_array_equal(mt.xs, mj.xs)
    np.testing.assert_array_equal(tparams.TermStructure.create_from_scalar(ts, 0.4).xs,
                                  jparams.TermStructure.create_from_scalar(ts, 0.4).xs)
    with pytest.raises(ValueError):
        tparams.TermStructure(ts=ts, xs=np.array([0.1, 0.2]))


@pytest.mark.parametrize("which", ["test", "usd", "pend"])
def test_converter_builds_the_same_factor_vols(which):
    if which == "usd":
        _, pj, _, pt = usd_cube_pair()
    elif which == "test":
        pj, pt = rate_param_pair(R=[[1.0, 0.5, 0.2], [0.5, 1.0, 0.4], [0.2, 0.4, 1.0]])
    else:
        pj0, _ = rate_param_pair()
        pj = jparams.MultiFactRateLogSvParams(
            sigma0=1.0, theta=1.0, kappa1=1.0, kappa2=1.0, beta=pj0.beta, volvol=pj0.volvol,
            A=pj0.A, R=np.eye(3), basis=jbasis.CheyettePEND(0.2, 0.3, KEY_TERMS.copy()),
            ccy="USD")
        pt = interop.rate_params_from_numpy(as_numpy_dict(pj))
    assert type(pt.basis).__name__ == type(pj.basis).__name__
    for name in ("C", "M", "Omega", "A", "R", "ts"):
        close(getattr(pt, name), getattr(pj, name), 1e-12)
    assert pt.beta.xs is not pj.beta.xs and pt.A is not pj.A
    assert (pt.sigma0, pt.theta, pt.kappa1, pt.kappa2, pt.q, pt.ccy) == \
        (pj.sigma0, pj.theta, pj.kappa1, pj.kappa2, pj.q, pj.ccy)


@pytest.mark.parametrize("expiry, tenor", [(1.0, 1.0), (2.0, 5.0), (5.0, 10.0)])
def test_qa_panels_and_transform(expiry, tenor):
    pj, pt = rate_param_pair(volvol_xs=np.array([0.5, 0.4, 0.3]))
    t_grid = jcore.generate_ttms_grid(np.array([1.0, 2.0, 5.0]))
    for a, b in zip(pt.qa_structural_panels(expiry, tenor, t_grid),
                    pj.qa_structural_panels(expiry, tenor, t_grid)):
        close(a, b, 1e-12)
    x0, y0 = np.zeros(3), np.zeros(8)
    for a, b in zip(pt.calc_QA_mean_states(expiry, tenor, t_grid[t_grid <= expiry], x0, y0),
                    pj.calc_QA_mean_states(expiry, tenor, t_grid[t_grid <= expiry], x0, y0)):
        close(a, b, 1e-12)
    for a, b in zip(pt.transform_QA_params(expiry, tenor, t_grid),
                    pj.transform_QA_params(expiry, tenor, t_grid)):
        close(a, b, 1e-12)
    assert pt.check_QA_kappa2(expiry, tenor) == pj.check_QA_kappa2(expiry, tenor)
    with pytest.raises(ValueError):
        pt.qa_structural_panels(expiry + 0.01, tenor, t_grid)


@pytest.mark.parametrize("expiry", [0.5, 1.0, 2.0])
def test_qt_transform(expiry):
    pj, pt = rate_param_pair()
    t_grid = jcore.generate_ttms_grid(np.array([expiry]), nb_pts=21)
    for a, b in zip(pt.transform_QT_params(expiry, expiry, expiry + 0.25, t_grid),
                    pj.transform_QT_params(expiry, expiry, expiry + 0.25, t_grid)):
        close(a, b, 1e-12)
    assert pt.check_QT_kappa2(expiry) == pj.check_QT_kappa2(expiry)


def test_reduce_update_and_dln_vols():
    pj, pt = rate_param_pair()
    rj, rt = pj.reduce(["1y", "2y"]), pt.reduce(["1y", "2y"])
    for name in ("C", "M", "Omega", "ts"):
        close(getattr(rt, name), getattr(rj, name), 1e-14)
    for p in (pj, pt):
        p.update_params(idx=1, A_idx=np.array([0.012, 0.011, 0.009]),
                        beta_idx=np.array([0.2, -0.1, 0.05]), volvol_idx=0.35, kappa1=1.5,
                        sigma0=1.1)
    for name in ("C", "M", "Omega"):
        close(getattr(pt, name), getattr(pj, name), 1e-14)
    rng = np.random.default_rng(4)
    yields = 0.04 + 0.01 * rng.normal(size=(6, 3))
    args = (np.array([0.01, 0.012, 0.011]), yields, np.array([0.1, 0.2, 0.3]), 6)
    close(pt.calc_factor_vols_dln(*args), pj.calc_factor_vols_dln(*args), 1e-14)
    assert tparams.MultiFactRateLogSvParams.get_frac("3m") == 0.25
    with pytest.raises(NotImplementedError):
        tparams.MultiFactRateLogSvParams.get_frac("9y")


def test_single_factor_cheyette_params():
    ts = np.array([0.0, 1.0, 2.0])
    built = []
    for mod, bmod in ((jparams, jbasis), (tparams, tbasis)):
        TS = mod.TermStructure
        built.append(mod.RateLogSvParams(
            sigma0=1.0, theta=1.0, kappa1=1.0, kappa2=0.5,
            alpha=TS(ts=ts, xs=np.array([0.01, 0.012])), b=TS(ts=ts, xs=np.array([0.0, 0.0])),
            beta=TS(ts=ts, xs=np.array([0.2, 0.1])), volvol=TS(ts=ts, xs=np.array([0.4, 0.3])),
            ccy="USD", basis=bmod.Cheyette1D(meanrev=0.3), term=2.0))
    pj, pt = built
    t_grid = jcore.generate_ttms_grid(np.array([1.0, 2.0]))
    for a, b in zip(pt.transform_QA_params(1.0, 2.0, t_grid)[:6],
                    pj.transform_QA_params(1.0, 2.0, t_grid)[:6]):
        close(a, b, 1e-12)
    for a, b in zip(pt.transform_QT_params(1.0, 1.0, 1.25, t_grid),
                    pj.transform_QT_params(1.0, 1.0, 1.25, t_grid)):
        close(a, b, 1e-12)
    assert pt.reduce(1).alpha.xs.tolist() == pj.reduce(1).alpha.xs.tolist()
