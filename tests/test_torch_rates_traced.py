"""The traced structural panels, the traced swaption cube and its six greeks
of the PyTorch port against the JAX package (``engine='f64'``), on the CPU
in float64, at the fixtures of ``tests/test_qa_traced.py`` (segment-varying
A, beta and volvol, a correlated R):

* ``build_qa_geometry``: every array equal;
* ``factor_vols_traced``, the mean states and the six Riccati panels of
  four slices (31 grid points, n_sub = 2): 1e-12 relative;
* the traced cube of four slices x five strikes (48 steps/yr): 1e-12
  absolute, the strike mask equal;
* ``swaption_cube_greeks(traced=True)``, all six greeks, on the two-slice
  finite-difference fixture (24 steps/yr): 1e-10 relative, or 1e-14
  absolute where a greek is ~0;
* the port's traced cube (n_sub = 4) against its frozen cube on a tight
  ``solve_ivp`` (rtol 1e-11): 5e-9, the bound of ``test_qa_traced.py``;
  the port's A-shift greek against a central difference of its own traced
  cube.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from test_torch_rates_core import rate_param_pair

import stochvolmodels_torch as svt
from stochvolmodels_tpu.models.factor_hjm import qa_traced as jq
from stochvolmodels_tpu.models.factor_hjm import rate_logsv_pricer as jrp
from stochvolmodels_tpu.models.greeks import swaption_cube_greeks as j_cube_greeks
from stochvolmodels_torch.models.factor_hjm import qa_traced as tq
from stochvolmodels_torch.models.factor_hjm import rate_logsv_pricer as trp

R = np.array([[1.0, 0.3, 0.1], [0.3, 1.0, 0.2], [0.1, 0.2, 1.0]])
BETA = np.array([[0.3, -0.15, 0.05], [0.2, -0.1, 0.0], [0.15, -0.05, 0.0]])
VOLVOL = np.array([0.45, 0.35, 0.30])
A = np.array([[0.009, 0.010, 0.011], [0.010, 0.011, 0.012], [0.011, 0.012, 0.013]])
SLICES = [(1.0, 1.0), (1.0, 5.0), (2.0, 5.0), (2.0, 10.0)]
FWDS = [0.0435, 0.0421, 0.0415, 0.0405]
STRIKES = [fwd + np.array([-0.01, -0.005, 0.0, 0.005, 0.01]) for fwd in FWDS]
SLICES_FD = [(1.0, 1.0), (2.0, 10.0)]
FWDS_FD = [0.0435, 0.0405]
STRIKES_FD = [fwd + np.array([-0.01, 0.0, 0.01]) for fwd in FWDS_FD]
GREEKS = ("vega", "A_shift", "beta_shift", "volvol_shift", "kappa1", "kappa2")


def params_pair():
    """the parameters of ``tests/test_qa_traced.py::make_params`` in both
    packages."""
    return rate_param_pair(beta_xs=BETA, volvol_xs=VOLVOL, sigma0=1.05, kappa1=0.8,
                           kappa2=1.2, A=A, R=R)


def f64(a):
    return torch.tensor(np.asarray(a, dtype=np.float64))


def jargs(p):
    return (jnp.asarray(p.sigma0), jnp.asarray(p.A), jnp.asarray(p.beta.xs),
            jnp.asarray(p.volvol.xs), jnp.asarray(p.kappa1), jnp.asarray(p.kappa2))


def rel_close(ours, ref, rtol):
    ref = np.asarray(ref)
    np.testing.assert_allclose(np.asarray(ours), ref, rtol=0,
                               atol=rtol * max(float(np.max(np.abs(ref))), 1e-300))


@pytest.fixture(scope="module")
def geometry():
    pj, pt = params_pair()
    yield pj, pt, jq.build_qa_geometry(pj, SLICES), tq.build_qa_geometry(pt, SLICES)
    import gc
    jax.clear_caches()
    gc.collect()


def test_geometry_arrays_equal(geometry):
    _, _, gj, gt = geometry
    for f in dataclasses.fields(gj):
        np.testing.assert_array_equal(np.asarray(getattr(gt, f.name)),
                                      np.asarray(getattr(gj, f.name)), err_msg=f.name)
    assert gt.BX_st.shape[0] == 60 and gt.n_sub == 2


def test_factor_vols_and_mean_states_match(geometry):
    pj, pt, gj, gt = geometry
    C_j = jq.factor_vols_traced(gj, jnp.asarray(pj.A))
    rel_close(tq.factor_vols_traced(gt, f64(pt.A)).numpy(), C_j, 1e-12)
    ref = jq.qa_mean_states_traced(gj, jnp.asarray(pj.A), jnp.asarray(pj.kappa1),
                                   jnp.asarray(pj.kappa2), jnp.asarray(pj.theta),
                                   jnp.asarray(pj.sigma0), jnp.asarray(pj.beta.xs))
    ours = tq.qa_mean_states_traced(gt, f64(pt.A), pt.kappa1, pt.kappa2, pt.theta, pt.sigma0,
                                    f64(pt.beta.xs))
    for o, r in zip(ours, ref):
        assert o.shape == np.asarray(r).shape
        rel_close(o.numpy(), r, 1e-12)


@pytest.fixture(scope="module")
def panels(geometry):
    pj, pt, gj, gt = geometry
    ref = jq.qa_panels_traced(gj, jnp.asarray(pj.A), jnp.asarray(pj.kappa1),
                              jnp.asarray(pj.kappa2), jnp.asarray(pj.theta),
                              jnp.asarray(pj.sigma0), jnp.asarray(pj.beta.xs),
                              jnp.asarray(pj.volvol.xs))
    ours = tq.qa_panels_traced(gt, f64(pt.A), pt.kappa1, pt.kappa2, pt.theta, pt.sigma0,
                               f64(pt.beta.xs), f64(pt.volvol.xs))
    return ref, ours


@pytest.mark.parametrize("i", range(6), ids=["a", "kappa0", "kappa1", "kappa2", "beta",
                                              "volvol"])
def test_six_panels_match(panels, i):
    ref, ours = panels
    assert ours[i].shape[:2] == (4, 31)
    rel_close(ours[i].numpy(), ref[i], 1e-12)


def test_traced_cube_matches(geometry):
    pj, pt, _, _ = geometry
    fj, mj = jrp.make_swaption_cube_fn_traced(pj, SLICES, FWDS, STRIKES, year_steps=48,
                                              engine="f64")
    ft, mt = trp.make_swaption_cube_fn_traced(pt, SLICES, FWDS, STRIKES, year_steps=48,
                                              device="cpu")
    ref = np.asarray(fj(*jargs(pj)))
    ours = ft(*ft.primals()).numpy()
    np.testing.assert_array_equal(mt.numpy(), np.asarray(mj))
    assert ours.shape == (4, 5) and np.all(np.isfinite(ours))
    np.testing.assert_allclose(ours, ref, rtol=0, atol=1e-12)


@pytest.fixture(scope="module")
def traced_greeks():
    pj, pt = params_pair()
    gj, mj = j_cube_greeks(pj, SLICES_FD, FWDS_FD, STRIKES_FD, greeks=GREEKS, traced=True,
                           year_steps=24, engine="f64")
    gt, mt = svt.swaption_cube_greeks(pt, SLICES_FD, FWDS_FD, STRIKES_FD, greeks=GREEKS,
                                      traced=True, year_steps=24, device="cpu")
    return gj, mj, gt, mt


@pytest.mark.parametrize("greek", ("price",) + GREEKS)
def test_six_traced_greeks_match(traced_greeks, greek):
    gj, mj, gt, mt = traced_greeks
    np.testing.assert_array_equal(mt, np.asarray(mj))
    ref, ours = np.asarray(gj[greek]), gt[greek]
    assert ours.shape == (2, 3) and np.all(np.isfinite(ours))
    gap = np.abs(ours - ref)
    assert np.all((gap <= 1e-10 * np.abs(ref)) | (gap <= 1e-14)), np.max(gap)


def test_traced_cube_within_5e9_of_the_tight_frozen_cube():
    _, pt = params_pair()
    frozen, mask = trp.make_swaption_cube_fn(pt, SLICES, FWDS, STRIKES, year_steps=48,
                                             panel_rtol=1e-11, panel_atol=1e-13, device="cpu")
    traced, mask_t = trp.make_swaption_cube_fn_traced(pt, SLICES, FWDS, STRIKES,
                                                      year_steps=48, n_sub=4, device="cpu")
    px_f = frozen(pt.sigma0, pt.beta.xs, pt.volvol.xs).numpy()
    px_t = traced(*traced.primals()).numpy()
    assert torch.equal(mask, mask_t)
    np.testing.assert_allclose(px_t, px_f, rtol=0, atol=5e-9)


def test_a_shift_greek_is_the_derivative_of_the_traced_cube():
    _, pt = params_pair()
    greeks, _ = svt.swaption_cube_greeks(pt, SLICES_FD, FWDS_FD, STRIKES_FD,
                                         greeks=("A_shift",), traced=True, year_steps=24,
                                         device="cpu")
    cube, _ = trp.make_swaption_cube_fn_traced(pt, SLICES_FD, FWDS_FD, STRIKES_FD,
                                               year_steps=24, device="cpu")
    h = 1e-6
    sigma0, A_xs, *rest = cube.primals()
    fd = (cube(sigma0, A_xs + h, *rest) - cube(sigma0, A_xs - h, *rest)).numpy() / (2.0 * h)
    np.testing.assert_allclose(greeks["A_shift"], fd, rtol=1e-6, atol=1e-8)


def test_traced_arguments_default_to_the_parameters():
    _, pt = params_pair()
    cube, _ = trp.make_swaption_cube_fn_traced(pt, SLICES_FD, FWDS_FD, STRIKES_FD,
                                               year_steps=24, device="cpu")
    explicit = cube(pt.sigma0, pt.A, pt.beta.xs, pt.volvol.xs, pt.kappa1, pt.kappa2)
    assert torch.equal(cube(*cube.primals()), explicit)
    assert cube.nb_steps == 48 and cube.key[2] == 60
