"""The exponential-Euler affine solver of the PyTorch port
(``solve_analytic_ode_grid``, the reference's ``is_analytic`` path) and the
single-point entry points of the reference's API, against scipy and the JAX
package (CPU, float64):

* ``solve_analytic_ode_for_a`` against a tight ``scipy.solve_ivp`` at
  Im phi in {0, 2, 15}: atol 2e-4, as ``tests/test_logsv.py`` holds the JAX
  scheme;
* ``compute_logsv_a_mgf_grid(is_analytic=True)`` against the JAX package on
  the 32-point grid of ``tests/test_logsv.py`` and on the BTC chain's
  1000-point Phi grid for its first slice: 1e-10 relative (the JAX package
  multiplies (re, im) pairs, the port complex128: ~1e-12 apart), and within
  2e-4 of the RK4 on the 32-point grid;
* ``p_max`` from the grid's host constants equals the JAX package's read of
  the grid;
* the compatibility wrappers (``_terms_np``, ``func_rhs``, ``func_rhs_jac``,
  ``solve_ode_for_a``, ``solve_analytic_ode_for_a0``,
  ``solve_analytic_ode_grid_phi``) against the JAX package's: 1e-10.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from scipy.integrate import solve_ivp

import stochvolmodels_torch as svt
from stochvolmodels_torch.models.logsv import affine as ta
from stochvolmodels_torch.ops import mgf as tmgf
from stochvolmodels_tpu.models.logsv import affine as ja
from stochvolmodels_tpu.ops import mgf as jmgf
from stochvolmodels_tpu.utils.cplx import Cplx

P = svt.LOGSV_BTC_PARAMS
ODE = dict(theta=P.theta, kappa1=P.kappa1, kappa2=P.kappa2, beta=P.beta, volvol=P.volvol)
CPU = torch.device("cpu")


def _c(z) -> np.ndarray:
    return np.asarray(z.re) + 1j * np.asarray(z.im)


def _rel(a, b) -> float:
    return float(np.max(np.abs(a - b) / np.maximum(1.0, np.abs(b))))


@pytest.mark.parametrize("p_im", [0.0, 2.0, 15.0])
def test_semi_analytic_scheme_matches_scipy(p_im):
    phi, ttm = -0.5 + 1j * p_im, 0.43
    M, L, H = ta._terms_np(phi=phi, psi=0.0, expansion_order=ta.ExpansionOrder.SECOND, **ODE)
    ref = solve_ivp(lambda t, a: ta.func_rhs(t, a, M, L, H), (0.0, ttm),
                    np.zeros(5, dtype=complex), rtol=1e-12, atol=1e-14).y[:, -1]
    ours = ta.solve_analytic_ode_for_a(ttm=ttm, phi=phi, psi=0.0, is_spot_measure=True,
                                       expansion_order=ta.ExpansionOrder.SECOND, device=CPU,
                                       **ODE)
    np.testing.assert_allclose(ours, ref, atol=2e-4)


def test_mgf_grid_on_the_32_point_grid_matches_jax_and_the_rk4():
    p = np.linspace(0.0, 40.0, 32)
    zero_j = Cplx(jnp.zeros(32), jnp.zeros(32))
    kw = dict(ttm=0.25, sigma0=P.sigma0, expansion_order=ja.ExpansionOrder.SECOND, **ODE)
    _, ref = ja.compute_logsv_a_mgf_grid(phi_grid=Cplx(jnp.full(32, -0.5), jnp.asarray(p)),
                                         psi_grid=zero_j, theta_grid=zero_j, is_analytic=True,
                                         **kw)
    phi = torch.complex(torch.full((32,), -0.5, dtype=torch.float64), torch.as_tensor(p))
    zero = torch.zeros(32, dtype=torch.complex128)
    t_kw = dict(kw, expansion_order=ta.ExpansionOrder.SECOND)
    _, ours = ta.compute_logsv_a_mgf_grid(phi_grid=phi, psi_grid=zero, theta_grid=zero,
                                          is_analytic=True, **t_kw)
    assert _rel(ours.numpy(), _c(ref)) < 1e-10
    _, rk4 = ta.compute_logsv_a_mgf_grid(phi_grid=phi, psi_grid=zero, theta_grid=zero, **t_kw)
    np.testing.assert_allclose(ours.numpy(), rk4.numpy(), rtol=0, atol=2e-4)


def test_mgf_grid_on_the_btc_phi_grid_matches_jax():
    chain = svt.get_btc_test_chain_data()
    vs = svt.set_vol_scaler(sigma0=P.sigma0, ttm=np.min(chain.ttms))
    ttm = float(chain.ttms[0])
    phi_j = jmgf.get_phi_grid(vol_scaler=vs)
    zero_j = Cplx(jnp.zeros_like(phi_j.re), jnp.zeros_like(phi_j.re))
    kw = dict(ttm=ttm, sigma0=P.sigma0, is_analytic=True, **ODE)
    a_j, ref = ja.compute_logsv_a_mgf_grid(phi_grid=phi_j, psi_grid=zero_j, theta_grid=zero_j,
                                           **kw)
    phi = tmgf.get_phi_grid(vol_scaler=vs, device=CPU)
    np.testing.assert_array_equal(phi.numpy(), _c(phi_j))
    assert ta.phi_grid_p_max(vs) == float(np.max(np.abs(np.asarray(phi_j.im)))
                                          + np.max(np.abs(np.asarray(phi_j.re))))
    zero = torch.zeros_like(phi)
    a_t, ours = ta.compute_logsv_a_mgf_grid(phi_grid=phi, psi_grid=zero, theta_grid=zero,
                                            vol_scaler=vs, **kw)
    assert _rel(ours.numpy(), _c(ref)) < 1e-10
    assert _rel(a_t.numpy(), _c(a_j)) < 1e-10
    assert np.all(np.isfinite(ours.numpy()))


def test_compat_wrappers_match_jax():
    phi, psi = -0.5 + 3.0j, 0.0
    order = dict(expansion_order=ta.ExpansionOrder.SECOND)
    j_order = dict(expansion_order=ja.ExpansionOrder.SECOND)
    mt, lt, ht = ta._terms_np(phi=phi, psi=psi, **order, **ODE)
    mj, lj, hj = ja._terms_np(phi=phi, psi=psi, **j_order, **ODE)
    for a, b in ((mt, mj), (lt, lj), (ht, hj)):
        np.testing.assert_allclose(a, np.asarray(b), rtol=1e-15, atol=0)
    a0 = np.array([0.1 + 0.2j, -0.3j, 0.05, 0.0, 0.01j])
    np.testing.assert_allclose(ta.func_rhs(0.0, a0, mt, lt, ht),
                               ja.func_rhs(0.0, a0, mj, lj, hj), rtol=1e-14)
    np.testing.assert_allclose(ta.func_rhs_jac(0.0, a0, mt, lt, ht),
                               ja.func_rhs_jac(0.0, a0, mj, lj, hj), rtol=1e-14)
    kw = dict(ttm=0.3, phi=phi, psi=psi, **ODE)
    sol_t = ta.solve_ode_for_a(device=CPU, **order, **kw)
    sol_j = ja.solve_ode_for_a(**j_order, **kw)
    assert _rel(sol_t.y, np.asarray(sol_j.y)) < 1e-10
    np.testing.assert_array_equal(sol_t.t, sol_j.t)
    dense_t = ta.solve_ode_for_a(device=CPU, dense_output=True, **dict(kw, ttm=0.05))
    dense_j = ja.solve_ode_for_a(dense_output=True, **dict(kw, ttm=0.05))
    assert _rel(dense_t.y, dense_j.y) < 1e-10
    assert _rel(dense_t.sol([0.01, 0.033]), dense_j.sol([0.01, 0.033])) < 1e-10
    a_t = ta.solve_analytic_ode_for_a0((0.0, 0.3), phi=phi, psi=psi, device=CPU, **ODE)
    a_j = ja.solve_analytic_ode_for_a0((0.0, 0.3), phi=phi, psi=psi, **ODE)
    assert _rel(a_t, a_j) < 1e-10
    grid = -0.5 + 1j * np.linspace(0.0, 20.0, 16)
    for analytic in (True, False):
        g_t = ta.solve_analytic_ode_grid_phi(grid, np.zeros(16), 0.2, use_analytic_scheme=analytic,
                                             device=CPU, **ODE)
        g_j = ja.solve_analytic_ode_grid_phi(grid, np.zeros(16), 0.2,
                                             use_analytic_scheme=analytic, **ODE)
        assert _rel(g_t, g_j) < 1e-10
