"""The rates Riccati RK4 and the futures convexity adjustment of the PyTorch
port against the JAX package, on the CPU in float64.

* inside the port: the template stage RHS against the scatter-built
  (M, L, H) RHS, n = 3 and 5: 1e-13 relative;
* the host-made stage brackets against ``jnp.interp`` on knots, midpoints
  and both clamped ends: 1e-15 relative, the ends exact; linear in the
  series under ``torch.func.jvp``;
* ``solve_a_ode_grid`` and ``compute_logsv_a_mgf_grid`` (FIRST and SECOND
  order, SWAP and FUTURES coefficients, zero and non-zero start) and
  ``solve_a_ode_grid_batch`` on the tanh-sinh nodes: log MGF and A to 1e-12
  relative on live nodes, and the dead-node masks (the sticky divergence
  freeze) equal, on a 5y x 10y slice of the USD cube that has dead nodes;
* the convexity-adjustment pieces (Nelson-Siegel bond coefficients, the
  closed-form linear block, the h-system RK4): 1e-12 of each panel's scale
  (``1 - e^{-x}(1 + x + x^2/2)`` cancels at short tau, so the two libraries'
  ``exp`` part there by ~1e-14 absolute); the scalar panels, sums of
  products of both signs: 1e-12 of the sum of the products' magnitudes.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from test_torch_rates_core import close, rate_param_pair, usd_cube_pair

from stochvolmodels_tpu.models.factor_hjm import conv_adj as jconv
from stochvolmodels_tpu.models.factor_hjm import rate_affine_expansion as jrae
from stochvolmodels_tpu.models.factor_hjm.double_exp_pricer import tanh_sinh_nodes
from stochvolmodels_tpu.models.logsv.affine import ExpansionOrder as JOrder
from stochvolmodels_tpu.utils.cplx import Cplx
from stochvolmodels_tpu.utils.rate_core import generate_ttms_grid
from stochvolmodels_torch.models.factor_hjm import conv_adj as tconv
from stochvolmodels_torch.models.factor_hjm import rate_affine_expansion as trae
from stochvolmodels_torch.models.logsv.affine import ExpansionOrder

ORDERS = {"first": (JOrder.FIRST, ExpansionOrder.FIRST),
          "second": (JOrder.SECOND, ExpansionOrder.SECOND)}
T = lambda a: torch.as_tensor(np.asarray(a, dtype=np.float64))


@pytest.fixture(autouse=True, scope="module")
def _clear_jax_caches():
    yield
    import gc
    jax.clear_caches()
    gc.collect()


def phi_pair(p):
    p = np.asarray(p, dtype=float)
    return (Cplx(jnp.full(p.shape, -0.5), jnp.asarray(p)),
            torch.complex(torch.full(p.shape, -0.5, dtype=torch.float64), T(p)))


def as_complex(c: Cplx) -> np.ndarray:
    return np.asarray(c.re) + 1j * np.asarray(c.im)


def dead_of(A: np.ndarray) -> np.ndarray:
    """the nodes frozen by the divergence freeze: A = (DEAD_RE, 0, ...)."""
    return (A[..., 0] == complex(trae.DEAD_RE, 0.0)) & np.all(A[..., 1:] == 0.0, axis=-1)


def assert_live_close(ours: np.ndarray, ref: np.ndarray, rtol: float):
    """equal dead masks, and the live nodes within ``rtol`` of their scale."""
    dead = dead_of(ref)
    np.testing.assert_array_equal(dead_of(ours), dead)
    live_o, live_r = ours[~dead], ref[~dead]
    scale = max(np.max(np.abs(live_r)), 1e-300)
    np.testing.assert_allclose(live_o, live_r, rtol=rtol, atol=rtol * scale)


def qa_coeffs(params, expiry, tenor, nb_pts=31):
    """the swaption slice's coefficient series (numpy), as the DE pricer builds them."""
    t_grid = generate_ttms_grid(np.array([expiry]), nb_pts=nb_pts)
    a, k0, k1, k2, beta, volvol, _ = params.transform_QA_params(expiry=expiry, tenor=tenor,
                                                                 t_grid=t_grid)
    z = np.zeros_like(k0)
    return dict(times=t_grid, a0=a, a1=z, kappa0=k0, kappa1=k1, kappa2=k2, beta=beta,
                volvol=volvol, b=z)


@pytest.mark.parametrize("n", [3, 5])
def test_template_rhs_matches_scatter_rhs(n):
    rng = np.random.default_rng(0)
    scales = np.array([0.5, 1.0, 1.0, 0.3, 0.2, 0.1, 0.05])
    q = 1.07
    templates = trae.templates_on(q, n, "cpu")
    for _ in range(3):
        c = T(rng.normal(size=7) * scales)
        _, phi = phi_pair(np.linspace(0.0, 40.0, 11))
        A = torch.complex(T(rng.normal(size=(11, n)) * 0.3), T(rng.normal(size=(11, n)) * 0.3))
        r1 = trae._ode_rhs(A, *trae._rates_ode_terms(q, c, phi, n))
        r2 = trae._ode_rhs_from_templates(A, phi, c, templates)
        np.testing.assert_allclose(r2.numpy(), r1.numpy(), rtol=1e-13, atol=1e-14)


def test_stage_brackets_match_jnp_interp():
    times = generate_ttms_grid(np.array([1.0, 2.0, 5.0]), nb_pts=11)
    rng = np.random.default_rng(1)
    series = rng.normal(size=(7, times.size))
    t_eval, _ = trae.stage_times(5.0, 240)
    x = np.concatenate([t_eval.ravel(), times, 0.5 * (times[1:] + times[:-1]),
                        [-1e-17, -1.0, 5.0 + 1e-15, 9.0]])
    ref = np.stack([np.asarray(jnp.interp(jnp.asarray(x), jnp.asarray(times), jnp.asarray(s)))
                    for s in series])
    si = [torch.as_tensor(a) for a in trae.stage_brackets(x, times)]
    ours = trae.interp_series(T(series), *si).numpy()
    np.testing.assert_allclose(ours, ref, rtol=1e-15, atol=1e-15)
    ends = (x < times[0]) | (x > times[-1])
    np.testing.assert_array_equal(ours[:, ends], ref[:, ends])
    tangent = T(rng.normal(size=series.shape))
    _, dout = torch.func.jvp(lambda s: trae.interp_series(s, *si), (T(series),), (tangent,))
    np.testing.assert_allclose(dout.numpy(), trae.interp_series(tangent, *si).numpy(),
                               rtol=1e-15, atol=1e-15)


@pytest.mark.parametrize("order", ["first", "second"])
def test_log_mgf_matches_on_a_swaption_slice(order):
    jo, to = ORDERS[order]
    pj, pt = rate_param_pair()
    kw = qa_coeffs(pj, 2.0, 5.0)
    p_nodes, _ = tanh_sinh_nodes()
    phij, phit = phi_pair(p_nodes)
    for sigma0 in (1.0, 1.05):
        aj, mj = jrae.compute_logsv_a_mgf_grid(ttm=2.0, phi_grid=phij, sigma0=sigma0, q=1.0,
                                               expansion_order=jo, **kw)
        at, mt = trae.compute_logsv_a_mgf_grid(ttm=2.0, phi_grid=phit, sigma0=sigma0, q=1.0,
                                               expansion_order=to, **kw)
        assert_live_close(at.numpy(), as_complex(aj), 1e-12)
        live = ~dead_of(as_complex(aj))
        np.testing.assert_allclose(mt.numpy()[live], as_complex(mj)[live], rtol=1e-12)


def test_futures_coefficients_and_a_nonzero_start():
    pj, pt = rate_param_pair(beta_xs=np.tile([0.1, -0.05, 0.0], (3, 1)),
                             volvol_xs=np.full(3, 0.3))
    t_grid = generate_ttms_grid(np.array([1.0]), nb_pts=21)
    a, eta, k0, k1, k2, beta, volvol = pj.transform_QT_params(1.0, 1.0, 1.25, t_grid)
    rng = np.random.default_rng(2)
    h1 = 0.01 * rng.normal(size=k0.size)
    a0 = a + np.einsum('i,ij->ij', h1, beta)
    kw = dict(times=t_grid, a0=a0, a1=h1 * volvol, kappa0=k0, kappa1=k1, kappa2=k2, beta=beta,
              volvol=volvol, b=np.einsum('ij,ij->i', a0, eta) + 0.5 * np.einsum('ij,ij->i', a0, a0))
    phij, phit = phi_pair(np.geomspace(1e-3, 300.0, 17))
    start = 0.01 * (rng.normal(size=(17, 3)) + 1j * rng.normal(size=(17, 3)))
    for a_t0 in (None, start):
        aj = jrae.solve_a_ode_grid(phij, 1.0, 1.0, underlying_type=jrae.UnderlyingType.FUTURES,
                                   a_t0=None if a_t0 is None else Cplx(jnp.asarray(a_t0.real),
                                                                       jnp.asarray(a_t0.imag)),
                                   **kw)
        at = trae.solve_a_ode_grid(phit, 1.0, 1.0, underlying_type=trae.UnderlyingType.FUTURES,
                                   a_t0=None if a_t0 is None else torch.as_tensor(a_t0), **kw)
        assert_live_close(at.numpy(), as_complex(aj), 1e-12)


@pytest.mark.parametrize("order", ["first", "second"])
def test_batch_solver_and_dead_masks_on_the_usd_5y_slice(order):
    jo, to = ORDERS[order]
    _, pj, _, _ = usd_cube_pair()
    S = 240
    p_nodes, _ = tanh_sinh_nodes()
    coeffs, dts = [], []
    for expiry, tenor in ((1.0, 2.0), (5.0, 10.0)):
        kw = qa_coeffs(pj, expiry, tenor)
        series = np.asarray(jrae._scalar_series(underlying_type=jrae.UnderlyingType.SWAP, **kw))
        t_eval, dt = trae.stage_times(expiry, S)
        c = np.stack([np.asarray(jnp.interp(jnp.asarray(t_eval.ravel()), jnp.asarray(kw["times"]),
                                            jnp.asarray(s))) for s in series])
        coeffs.append(np.moveaxis(c.reshape(7, S, 3), 0, 1))
        dts.append(dt)
    coeffs = np.stack(coeffs)
    phij, phit = phi_pair(p_nodes)
    aj = as_complex(jrae.solve_a_ode_grid_batch(phij, jnp.asarray(dts), jnp.asarray(coeffs),
                                                q=pj.theta, expansion_order=jo))
    at = trae.solve_a_ode_grid_batch(phit, np.asarray(dts), coeffs, q=pj.theta,
                                     expansion_order=to).numpy()
    assert dead_of(aj)[1].sum() >= 1, "the 5y x 10y slice should have dead nodes"
    assert_live_close(at, aj, 1e-12)


def test_series_reduction_matches():
    pj, _ = rate_param_pair()
    kw = qa_coeffs(pj, 1.0, 5.0)
    for ut in ("SWAP", "FUTURES"):
        kw_f = dict(kw, a1=0.01 * np.ones_like(kw["kappa0"]), b=0.002 * np.ones_like(kw["kappa0"]))
        ref = jrae._scalar_series(underlying_type=getattr(jrae.UnderlyingType, ut), **kw_f)
        ours = trae._scalar_series(underlying_type=getattr(trae.UnderlyingType, ut),
                                   device="cpu", **kw_f)
        close(ours.numpy(), np.asarray(ref), 1e-14)


# ----------------------------------------------------------------------------
# futures convexity adjustment
# ----------------------------------------------------------------------------

@pytest.mark.parametrize("is_sofr", [False, True])
def test_conv_adj_blocks_and_panels(is_sofr):
    pj, pt = rate_param_pair()
    taus = np.linspace(0.0, 1.5, 13)
    for a, b in zip(tconv.ns_bond_coeffs(0.25, taus, device="cpu"),
                    jconv.ns_bond_coeffs(0.25, taus)):
        close(a.numpy(), np.asarray(b), 1e-12)
    for a, b in zip(tconv.conv_adj_linear_block(0.25, taus, 0.25, is_sofr, device="cpu"),
                    jconv.conv_adj_linear_block(0.25, taus, 0.25, is_sofr)):
        close(a.numpy(), np.asarray(b), 1e-12)
    # each panel is a sum of products of both signs: hold it to 1e-12 of the
    # sum of the products' magnitudes
    B1, B2 = (np.abs(np.asarray(b)) for b in jconv.conv_adj_linear_block(0.25, taus, 0.25,
                                                                          is_sofr))
    idx = np.clip(np.searchsorted(pj.ts[1:], 1.5 - taus, side="left"), 0, pj.ts.size - 2)
    beta, volvol = np.abs(pj.beta.xs[idx]), pj.volvol.xs[idx]
    scales = (np.einsum('kd,kde,ke->k', B1, np.abs(pj.M[idx]), B1),
              np.einsum('kd,kde,ke->k', B1, np.abs(pj.C[idx]), beta),
              np.einsum('km,km->k', B2, np.abs(pj.Omega[idx])),
              np.einsum('kd,kd->k', beta, beta) + volvol ** 2)
    for a, b, scale in zip(tconv.conv_adj_scalar_panels(pt, 1.5, 0.25, is_sofr, taus,
                                                        device="cpu"),
                           jconv.conv_adj_scalar_panels(pj, 1.5, 0.25, is_sofr, taus), scales):
        assert np.all(np.abs(a.numpy() - np.asarray(b)) <= 1e-12 * scale)


@pytest.mark.parametrize("order", ["first", "zero"])
def test_conv_adj_h_system(order):
    pj, pt = rate_param_pair()
    jo = JOrder.FIRST if order == "first" else JOrder.ZERO
    to = ExpansionOrder.FIRST if order == "first" else ExpansionOrder.ZERO
    tj, hj = jconv.solve_conv_adj(pj, 1.0, 0.25, 1.0, False, jo, steps_per_year=200)
    tt, ht = tconv.solve_conv_adj(pt, 1.0, 0.25, 1.0, False, to, steps_per_year=200,
                                  device="cpu")
    np.testing.assert_array_equal(tt, tj)
    close(ht.numpy(), np.asarray(hj), 1e-12)
