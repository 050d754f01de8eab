"""The fixed-panel swaption slice and cube pricers of the PyTorch port against
the JAX package (``engine='f64'``), on the CPU in float64.

* ``make_swaption_slice_fn`` on three strikes: prices 1e-12 absolute, and
  their reverse-mode gradient in (sigma0, beta_xs, volvol_xs) against
  ``jax.grad``: 1e-10 relative;
* the 3-slice cube of ``tests/test_factor_hjm.py`` (180 steps/yr): prices
  1e-12 absolute and the strike mask equal; each row against the port's own
  slice pricer, 1e-10 (the cube's shared step differs from the slice's);
  the SECOND-order cube against JAX's, 1e-12;
* the divergence freeze under ``torch.func.jvp``: the tangent of A on every
  dead node is exactly 0, and finite on the live ones;
* the entry points kept for the signature: ``engine`` takes 'auto', 'f64'
  and 'df32' (all float64), anything else raises; a ``mesh`` that is not
  a ``PathMesh`` raises ``TypeError`` (a mesh splits the slices:
  tests/test_torch_mesh_cube.py); ``RateLogSVPricer.model_mc_price_chain``
  (as in the JAX package) raises ``NotImplementedError``.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from test_torch_rates_core import rate_param_pair

import stochvolmodels_torch as svt
from stochvolmodels_tpu.models.factor_hjm import rate_logsv_pricer as jrp
from stochvolmodels_tpu.models.logsv.affine import ExpansionOrder as JOrder
from stochvolmodels_tpu.utils.rate_core import generate_ttms_grid
from stochvolmodels_torch.models.factor_hjm import rate_affine_expansion as trae
from stochvolmodels_torch.models.factor_hjm import rate_logsv_pricer as trp
from stochvolmodels_torch.models.logsv.affine import ExpansionOrder

SLICES = [(1.0, 1.0), (1.0, 5.0), (2.0, 5.0)]
STRIKES = [np.array([-0.01, 0.0, 0.01]), np.array([-0.012, -0.006, 0.0, 0.006, 0.012]),
           np.array([-0.01, 0.0, 0.01, 0.02])]
FWDS = [0.0, 0.0, 0.0]


@pytest.fixture(autouse=True, scope="module")
def _clear_jax_caches():
    yield
    import gc
    jax.clear_caches()
    gc.collect()


def jargs(p):
    return jnp.asarray(p.sigma0), jnp.asarray(p.beta.xs), jnp.asarray(p.volvol.xs)


def targs(p, grad=False):
    return tuple(torch.tensor(np.asarray(v, dtype=np.float64), requires_grad=grad)
                 for v in (p.sigma0, p.beta.xs, p.volvol.xs))


def test_slice_prices_and_gradients_match():
    pj, pt = rate_param_pair(beta_xs=np.tile([0.2, -0.1, 0.0], (3, 1)), volvol_xs=np.full(3, 0.5))
    t_grid = generate_ttms_grid(np.array([1.0]))
    strikes = np.array([-0.01, 0.0, 0.01])
    fj = jrp.make_swaption_slice_fn(pj, t_grid, ttm=1.0, tenor=1.0, forward=0.0,
                                    strikes=strikes, engine="f64")
    ft = trp.make_swaption_slice_fn(pt, t_grid, ttm=1.0, tenor=1.0, forward=0.0,
                                    strikes=strikes, device="cpu")
    ref = np.asarray(fj(*jargs(pj)))
    args = targs(pt, grad=True)
    ours = ft(*args)
    np.testing.assert_allclose(ours.detach().numpy(), ref, rtol=0, atol=1e-12)
    grads_j = jax.grad(lambda s0, b, v: fj(s0, b, v)[1], argnums=(0, 1, 2))(*jargs(pj))
    grads_t = torch.autograd.grad(ours[1], args)
    for gt, gj in zip(grads_t, grads_j):
        gj = np.asarray(gj)
        np.testing.assert_allclose(gt.numpy(), gj, rtol=1e-10, atol=1e-10 * np.max(np.abs(gj)))
    assert abs(float(grads_t[0])) > 1e-6


def test_three_slice_cube_matches_and_rows_match_the_slice_pricer():
    pj, pt = rate_param_pair()
    fj, mj = jrp.make_swaption_cube_fn(pj, SLICES, FWDS, STRIKES, year_steps=180, engine="f64")
    ft, mt = trp.make_swaption_cube_fn(pt, SLICES, FWDS, STRIKES, year_steps=180, device="cpu")
    ref = np.asarray(fj(*jargs(pj)))
    ours = ft(*targs(pt)).numpy()
    assert ours.shape == (3, 5)
    np.testing.assert_allclose(ours, ref, rtol=0, atol=1e-12)
    np.testing.assert_array_equal(mt.numpy(), np.asarray(mj))
    np.testing.assert_array_equal(mt.numpy(), [[1, 1, 1, 0, 0], [1, 1, 1, 1, 1], [1, 1, 1, 1, 0]])
    for p, (expiry, tenor) in enumerate(SLICES):
        fn = trp.make_swaption_slice_fn(pt, generate_ttms_grid(np.array([expiry]), nb_pts=31),
                                        ttm=expiry, tenor=tenor, forward=0.0,
                                        strikes=STRIKES[p], device="cpu")
        np.testing.assert_allclose(ours[p, :len(STRIKES[p])], fn(*targs(pt)).numpy(), atol=1e-10)


def test_second_order_cube_matches():
    pj, pt = rate_param_pair()
    for p in (pj, pt):
        p.update_params(idx=0, sigma0=1.05)
    slices, strikes = [(1.0, 1.0), (2.0, 5.0)], [np.array([-0.01, 0.0, 0.01])] * 2
    fj, _ = jrp.make_swaption_cube_fn(pj, slices, [0.0, 0.0], strikes, year_steps=120,
                                      expansion_order=JOrder.SECOND, engine="f64")
    ft, _ = trp.make_swaption_cube_fn(pt, slices, [0.0, 0.0], strikes, year_steps=120,
                                      expansion_order=ExpansionOrder.SECOND, device="cpu")
    first, _ = trp.make_swaption_cube_fn(pt, slices, [0.0, 0.0], strikes, year_steps=120,
                                         device="cpu")
    ours = ft(*targs(pt)).numpy()
    np.testing.assert_allclose(ours, np.asarray(fj(*jargs(pj))), rtol=0, atol=1e-12)
    rel = np.abs(ours - first(*targs(pt)).numpy()) / ours
    assert 1e-5 < np.max(rel) < 5e-3


def test_frozen_nodes_carry_no_tangent():
    pj, pt = rate_param_pair(A=(0.03, 0.03, 0.03))
    cube, _ = trp.make_swaption_cube_fn(pt, [(5.0, 10.0)], [0.0], [np.array([0.0])],
                                        device="cpu")
    sigma0, beta, volvol = cube.primals()
    idx_t, ct, a_interp, lo, hi, r, steps, phi = cube.consts[:8]
    templates = cube.consts[-7:]

    def solve(v):
        beta_i, vv = beta[idx_t], v[idx_t]
        zero = torch.zeros_like(vv)
        k2 = torch.full_like(vv, pt.kappa2)
        series = torch.stack([zero, torch.full_like(vv, pt.kappa1), k2,
                              torch.einsum('ptd,ptd->pt', beta_i, beta_i) + vv ** 2,
                              torch.einsum('ptd,ptd->pt', a_interp, beta_i),
                              torch.einsum('ptd,ptd->pt', a_interp, a_interp), zero], dim=1)
        c = trae.interp_series(series, lo, hi, r)
        c = c.reshape(1, 7, -1, 3).permute(0, 2, 1, 3)
        a0 = torch.zeros((1, phi.shape[0], templates[-1].shape[0]), dtype=torch.complex128)
        return trae.rk4_batch(phi, steps, c, a0, *templates)

    A, dead = solve(volvol)
    assert int(dead.sum()) >= 1
    _, dA = torch.func.jvp(lambda v: solve(v)[0], (volvol,), (torch.ones_like(volvol),))
    assert torch.all(dA[dead] == 0)
    assert torch.all(torch.isfinite(dA[~dead])) and torch.any(dA[~dead] != 0)


@pytest.mark.parametrize("engine", ["auto", "f64", "df32"])
def test_engine_is_accepted_for_the_signature(engine):
    _, pt = rate_param_pair()
    ref, _ = trp.make_swaption_cube_fn(pt, SLICES[:1], FWDS[:1], STRIKES[:1], device="cpu")
    ours, _ = trp.make_swaption_cube_fn(pt, SLICES[:1], FWDS[:1], STRIKES[:1], engine=engine,
                                        device="cpu")
    assert torch.equal(ours(*targs(pt)), ref(*targs(pt)))


def test_unknown_engine_and_a_mesh_raise():
    _, pt = rate_param_pair()
    with pytest.raises(ValueError):
        trp.make_swaption_cube_fn(pt, SLICES[:1], FWDS[:1], STRIKES[:1], engine="f32",
                                  device="cpu")
    with pytest.raises(TypeError):
        trp.make_swaption_cube_fn(pt, SLICES[:1], FWDS[:1], STRIKES[:1], mesh=object(),
                                  device="cpu")


@pytest.mark.parametrize("call", ["model_mc_price_chain"])
def test_entry_points_not_ported_raise(call):
    _, pt = rate_param_pair()
    calls = {
        "model_mc_price_chain": lambda: trp.RateLogSVPricer(device="cpu").model_mc_price_chain(
            None, pt)}
    with pytest.raises(NotImplementedError):
        calls[call]()


def test_unknown_greek_raises():
    _, pt = rate_param_pair()
    for g in ("A_shift", "delta"):
        with pytest.raises(ValueError):
            svt.swaption_cube_greeks(pt, SLICES, FWDS, STRIKES, greeks=(g,), device="cpu")
