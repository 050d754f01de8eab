"""``mesh=`` of the port's swaption cube and cube LM, on the CPU.

``tests/test_parallel.py``'s sharded-cube fixture: a 3-factor Nelson-Siegel
parameter set, 3 slices x 3 strikes, 3 LM iterations at 24 RK4 steps/yr.

* The frozen and the traced cube on a 2- and a 3-device CPU mesh price as
  the unsharded cube to 1e-12 of the largest price (measured ~5e-15: only
  the tanh-sinh sum's matrix product sees the slice count).
* The cube LM on a 3-device mesh (one slice a device): its cost equals the
  unsharded fit's to 1e-12 relative.  Its iterates are held to
  ``tests/test_parallel.py``'s own bounds (rtol 1e-7, atol 1e-10): the
  third iteration's damped step is ill-conditioned (8 free parameters, 9
  quotes; volvol of segment 1 lands on its bound) and turns the ~1e-15
  rounding gap of the per-slice Jacobian rows into ~3e-11 in beta
  (ROADMAP section 3).
* The port on its 3-device mesh equals the JAX package's fit with
  ``mesh=`` on its 8-device virtual mesh to that test's bounds (cost rtol
  1e-9; ``beta.xs`` and ``volvol.xs`` rtol 1e-7, atol 1e-10).
* A one-device mesh is the unsharded cube and fit, bit for bit.
"""
import numpy as np
import pytest
from _torch_port import svj, svt  # noqa: F401

from stochvolmodels_tpu.models.factor_hjm.fast_calibration import (
    calibrate_rate_logsv_cube_lm_on_device as jax_cube_lm,
)
from stochvolmodels_tpu.parallel.mesh import make_path_mesh as jax_make_path_mesh
from stochvolmodels_torch.models.factor_hjm.fast_calibration import (
    calibrate_rate_logsv_cube_lm_on_device as cube_lm,
)
from stochvolmodels_torch.models.factor_hjm.rate_logsv_pricer import (
    ShardedSwaptionCube,
    make_swaption_cube_fn,
    make_swaption_cube_fn_traced,
)
from stochvolmodels_torch.parallel.mesh import make_path_mesh

TS = np.array([0.0, 1.0, 2.0, 5.0])
SLICES = [(1.0, 1.0), (1.0, 5.0), (2.0, 5.0)]
STRIKES = [np.array([-0.01, 0.0, 0.01])] * 3
FWDS = [0.0] * 3
IVOLS = [np.array([0.011, 0.010, 0.0105])] * 3
LM = dict(nb_iters=3, year_steps=24)


def rate_params(package):
    return package.MultiFactRateLogSvParams(
        sigma0=1.0, theta=1.0, kappa1=1.0, kappa2=1.0,
        beta=package.TermStructure(ts=TS, xs=np.array([[0.25, -0.1, 0.0],
                                                       [0.1, 0.05, -0.05],
                                                       [0.0, 0.0, 0.0]])),
        volvol=package.TermStructure(ts=TS, xs=np.array([0.4, 0.3, 0.3])),
        A=np.array([0.01, 0.01, 0.01]), R=np.eye(3),
        basis=package.NelsonSiegel(meanrev=0.25, key_terms=np.array([1.0, 5.0, 10.0])),
        ccy="USD")


def cpu_mesh(n):
    return make_path_mesh(["cpu"] * n)


@pytest.fixture(scope="module")
def unsharded_fit():
    return cube_lm(rate_params(svt), SLICES, FWDS, STRIKES, IVOLS, device="cpu", **LM)


@pytest.mark.parametrize("build", [make_swaption_cube_fn, make_swaption_cube_fn_traced],
                         ids=["frozen", "traced"])
@pytest.mark.parametrize("n_dev", [2, 3])
def test_sharded_cube_prices_as_the_unsharded_cube(build, n_dev):
    params = rate_params(svt)
    cube, mask = build(params, SLICES, FWDS, STRIKES, year_steps=24, device="cpu")
    sharded, sharded_mask = build(params, SLICES, FWDS, STRIKES, year_steps=24,
                                  mesh=cpu_mesh(n_dev))
    assert isinstance(sharded, ShardedSwaptionCube) and len(sharded.parts) == n_dev
    assert [p.mask.shape[0] for p in sharded.parts] == ([2, 1] if n_dev == 2 else [1, 1, 1])
    a, b = cube(*cube.primals()), sharded(*sharded.primals())
    assert a.shape == b.shape == (3, 3) and bool((mask == sharded_mask).all())
    assert float((a - b).abs().max()) <= 1e-12 * float(a.abs().max()), (a, b)
    # the nodes freeze alike; the parts' keys are the whole cube's at their slice counts
    assert bool((cube.price_and_dead(*cube.primals())[1]
                 == sharded.price_and_dead(*sharded.primals())[1]).all())
    assert sharded.full.key == cube.key
    assert [p.key[0] for p in sharded.parts] == [p.mask.shape[0] for p in sharded.parts]


def test_cube_lm_on_a_three_device_mesh_equals_the_unsharded_fit(unsharded_fit):
    fit, cost = unsharded_fit
    sharded, sharded_cost = cube_lm(rate_params(svt), SLICES, FWDS, STRIKES, IVOLS,
                                    mesh=cpu_mesh(3), **LM)
    np.testing.assert_allclose(sharded_cost, cost, rtol=1e-12)
    np.testing.assert_allclose(sharded.beta.xs, fit.beta.xs, rtol=1e-7, atol=1e-10)
    np.testing.assert_allclose(sharded.volvol.xs, fit.volvol.xs, rtol=1e-7, atol=1e-10)
    # the fit moved from the start point
    assert not np.allclose(fit.beta.xs, rate_params(svt).beta.xs)


def test_cube_lm_on_a_mesh_matches_the_jax_sharded_fit():
    jfit, jcost = jax_cube_lm(rate_params(svj), SLICES, FWDS, STRIKES, IVOLS,
                              mesh=jax_make_path_mesh(), **LM)
    fit, cost = cube_lm(rate_params(svt), SLICES, FWDS, STRIKES, IVOLS, mesh=cpu_mesh(3), **LM)
    np.testing.assert_allclose(cost, jcost, rtol=1e-9)
    np.testing.assert_allclose(fit.beta.xs, jfit.beta.xs, rtol=1e-7, atol=1e-10)
    np.testing.assert_allclose(fit.volvol.xs, jfit.volvol.xs, rtol=1e-7, atol=1e-10)


def test_one_device_mesh_is_the_unsharded_fit_bit_for_bit(unsharded_fit):
    fit, cost = unsharded_fit
    one, one_cost = cube_lm(rate_params(svt), SLICES, FWDS, STRIKES, IVOLS, mesh=cpu_mesh(1), **LM)
    assert one_cost == cost
    assert np.array_equal(one.beta.xs, fit.beta.xs) and np.array_equal(one.volvol.xs,
                                                                        fit.volvol.xs)
    cube, _ = make_swaption_cube_fn(rate_params(svt), SLICES, FWDS, STRIKES, year_steps=24,
                                    mesh=cpu_mesh(1))
    assert not isinstance(cube, ShardedSwaptionCube)


def test_a_mesh_that_is_not_a_path_mesh_raises():
    with pytest.raises(TypeError):
        make_swaption_cube_fn(rate_params(svt), SLICES, FWDS, STRIKES, mesh=object())
