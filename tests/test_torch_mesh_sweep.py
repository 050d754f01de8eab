"""``mesh=`` of the port's LM sweeps (``parallel/sweep.py``), on the CPU.

Three perturbed BTC chains (bid and ask ivols x 0.95, 1.00, 1.05) over a
2-device CPU mesh: the batch pads to 4 chains with a copy of the last one,
each device fits two through its own batched program, and the fits gather
on the first device with the padding dropped.

* The LogSV sweep (2 LM iterations at 180 RK4 steps/yr, the port's LM
  parity setting) and the Heston sweep (6 iterations) equal the same sweep
  with ``mesh=None`` to 1e-12 relative, parameters and costs (measured:
  equal bit for bit on the CPU);
* chain 0 of each equals the port's single-chain LM to 1e-10 (the bound of
  ``tests/test_torch_sweep.py``, which holds the single-chain fits to the
  JAX package's);
* a one-device mesh gives the ``mesh=None`` fits bit for bit.
"""
import dataclasses

import numpy as np
import pytest
from _torch_port import svt  # noqa: F401

from stochvolmodels_torch.parallel import sweep as tsweep
from stochvolmodels_torch.parallel.mesh import make_path_mesh

SCALES = (0.95, 1.00, 1.05)
LOGSV_P0 = dict(sigma0=0.8, theta=1.0, kappa1=2.21, kappa2=2.21, beta=0.15, volvol=1.85)
HESTON_P0 = dict(v0=0.8 ** 2, theta=1.3 ** 2, kappa=4.0, volvol=1.5, rho=0.1)


@pytest.fixture(scope="module")
def chains():
    base = svt.get_btc_test_chain_data()
    return [dataclasses.replace(base, bid_ivs=[s * iv for iv in base.bid_ivs],
                                ask_ivs=[s * iv for iv in base.ask_ivs]) for s in SCALES]


def logsv_vector(p, cost):
    return np.array([p.sigma0, p.theta, p.kappa1, p.beta, p.volvol, cost])


def heston_vector(p, cost):
    return np.array([p.v0, p.theta, p.kappa, p.rho, p.volvol, cost])


MODELS = {
    "logsv": (lambda cs, **kw: tsweep.calibrate_logsv_lm_sweep(
                  cs, svt.LogSvParams(**LOGSV_P0), nb_iters=2, year_steps=180, **kw),
              lambda c: svt.calibrate_logsv_lm_on_device(
                  c, svt.LogSvParams(**LOGSV_P0), nb_iters=2, year_steps=180, device="cpu"),
              logsv_vector),
    "heston": (lambda cs, **kw: tsweep.calibrate_heston_lm_sweep(
                   cs, svt.HestonParams(**HESTON_P0), nb_iters=6, **kw),
               lambda c: svt.calibrate_heston_lm(c, svt.HestonParams(**HESTON_P0), nb_iters=6,
                                                 device="cpu"),
               heston_vector),
}


@pytest.mark.parametrize("model", list(MODELS))
def test_sweep_on_a_two_device_mesh_equals_the_unsharded_sweep(chains, model):
    run, single, vector = MODELS[model]
    unsharded = run(chains, device="cpu")
    sharded = run(chains, mesh=make_path_mesh(["cpu", "cpu"]))
    assert len(sharded) == len(chains) == 3
    for (fa, ca), (fb, cb) in zip(unsharded, sharded):
        a, b = vector(fa, ca), vector(fb, cb)
        assert np.all(np.isfinite(a)), a
        np.testing.assert_allclose(b, a, rtol=1e-12, atol=0.0)
    fit0, cost0 = single(chains[0])
    np.testing.assert_allclose(vector(*sharded[0]), vector(fit0, cost0), rtol=1e-10)
    # the fits moved from the start point, and differ across the chains
    assert not np.allclose(vector(*sharded[0])[:5], vector(*sharded[2])[:5])


def test_one_device_mesh_is_the_unsharded_sweep_bit_for_bit(chains):
    run, _, vector = MODELS["heston"]
    a = run(chains[:2], device="cpu")
    b = run(chains[:2], mesh=make_path_mesh(["cpu"]))
    for (fa, ca), (fb, cb) in zip(a, b):
        assert np.array_equal(vector(fa, ca), vector(fb, cb))
