"""Projected Adam (``calibrate_logsv_on_device``) of the port against the
JAX package: two iterations from ``bench.py``'s ``params0`` on the BTC chain
at 60 steps/yr, with the MMA martingale and fourth-moment penalties, agree
in loss and parameters to 1e-9 relative.  The JAX side compiles one
program (~90 s on one core).
"""
import numpy as np
import pytest

from _torch_port import btc_chains

import stochvolmodels_torch as svt
from stochvolmodels_tpu.models.logsv import fast_calibration as jfc
from stochvolmodels_tpu.models.logsv.params import LogSvParams as JaxLogSvParams

PARAMS0 = dict(sigma0=0.8, theta=1.0, kappa1=2.21, kappa2=2.18, beta=0.15, volvol=1.85)
NAMES = ("sigma0", "theta", "kappa1", "kappa2", "beta", "volvol")


@pytest.mark.parametrize("constraints_type", [svt.ConstraintsType.MMA_MARTINGALE_MOMENT4])
def test_adam_iterations_match_jax(constraints_type):
    cj, ct = btc_chains()
    j_type = type(jfc.ConstraintsType.UNCONSTRAINT)[constraints_type.name]
    j_fit, j_loss = jfc.calibrate_logsv_on_device(cj, JaxLogSvParams(**PARAMS0),
                                                  constraints_type=j_type, nb_iters=2,
                                                  year_steps=60)
    fit, loss = svt.calibrate_logsv_on_device(ct, svt.LogSvParams(**PARAMS0),
                                              constraints_type=constraints_type, nb_iters=2,
                                              year_steps=60, device="cpu")
    assert np.isfinite(loss)
    np.testing.assert_allclose(loss, float(j_loss), rtol=1e-9)
    for name in NAMES:
        np.testing.assert_allclose(getattr(fit, name), getattr(j_fit, name), rtol=1e-9)
    assert fit.kappa1 != PARAMS0["kappa1"]
