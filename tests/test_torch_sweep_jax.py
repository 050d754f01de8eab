"""The port's batched LogSV LM sweep against the JAX package's.

Two perturbed BTC chains (bid and ask ivols scaled by 0.95 and 1.05), 2 LM
iterations at 180 RK4 steps/yr: each chain's fit and cost from
``stochvolmodels_torch.parallel.sweep.calibrate_logsv_lm_sweep`` equal the
JAX package's ``calibrate_logsv_lm_sweep`` (float64, one-device mesh, so
that nothing pads to the 8 virtual devices) to 1e-6, the JAX test's rtol
(measured 5e-14).  Most of this file's wall is the JAX sweep's compile.
"""
import jax
import numpy as np
from _torch_port import svj, svt
from test_torch_sweep import LOGSV_P0, logsv_vector, perturbed

from stochvolmodels_tpu.parallel import sweep as jsweep
from stochvolmodels_tpu.parallel.mesh import make_path_mesh
from stochvolmodels_torch.parallel import sweep as tsweep


def test_logsv_sweep_equals_the_jax_sweep():
    ours = tsweep.calibrate_logsv_lm_sweep(perturbed(svt), svt.LogSvParams(**LOGSV_P0),
                                           nb_iters=2, year_steps=180, device="cpu")
    ref = jsweep.calibrate_logsv_lm_sweep(perturbed(svj), svj.LogSvParams(**LOGSV_P0),
                                          nb_iters=2, year_steps=180, use_float32=False,
                                          mesh=make_path_mesh(jax.devices()[:1]))
    assert len(ours) == len(ref) == 2
    for (fit, cost), (jfit, jcost) in zip(ours, ref):
        np.testing.assert_allclose(logsv_vector(fit), logsv_vector(jfit), rtol=1e-6)
        np.testing.assert_allclose(cost, jcost, rtol=1e-6)
