"""Vol moments, the analytic expected QV, the varswap strikes and the
backbone fit of the PyTorch port against the JAX package (CPU, float64):
1e-12 on the same parameters and chain, the differentiable QV (matrix_exp)
with its gradient included; and the vol-moment generator and density space
grids: exact.
"""
import numpy as np
import pytest
import torch
from _torch_port import README_PARAMS, btc_chains, param_pair

import jax
from stochvolmodels_tpu.config import VariableType as JVT
from stochvolmodels_tpu.models.logsv import vol_moments as jvm
from stochvolmodels_torch import interop
from stochvolmodels_torch.config import VariableType as TVT
from stochvolmodels_torch.models.logsv import vol_moments as tvm

TOL = 1e-12
PARAM_SETS = [README_PARAMS, dict(sigma0=1.0, theta=1.0, kappa1=4.0, kappa2=4.0, beta=0.0,
                                  volvol=1.75),
              dict(sigma0=0.8376, theta=1.0413, kappa1=3.1844, kappa2=3.058, beta=0.1514,
                   volvol=1.8458)]
TTMS = np.array([0.02, 0.1, 0.25, 0.5, 1.0, 2.0])


@pytest.mark.parametrize("kw", PARAM_SETS)
def test_moments_and_qvar(kw):
    pj, pt = param_pair(**kw)
    np.testing.assert_array_equal(pt.get_vol_moments_lambda(), pj.get_vol_moments_lambda())
    for vt in ("LOG_RETURN", "SIGMA", "Q_VAR"):
        np.testing.assert_array_equal(
            pt.get_variable_space_grid(TVT[vt], ttm=0.3, n=40),
            pj.get_variable_space_grid(JVT[vt], ttm=0.3, n=40))
    np.testing.assert_allclose(tvm.compute_vol_moments_t(pt, TTMS),
                               jvm.compute_vol_moments_t(pj, TTMS), rtol=0, atol=TOL)
    np.testing.assert_allclose(tvm.compute_expected_vol_t(pt, TTMS),
                               jvm.compute_expected_vol_t(pj, TTMS), rtol=0, atol=TOL)
    np.testing.assert_allclose(tvm.compute_sqrt_qvar_t(pt, TTMS),
                               jvm.compute_sqrt_qvar_t(pj, TTMS), rtol=0, atol=TOL)
    for ttm in TTMS:
        ref = jvm.compute_analytic_qvar(pj, ttm=float(ttm))
        assert abs(tvm.compute_analytic_qvar(pt, ttm=float(ttm)) - ref) <= TOL
        args = [kw[k] for k in ("sigma0", "theta", "kappa1", "kappa2", "beta", "volvol")]
        jval, jgrad = jax.value_and_grad(
            lambda a: jvm.compute_analytic_qvar_jnp(*a, ttm=float(ttm)))(np.asarray(args))
        targs = torch.tensor(args, dtype=torch.float64, requires_grad=True)
        tval = tvm.compute_analytic_qvar_torch(*targs.unbind(), ttm=float(ttm))
        (tgrad,) = torch.autograd.grad(tval, targs)
        assert abs(float(tval.detach()) - float(jval)) <= TOL
        assert abs(float(tval.detach()) - ref) <= TOL
        np.testing.assert_allclose(tgrad.numpy(), np.asarray(jgrad), rtol=1e-10, atol=TOL)


def test_varswap_strikes_and_backbone_fit():
    cj, ct = btc_chains()
    vj = cj.get_slice_varswap_strikes(floor_with_atm_vols=True)
    vt = ct.get_slice_varswap_strikes(floor_with_atm_vols=True)
    np.testing.assert_array_equal(vt.index, vj.index.to_numpy())
    np.testing.assert_allclose(vt.to_numpy(), vj.to_numpy(), rtol=0, atol=TOL)
    raw_j = cj.get_slice_varswap_strikes(floor_with_atm_vols=False)
    raw_t = ct.get_slice_varswap_strikes(floor_with_atm_vols=False)
    np.testing.assert_allclose(raw_t.to_numpy(), raw_j.to_numpy(), rtol=0, atol=TOL)
    pj, pt = param_pair(**PARAM_SETS[2])
    bj = jvm.fit_model_vol_backbone_to_varswaps(pj, vj)
    bt = tvm.fit_model_vol_backbone_to_varswaps(pt, vt)
    np.testing.assert_array_equal(bt.index, bj.index.to_numpy())
    np.testing.assert_allclose(bt.to_numpy(), bj.to_numpy(), rtol=0, atol=TOL)
    # the port's params read its Series-like backbone, or the JAX package's
    # Series carried over by interop, as the JAX params read theirs
    pj.set_vol_backbone(bj)
    for backbone in (bt, interop.backbone_from_numpy(bj)):
        pt.set_vol_backbone(backbone)
        np.testing.assert_allclose(pt.get_vol_backbone_etas(ct.ttms),
                                   pj.get_vol_backbone_etas(cj.ttms), rtol=0, atol=TOL)
    # the differentiable etas of the varswap-fit calibration
    from stochvolmodels_tpu.models.logsv.pricer import _backbone_etas_jnp
    args = [PARAM_SETS[2][k] for k in ("sigma0", "theta", "kappa1", "kappa2", "beta", "volvol")]
    je = _backbone_etas_jnp(*args, ttms=cj.ttms, varswap_strikes=np.asarray(vj.to_numpy()))
    te = tvm.backbone_etas_torch(*args, ttms=ct.ttms,
                                 varswap_strikes=torch.as_tensor(vt.to_numpy()))
    np.testing.assert_allclose(te.numpy(), np.asarray(je), rtol=0, atol=TOL)
    np.testing.assert_allclose(te.numpy(), bt.to_numpy(), rtol=0, atol=TOL)
