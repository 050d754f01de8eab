"""Transform engine and affine-expansion ODE of the PyTorch port against the
JAX package.

* the Phi grid and its Simpson weights: bit for bit;
* ``_nansum_re`` with NaN, overflowing and ordinary lanes: 1e-14 relative;
* the ODE terms (M, L0, L1, h): exact; A(tau) from ``solve_a_ode_grid`` over
  the 1000-point grid at the last BTC maturity, at two parameter sets, one of
  which freezes lanes: 1e-10 relative to max|A| on live lanes, with the same
  set of frozen lanes;
* the Fourier vanilla pricer on one slice: 1e-12 relative to the forward.
"""
import numpy as np
import pytest
import torch
from _torch_port import README_PARAMS, btc_chains

from stochvolmodels_tpu.models.logsv import affine as jafe
from stochvolmodels_tpu.models.logsv.pricer import set_vol_scaler
from stochvolmodels_tpu.ops import mgf as jmgf
from stochvolmodels_tpu.utils.cplx import Cplx
from stochvolmodels_torch.models.logsv import affine as tafe
from stochvolmodels_torch.ops import mgf as tmgf

A_RTOL = 1e-10
# beta=1.5, volvol=3, slow mean reversion: part of the grid diverges before 0.43y
FREEZING = dict(theta=1.0, kappa1=0.5, kappa2=0.5, beta=1.5, volvol=3.0)
BTC = dict(theta=1.0413, kappa1=3.1844, kappa2=3.058, beta=0.1514, volvol=1.8458)


def _cplx_to_np(c: Cplx) -> np.ndarray:
    return np.asarray(c.re) + 1j * np.asarray(c.im)


@pytest.mark.parametrize("is_spot_measure", [True, False])
@pytest.mark.parametrize("vol_scaler", [0.28, float(set_vol_scaler(0.8376, 0.0429)), 0.61])
def test_phi_grid_and_weights_exact(vol_scaler, is_spot_measure):
    gj = jmgf.get_phi_grid(is_spot_measure=is_spot_measure, vol_scaler=vol_scaler)
    gt = tmgf.get_phi_grid(device="cpu", is_spot_measure=is_spot_measure, vol_scaler=vol_scaler)
    np.testing.assert_array_equal(gt.numpy(), _cplx_to_np(gj))
    np.testing.assert_array_equal(tmgf.compute_integration_weights(gt).numpy(),
                                  np.asarray(jmgf.compute_integration_weights(gj)))
    np.testing.assert_array_equal(
        tmgf.compute_integration_weights(gt, is_simpson=False).numpy(),
        np.asarray(jmgf.compute_integration_weights(gj, is_simpson=False)))


@pytest.mark.parametrize("n", [999, 1000])
def test_simpson_even_length_quirk(n):
    np.testing.assert_array_equal(tmgf.simpson_base_weights(n), jmgf.simpson_base_weights(n))


def test_nansum_re_drops_nan_and_overflow():
    rng = np.random.default_rng(3)
    re = rng.uniform(-5.0, 3.0, (6, 400))
    im = rng.uniform(-40.0, 40.0, (6, 400))
    re[0, :5] = np.nan
    im[1, 7:9] = np.nan
    re[2, 10:13] = [800.0, 1e6, np.inf]     # above the exp cap: dropped
    re[3, :] = 650.0                        # large but below the cap: kept
    w = rng.uniform(0.0, 1.0, 400)
    ref = np.asarray(jmgf._nansum_re(Cplx(w, np.zeros_like(w)), Cplx(re, im)))
    out = tmgf._nansum_re(torch.as_tensor(w), torch.complex(torch.as_tensor(re),
                                                            torch.as_tensor(im))).numpy()
    assert np.all(np.isfinite(out))
    np.testing.assert_allclose(out, ref, rtol=1e-14)


@pytest.mark.parametrize("is_spot_measure", [True, False])
def test_ode_terms_exact(is_spot_measure):
    kw = dict(BTC, is_spot_measure=is_spot_measure, vol_backbone_eta=1.1)
    for a, b in zip(tafe.func_a_ode_quadratic_terms(**kw), jafe.func_a_ode_quadratic_terms(**kw)):
        np.testing.assert_array_equal(a, np.asarray(b))


@pytest.mark.parametrize("params,expect_frozen", [(BTC, False), (FREEZING, True)])
def test_solve_a_ode_grid(params, expect_frozen):
    cj, _ = btc_chains()
    vol_scaler = float(set_vol_scaler(0.8376, np.min(cj.ttms)))
    ttm = float(cj.ttms[-1])
    gj = jmgf.get_phi_grid(vol_scaler=vol_scaler)
    zero_j = Cplx(np.zeros(1000), np.zeros(1000))
    aj = _cplx_to_np(jafe.solve_a_ode_grid(gj, zero_j, ttm, year_steps=240, **params))
    gt = tmgf.get_phi_grid(device="cpu", vol_scaler=vol_scaler)
    at = tafe.solve_a_ode_grid(gt, torch.zeros_like(gt), ttm, year_steps=240, **params).numpy()

    frozen_j = np.all((aj.real == 1e6) & (aj.imag == 0.0), axis=1)
    frozen_t = np.all((at.real == 1e6) & (at.imag == 0.0), axis=1)
    np.testing.assert_array_equal(frozen_t, frozen_j)
    assert frozen_j.any() == expect_frozen
    live = ~frozen_j
    scale = np.max(np.abs(aj[live]))
    np.testing.assert_allclose(at[live], aj[live], rtol=0.0, atol=A_RTOL * scale)


@pytest.mark.parametrize("is_spot_measure", [True, False])
def test_vanilla_prices_with_mgf_grid(is_spot_measure):
    """one BTC slice priced from the same A(tau), through both quadratures."""
    cj, _ = btc_chains()
    p = README_PARAMS
    gj = jmgf.get_phi_grid(is_spot_measure=is_spot_measure, vol_scaler=0.2)
    gt = tmgf.get_phi_grid(device="cpu", is_spot_measure=is_spot_measure, vol_scaler=0.2)
    kw = dict(theta=p["theta"], kappa1=p["kappa1"], kappa2=p["kappa2"], beta=p["beta"],
              volvol=p["volvol"], is_spot_measure=is_spot_measure, year_steps=240)
    a = tafe.solve_a_ode_grid(gt, torch.zeros_like(gt), float(cj.ttms[1]), **kw)
    y = p["sigma0"] - p["theta"]
    ys = torch.tensor([1.0, y, y * y, y ** 3, y ** 4], dtype=torch.float64)
    log_mgf = torch.complex(a.real @ ys, a.imag @ ys)
    strikes, types = cj.strikes_ttms[1], cj.optiontypes_ttms[1]
    fwd = float(cj.forwards[1])
    ref = np.asarray(jmgf.vanilla_prices_with_mgf_grid(
        log_mgf_grid=Cplx(log_mgf.real.numpy(), log_mgf.imag.numpy()), phi_grid=gj,
        forwards=fwd, strikes=strikes, optiontypes=types, discfactors=0.99,
        is_spot_measure=is_spot_measure))
    out = tmgf.vanilla_prices_with_mgf_grid(
        log_mgf_grid=log_mgf, phi_grid=gt, forwards=torch.tensor(fwd, dtype=torch.float64),
        strikes=torch.as_tensor(strikes), optiontypes=types, discfactors=0.99,
        is_spot_measure=is_spot_measure).numpy()
    np.testing.assert_allclose(out, ref, rtol=0.0, atol=1e-12 * fwd)
