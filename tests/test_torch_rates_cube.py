"""The factor-HJM slice as a whole, at full width: the USD swaption cube of 18
Aug 2023 (``papers/sv_for_factor_hjm/calibration_fig_5_6_7.py``: 6 expiries
x 3 tenors x 9 strikes, cut at the parameters' 5y term structure to P = 12
slices) with the paper's fitted 3-factor Nelson-Siegel parameters, through
the JAX package (``engine='f64'``) and the PyTorch port on the CPU:

* ``swaption_chain_to_cube``: the same rows;
* the cube reprice (S = 240 shared RK4 steps, 45 tanh-sinh nodes): prices
  1e-12 absolute, the strike mask equal;
* normal implied vols of those prices (each package's bisection): 1e-9;
* ``swaption_cube_greeks`` (vega, beta_shift, volvol_shift) against JAX's:
  1e-10 relative, or 1e-14 absolute where a greek is ~0; the port's vega
  against a central difference of its own cube in sigma0: 1e-6 relative;
* on a card (skipped here): the captured reprice and greeks equal the
  eager calls bit for bit, and the card's prices the CPU's to 1e-12 x
  forward.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from _torch_port import cuda_device  # noqa: F401
from test_torch_rates_core import usd_cube_pair

import stochvolmodels_torch as svt
from stochvolmodels_tpu.models.factor_hjm import rate_logsv_pricer as jrp
from stochvolmodels_tpu.models.factor_hjm.fast_calibration import (
    swaption_chain_to_cube as j_chain_to_cube,
)
from stochvolmodels_tpu.models.greeks import swaption_cube_greeks as j_cube_greeks
from stochvolmodels_tpu.ops import bachelier as jb
from stochvolmodels_torch.models.factor_hjm import rate_logsv_pricer as trp
from stochvolmodels_torch.models.factor_hjm.fast_calibration import swaption_chain_to_cube
from stochvolmodels_torch.ops import bachelier as tb
from stochvolmodels_torch.ops import graphs

GREEKS = ("vega", "beta_shift", "volvol_shift")


@pytest.fixture(scope="module")
def usd():
    cj, pj, ct, pt = usd_cube_pair()
    rows_j = j_chain_to_cube(cj, max_expiry=5.0)
    rows_t = swaption_chain_to_cube(ct, max_expiry=5.0)
    yield cj, pj, ct, pt, rows_j, rows_t
    import gc
    jax.clear_caches()
    gc.collect()


@pytest.fixture(scope="module")
def priced(usd):
    _, pj, _, pt, (slices, fwds, strikes, _), _ = usd
    fj, mj = jrp.make_swaption_cube_fn(pj, slices, fwds, strikes, engine="f64")
    ft, mt = trp.make_swaption_cube_fn(pt, slices, fwds, strikes, device="cpu")
    ref = np.asarray(fj(jnp.asarray(pj.sigma0), jnp.asarray(pj.beta.xs),
                        jnp.asarray(pj.volvol.xs)))
    ours, dead = ft.price_and_dead(pt.sigma0, pt.beta.xs, pt.volvol.xs)
    return ref, np.asarray(mj), ours.numpy(), mt.numpy(), dead.numpy(), ft


@pytest.fixture(scope="module")
def greeks(usd):
    _, pj, _, pt, (slices, fwds, strikes, _), _ = usd
    gj, mj = j_cube_greeks(pj, slices, fwds, strikes, engine="f64")
    gt, mt = svt.swaption_cube_greeks(pt, slices, fwds, strikes, device="cpu")
    return gj, mj, gt, mt


def test_chain_to_cube_rows_match(usd):
    *_, rows_j, rows_t = usd
    slices, fwds, strikes, ivols = rows_t
    assert len(slices) == 12 and slices == rows_j[0] and fwds == rows_j[1]
    for a, b in zip(strikes + ivols, rows_j[2] + rows_j[3]):
        np.testing.assert_array_equal(a, b)


def test_cube_prices_match(priced):
    ref, mask_j, ours, mask_t, dead, _ = priced
    assert ours.shape == (12, 9) and np.all(np.isfinite(ours))
    np.testing.assert_array_equal(mask_t, mask_j)
    np.testing.assert_allclose(ours, ref, rtol=0, atol=1e-12)
    # the divergence freeze is active on the far tanh-sinh nodes
    assert dead.shape == (12, 45) and dead.any()


def test_cube_normal_ivols_match(usd, priced):
    *_, (slices, fwds, strikes, _), _ = usd
    ref, _, ours, *_ = priced
    for p, (expiry, _) in enumerate(slices):
        kw = dict(ttm=expiry, forward=fwds[p], strikes=strikes[p],
                  optiontypes=np.repeat('C', strikes[p].size), discfactor=1.0)
        iv_j = np.asarray(jb.infer_normal_ivols_from_slice_prices(model_prices=ref[p], **kw))
        iv_t = tb.infer_normal_ivols_from_slice_prices(
            model_prices=torch.as_tensor(ours[p]), **kw).numpy()
        assert np.all(np.isfinite(iv_t))
        np.testing.assert_allclose(iv_t, iv_j, rtol=0, atol=1e-9)


@pytest.mark.parametrize("greek", ("price",) + GREEKS)
def test_cube_greeks_match(greeks, greek):
    gj, mj, gt, mt = greeks
    np.testing.assert_array_equal(mt, np.asarray(mj))
    ref, ours = np.asarray(gj[greek]), gt[greek]
    assert ours.shape == (12, 9)
    gap = np.abs(ours - ref)
    assert np.all((gap <= 1e-10 * np.abs(ref)) | (gap <= 1e-14)), np.max(gap)


def test_vega_matches_a_central_difference(priced, greeks, usd):
    *_, cube = priced
    _, _, gt, _ = greeks
    _, _, _, pt, *_ = usd
    eps = 1e-4
    up = cube(pt.sigma0 + eps, pt.beta.xs, pt.volvol.xs).numpy()
    dn = cube(pt.sigma0 - eps, pt.beta.xs, pt.volvol.xs).numpy()
    fd = (up - dn) / (2.0 * eps)
    np.testing.assert_allclose(gt["vega"], fd, rtol=1e-6, atol=1e-6 * np.max(np.abs(fd)))


@pytest.mark.gpu
def test_captured_cube_and_greeks_equal_eager_and_the_cpu(usd, priced, cuda_device):
    *_, pt, _, (slices, fwds, strikes, _) = usd
    _, _, cpu_prices, *_ = priced
    cube, _ = trp.make_swaption_cube_fn(pt, slices, fwds, strikes, device=cuda_device)
    args = (pt.sigma0, pt.beta.xs, pt.volvol.xs)
    first = cube(*args)
    again = cube(*args)
    with graphs.eager():
        eager = cube(*args)
    assert torch.equal(first, again) and torch.equal(first, eager)
    gap = np.abs(first.cpu().numpy() - cpu_prices)
    assert np.all(gap <= 1e-12 * np.asarray(fwds)[:, None])
    captured, _ = svt.swaption_cube_greeks(pt, slices, fwds, strikes, device=cuda_device)
    with graphs.eager():
        eager_g, _ = svt.swaption_cube_greeks(pt, slices, fwds, strikes, device=cuda_device)
    for g in GREEKS:
        np.testing.assert_array_equal(captured[g], eager_g[g])
