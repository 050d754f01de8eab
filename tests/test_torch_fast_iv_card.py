"""The fast implied vol's kernel (``csrc/fast_iv.cu``) on a card.

This file imports no JAX, so that it runs where the card is
(``python3 -m pytest --noconftest -s tests/test_torch_fast_iv_card.py``).
Every test is marked ``gpu`` and skips without a CUDA device: the kernel has
no CPU mode.

* The kernel against the plain version (the torch ops of ``_fast_iv_impl``
  and ``_inverse_vega_and_partials`` on the same card), at the BTC chain's
  padded panel and at calls and puts from deep in to deep out of the money
  with unbracketed, NaN and tiny-ttm quotes: the vol and the rule's five
  inputs at 1e-13 of max(|plain|, 1), the NaN pattern the same; the kernel
  forms the card's products with reciprocals as torch does, so it is
  expected bit for bit, and the gaps are printed.
* The calibration objective through the kernel: ``jacfwd`` through
  ``_lm_residuals`` (the LM's Jacobian) and a ``vmap`` over three chains
  against the torch-op path on the card, at 1e-12 of each column's largest
  entry; a captured LogSV LM fit equals the eager one bit for bit; an eager
  fit of 12 iterations launches the kernel 25 times (the first cost, then
  each iteration's ``jacfwd`` pass and candidate).
"""
import numpy as np
import pytest
import torch
from torch.func import vmap

import stochvolmodels_torch as svt
from stochvolmodels_torch.models.logsv import fast_calibration as tfc
from stochvolmodels_torch.ops import bsm, graphs
from stochvolmodels_torch.ops.lm import residuals_and_jacobian

RTOL, OBJECTIVE_RTOL = 1e-13, 1e-12
P0 = svt.LogSvParams(sigma0=0.8, theta=1.0, kappa1=2.21, kappa2=2.18, beta=0.15, volvol=1.85)
PARS5 = (0.8, 1.0, 2.21, 0.15, 1.85)
LM_ITERS = 12


@pytest.fixture
def cuda_device():
    """a CUDA device, or a skip: the hand-written kernel has no CPU mode."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the hand-written kernel has no CPU mode")
    return torch.device("cuda")


def _btc_panel(device):
    chain = svt.get_btc_test_chain_data()
    _, grid, market, _ = tfc._chain_targets(chain, True, device)
    price = bsm.compute_bsm_vanilla_price(
        forward=grid.forwards[:, None], strike=grid.strikes, ttm=grid.ttms[:, None],
        vol=torch.as_tensor(market, dtype=torch.float64, device=device),
        optiontype=grid.optioncodes, discfactor=grid.discfactors[:, None])
    return tuple(x.contiguous() for x in bsm._broadcast_inputs(
        grid.forwards[:, None], grid.ttms[:, None], grid.strikes, price,
        grid.discfactors[:, None], grid.optioncodes))


def _edge_panel(device):
    rows = []
    for ttm, vol in ((0.02, 1.5), (0.5, 0.6), (2.0, 0.25)):
        for call in (True, False):
            for m in (0.3, 0.5, 0.8, 1.0, 1.25, 2.0, 3.5):
                rows.append((1.3, 1.3 * m, ttm, vol, 0.97, call))
    rows += [(1.0, 1.0, 1e-6, 0.5, 1.0, True), (1.0, 1.05, 1e-6, 2.0, 1.0, False)]
    fwd, strike, ttm, vol, disc, call = (np.array(c) for c in zip(*rows))
    t = lambda a: torch.as_tensor(a, dtype=torch.float64, device=device)
    price = bsm.compute_bsm_vanilla_price(forward=t(fwd), strike=t(strike), ttm=t(ttm),
                                          vol=t(vol), optiontype=np.where(call, "C", "P"),
                                          discfactor=t(disc))
    price[:3] = -0.01
    price[3:5] = 2.0 * t(fwd[3:5])
    price[5] = float("nan")
    return (price, t(fwd), t(strike), t(ttm), t(disc), t(np.where(call, 1.0, -1.0)))


def _plain(inputs):
    vol = bsm._fast_iv_impl(*inputs, 24, 4)
    _, forward, strike, ttm, discfactor, sgn = inputs
    inv_vega, partials = bsm._inverse_vega_and_partials(vol, forward, strike, ttm, discfactor,
                                                        sgn, 1e-12 * forward)
    return (vol, inv_vega) + tuple(partials)


def _scaled_gap(out, ref) -> float:
    out, ref = out.cpu().numpy(), ref.cpu().numpy()
    if not np.array_equal(np.isnan(out), np.isnan(ref)):
        return float("inf")
    ok = ~np.isnan(ref)
    return float(np.max(np.abs(out[ok] - ref[ok]) / np.maximum(np.abs(ref[ok]), 1.0),
                        initial=0.0))


@pytest.mark.gpu
@pytest.mark.parametrize("kind", ["btc", "edges"])
def test_kernel_matches_the_plain_version(cuda_device, kind):
    inputs = _btc_panel(cuda_device) if kind == "btc" else _edge_panel(cuda_device)
    ref = _plain(inputs)
    before = bsm.fast_iv_cuda.launches
    out = bsm.fast_iv_cuda(*inputs)
    again = bsm.fast_iv_cuda(*inputs)
    torch.cuda.synchronize()
    assert bsm.fast_iv_cuda.launches == before + 2
    gaps = [_scaled_gap(o, r) for o, r in zip(out, ref)]
    exact = all(torch.equal(torch.nan_to_num(o, nan=-1.0), torch.nan_to_num(r, nan=-1.0))
                for o, r in zip(out, ref))
    print(f"[fast-iv] {kind}: gaps vol {gaps[0]:.3e}, 1/vega {gaps[1]:.3e}, partials "
          + ", ".join(f"{g:.3e}" for g in gaps[2:]) + f"; bit for bit {exact}")
    assert max(gaps) <= RTOL
    assert all(torch.equal(torch.nan_to_num(a, nan=-1.0), torch.nan_to_num(b, nan=-1.0))
               for a, b in zip(out, again))


def _problem(device):
    chain = svt.get_btc_test_chain_data()
    vol_scaler, grid, market, weights = tfc._chain_targets(chain, True, device)
    f64 = dict(dtype=torch.float64, device=device)
    problem = (grid.ttms, grid.forwards, grid.discfactors, grid.strikes, grid.optioncodes,
               grid.mask, torch.as_tensor(market, **f64), torch.as_tensor(np.sqrt(weights), **f64),
               torch.tensor(vol_scaler, **f64))
    return problem, tuple(map(float, chain.ttms))


def _both_paths(monkeypatch, fn, launches):
    """(fn() through the kernel, fn() through the torch-op fast IV on the card)."""
    before = bsm.fast_iv_cuda.launches
    out = fn()
    assert bsm.fast_iv_cuda.launches == before + launches
    with monkeypatch.context() as m:
        m.setattr(bsm, "_takes_kernel", lambda given_price: False)
        ref = fn()
    return out, ref


def _jacobian_gap(J, J_ref) -> float:
    scale = torch.clamp(J_ref.abs().amax(dim=-2, keepdim=True), min=1e-300)
    return float(((J - J_ref).abs() / scale).max())


@pytest.mark.gpu
def test_lm_jacobian_and_a_vmap_over_chains_match_the_torch_op_path(cuda_device, monkeypatch):
    problem, ttms = _problem(cuda_device)
    pars = torch.tensor(PARS5, dtype=torch.float64, device=cuda_device)

    def one(p, *prob):
        return residuals_and_jacobian(
            tfc._lm_residuals(*prob, ttms_static=ttms, year_steps=360,
                              constraints_type=svt.ConstraintsType.UNCONSTRAINT), p)

    (J, r), (J_ref, r_ref) = _both_paths(monkeypatch, lambda: one(pars, *problem), 1)
    scales = torch.tensor([1.0, 0.95, 1.05], dtype=torch.float64, device=cuda_device)
    batch = pars * torch.stack([torch.ones_like(pars), 1.0 + 0.01 * torch.arange(5, device=cuda_device),
                                1.0 - 0.01 * torch.arange(5, device=cuda_device)])
    batched = [torch.stack([x] * 3) for x in problem[:-1]] + [problem[-1] * scales]
    (Jb, rb), (Jb_ref, rb_ref) = _both_paths(monkeypatch, lambda: vmap(one)(batch, *batched), 1)
    gaps = (float((r - r_ref).abs().max()), _jacobian_gap(J, J_ref),
            float(torch.nan_to_num(rb - rb_ref).abs().max()), _jacobian_gap(Jb, Jb_ref))
    print(f"[fast-iv] LM residual gap {gaps[0]:.3e}, Jacobian gap {gaps[1]:.3e} (of each column's "
          f"largest); vmap over 3 chains: {gaps[2]:.3e}, {gaps[3]:.3e}")
    assert max(gaps) <= OBJECTIVE_RTOL


@pytest.mark.gpu
def test_captured_fit_equals_eager_and_launches_the_kernel(cuda_device):
    chain = svt.get_btc_test_chain_data()
    fit = lambda: svt.calibrate_logsv_lm_on_device(chain, P0, nb_iters=LM_ITERS, device=cuda_device)
    captured = fit()
    again = fit()
    before = bsm.fast_iv_cuda.launches
    with graphs.eager():
        eager = fit()
    added = bsm.fast_iv_cuda.launches - before
    print(f"[fast-iv] eager fit of {LM_ITERS} iterations: {added} launches; cost {captured[1]}")
    assert added == 1 + 2 * LM_ITERS
    assert captured[1] == eager[1] == again[1] and np.isfinite(captured[1])
    assert captured[0].to_dict() == eager[0].to_dict() == again[0].to_dict()
