"""The chain's affine RK4 kernel (``csrc/affine_rk4.cu``) on a card.

This file imports no JAX, so that it runs where the card is
(``python3 -m pytest --noconftest tests/test_torch_affine_rk4_card.py``).
Every test is marked ``gpu`` and skips without a CUDA device: the kernel has
no CPU mode.

* The kernel against the plain version (the torch-op RK4 on the same card)
  and ``torch.func.jacfwd`` of it, at the BTC chain and at a grid whose last
  lanes pass the freeze cap, held as the CPU rehearsal holds it
  (``tests/test_torch_affine_rk4.py``): 1e-13 of max(|plain|, 1) on the
  panel, 1e-12 on the partials; two launches give equal bits, and a batch
  of chains gives each chain's bits.
* The calibration objectives through the kernel: the LM's ``jacfwd``
  Jacobian and Adam's ``autograd.grad`` against the torch-op path on the
  card at 1e-12 of their largest entries; a captured LM fit equals the
  eager one bit for bit; an eager fit of 12 iterations launches the primal
  kernel 25 times (the first cost, then each iteration's ``jacfwd`` pass and
  candidate) and the tangent kernel 12 times (each ``jacfwd`` pass); a sweep
  of 8 chains equals the 8 single fits.
"""
import dataclasses

import numpy as np
import pytest
import torch
from torch.func import jacfwd

import stochvolmodels_torch as svt
from stochvolmodels_torch.models.logsv import fast_calibration as tfc
from stochvolmodels_torch.ops import affine_rk4 as ar
from stochvolmodels_torch.ops import graphs, mgf
from stochvolmodels_torch.ops.lm import residuals_and_jacobian
from stochvolmodels_torch.parallel import sweep

PANEL_RTOL, PARTIALS_RTOL, OBJECTIVE_RTOL = 1e-13, 1e-12, 1e-12
# the 8-chain sweep against the single fits: the LM algebra and the fast IV
# run vmapped there, and chip_smoke.py's [sweep] phase holds the same at 1e-6
SWEEP_RTOL = 1e-6
P0 = svt.LogSvParams(sigma0=0.8, theta=1.0, kappa1=2.21, kappa2=2.18, beta=0.15, volvol=1.85)
LM_ITERS = 12


@pytest.fixture
def cuda_device():
    """a CUDA device, or a skip: the hand-written kernel has no CPU mode."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the hand-written kernel has no CPU mode")
    return torch.device("cuda")


def _btc(device):
    chain = svt.get_btc_test_chain_data()
    vol_scaler = svt.set_vol_scaler(chain.get_chain_atm_vols()[0], chain.ttms[0])
    p = svt.LOGSV_BTC_PARAMS
    pvec = torch.tensor([p.sigma0, p.theta, p.kappa1, p.kappa2, p.beta, p.volvol],
                        dtype=torch.float64, device=device)
    phi = mgf.get_phi_grid(vol_scaler=vol_scaler, device=device)
    return chain, vol_scaler, pvec, phi, ar.chain_schedule(tuple(map(float, chain.ttms)), 360)


def _scaled_gap(out, ref) -> float:
    out, ref = out.cpu().numpy(), ref.cpu().numpy()
    if not np.array_equal(np.isnan(out), np.isnan(ref)):
        return float("inf")
    ok = ~np.isnan(ref)
    return float(np.max(np.abs(out[ok] - ref[ok]) / np.maximum(np.abs(ref[ok]), 1.0),
                        initial=0.0))


@pytest.mark.gpu
@pytest.mark.parametrize("grid_kind", ["btc", "forced"])
def test_kernel_matches_the_plain_version(cuda_device, grid_kind):
    _, _, pvec, phi, schedule = _btc(cuda_device)
    if grid_kind == "forced":
        tail = torch.complex(torch.full((6,), -0.5, dtype=torch.float64, device=cuda_device),
                             torch.tensor([100.0, 200.0, 400.0, 1e3, 1e4, 1e5],
                                          dtype=torch.float64, device=cuda_device))
        phi = torch.cat([phi[:40], tail])
    ref = ar.log_mgf_chain_plain(pvec, phi, schedule)
    jac = jacfwd(lambda p: torch.view_as_real(ar.log_mgf_chain_plain(p, phi, schedule)))(pvec)
    ref_partials = torch.view_as_complex(jac.movedim(-1, 0).contiguous())
    panel = ar.log_mgf_chain_cuda(pvec, phi, schedule)
    panel_t, partials = ar.log_mgf_chain_cuda(pvec, phi, schedule, tangents=True)
    torch.cuda.synchronize()
    assert torch.equal(panel, panel_t)
    gaps = [_scaled_gap(panel, ref)] + [_scaled_gap(partials[j], ref_partials[j])
                                        for j in range(6)]
    print(f"[affine-rk4] {grid_kind}: panel gap {gaps[0]:.3e}, partial gaps "
          + ", ".join(f"{n} {g:.3e}" for n, g in zip(ar.PARAMS, gaps[1:])))
    assert gaps[0] <= PANEL_RTOL
    assert max(gaps[1:]) <= PARTIALS_RTOL
    if grid_kind == "forced":
        assert torch.equal(panel[:, -6:], ref[:, -6:])
        assert bool((partials[2:, :, -6:] == 0).all())


@pytest.mark.gpu
def test_two_launches_and_a_batch_give_each_chains_bits(cuda_device):
    _, vol_scaler, pvec, _, schedule = _btc(cuda_device)
    scales = torch.tensor([1.0, 0.9, 1.1], dtype=torch.float64, device=cuda_device)
    phis = torch.stack([mgf.get_phi_grid(vol_scaler=vol_scaler * float(s), device=cuda_device)
                        for s in scales])
    pvecs = pvec * torch.stack([torch.ones_like(pvec), 1.0 + 0.02 * torch.arange(6, device=cuda_device),
                                1.0 - 0.02 * torch.arange(6, device=cuda_device)])
    first = ar.log_mgf_chain_cuda(pvecs, phis, schedule, tangents=True)
    second = ar.log_mgf_chain_cuda(pvecs, phis, schedule, tangents=True)
    for b in range(3):
        one = ar.log_mgf_chain_cuda(pvecs[b], phis[b], schedule, tangents=True)
        assert all(torch.equal(x[b], y) for x, y in zip(first, one))
    assert all(torch.equal(x, y) for x, y in zip(first, second))


def _problem(device):
    chain = svt.get_btc_test_chain_data()
    vol_scaler, grid, market, weights = tfc._chain_targets(chain, True, device)
    f64 = dict(dtype=torch.float64, device=device)
    problem = (grid.ttms, grid.forwards, grid.discfactors, grid.strikes, grid.optioncodes,
               grid.mask, torch.as_tensor(market, **f64), torch.as_tensor(np.sqrt(weights), **f64),
               torch.tensor(vol_scaler, **f64))
    return chain, grid, vol_scaler, market, weights, problem, tuple(map(float, chain.ttms))


def _both_paths(monkeypatch, fn):
    """(fn() through the kernel, fn() through the torch-op RK4 on the card)."""
    before = ar.log_mgf_chain_cuda.tangent_launches
    out = fn()
    assert ar.log_mgf_chain_cuda.tangent_launches == before + 1
    with monkeypatch.context() as m:
        m.setattr(ar, "_takes_kernel", lambda phi_grid: False)
        ref = fn()
    return out, ref


@pytest.mark.gpu
def test_lm_jacobian_and_adam_gradient_match_the_torch_op_path(cuda_device, monkeypatch):
    chain, grid, vol_scaler, market, weights, problem, ttms = _problem(cuda_device)
    pars = torch.tensor([P0.sigma0, P0.theta, P0.kappa1, P0.beta, P0.volvol], dtype=torch.float64,
                        device=cuda_device)
    residuals = tfc._lm_residuals(*problem, ttms_static=ttms, year_steps=360,
                                  constraints_type=svt.ConstraintsType.UNCONSTRAINT)
    (J, r), (J_ref, r_ref) = _both_paths(monkeypatch,
                                         lambda: residuals_and_jacobian(residuals, pars))
    jac_gap = float(((J - J_ref).abs() / J_ref.abs().amax(dim=0)).max())
    res_gap = float((r - r_ref).abs().max())
    market_t = torch.as_tensor(market, dtype=torch.float64, device=cuda_device)
    weights_t = torch.as_tensor(weights, dtype=torch.float64, device=cuda_device)

    def adam_grad():
        p = pars.clone().requires_grad_(True)
        vols, _ = tfc._model_vols(p, grid, vol_scaler, ttms, 360)
        nan_mask = torch.isnan(vols)
        loss = torch.sum(torch.where(nan_mask, 0.0,
                                     weights_t * torch.square(torch.where(nan_mask, market_t, vols)
                                                              - market_t)))
        return torch.autograd.grad(loss, p)[0]

    g, g_ref = _both_paths(monkeypatch, adam_grad)
    grad_gap = float((g - g_ref).abs().max() / g_ref.abs().max())
    print(f"[affine-rk4] LM residual gap {res_gap:.3e}, Jacobian gap {jac_gap:.3e} (of each "
          f"column's largest), Adam gradient gap {grad_gap:.3e}")
    assert res_gap <= OBJECTIVE_RTOL and jac_gap <= OBJECTIVE_RTOL
    assert grad_gap <= OBJECTIVE_RTOL


@pytest.mark.gpu
def test_captured_fit_equals_eager_and_launches_the_kernel(cuda_device):
    chain = svt.get_btc_test_chain_data()
    fit = lambda: svt.calibrate_logsv_lm_on_device(chain, P0, nb_iters=LM_ITERS, device=cuda_device)
    captured = fit()
    again = fit()
    launches, tangents = ar.log_mgf_chain_cuda.launches, ar.log_mgf_chain_cuda.tangent_launches
    with graphs.eager():
        eager = fit()
    added = (ar.log_mgf_chain_cuda.launches - launches,
             ar.log_mgf_chain_cuda.tangent_launches - tangents)
    print(f"[affine-rk4] eager fit of {LM_ITERS} iterations: {added[0]} primal and {added[1]} "
          f"tangent launches; cost {captured[1]}")
    assert added == (1 + 2 * LM_ITERS, LM_ITERS)
    assert captured[1] == eager[1] == again[1] and np.isfinite(captured[1])
    assert captured[0].to_dict() == eager[0].to_dict() == again[0].to_dict()


@pytest.mark.gpu
def test_a_sweep_of_eight_chains_equals_eight_single_fits(cuda_device):
    chain = svt.get_btc_test_chain_data()
    chains = [dataclasses.replace(chain, bid_ivs=[s * iv for iv in chain.bid_ivs],
                                  ask_ivs=[s * iv for iv in chain.ask_ivs])
              for s in np.linspace(0.92, 1.08, 8)]
    before = ar.log_mgf_chain_cuda.tangent_launches
    fits = sweep.calibrate_logsv_lm_sweep(chains, P0, nb_iters=LM_ITERS, device=cuda_device)
    # captured: the initial state's and one iteration's graph, each recorded after a warm-up
    assert ar.log_mgf_chain_cuda.tangent_launches > before
    names = ("sigma0", "theta", "kappa1", "beta", "volvol")
    gap, exact = 0.0, True
    for c, (fit, cost) in zip(chains, fits):
        one, one_cost = svt.calibrate_logsv_lm_on_device(c, P0, nb_iters=LM_ITERS,
                                                         device=cuda_device)
        want = np.array([getattr(one, n) for n in names] + [one_cost])
        got = np.array([getattr(fit, n) for n in names] + [cost])
        exact = exact and np.array_equal(want, got)
        gap = max(gap, float(np.max(np.abs(got - want) / np.abs(want))))
    print(f"[affine-rk4] sweep of 8 chains against 8 single fits: max relative gap {gap:.3e}, "
          f"bit for bit {exact}")
    assert gap <= SWEEP_RTOL
