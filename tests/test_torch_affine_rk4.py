"""The chain's affine RK4 kernel (``csrc/affine_rk4.cu``) and its
``torch.autograd.Function`` (``ops/affine_rk4.py``) without a card.

* The CUDA wrapper ``log_mgf_chain_cuda`` refuses what the kernel does not
  take (a CPU tensor, a wrong dtype, a schedule of no or too many maturities
  or of no steps, a FIRST-order expansion or the inverse measure) before it
  builds or launches anything.  On CPU tensors the objective ``_model_vols``
  takes the plain version and keeps the bits of ``logsv_chain_price_grid``,
  values and ``jacfwd`` Jacobian.
* A rehearsal: the source compiled with ``g++ -std=c++20 -ffp-contract=off``
  against ``tests/cuda_stub/cuda_runtime.h`` (one std::thread per CUDA
  thread, the blocks one after another), run through its C entry point on
  numpy buffers.  Its panel and six partials are held against the plain
  version and ``torch.func.jacfwd`` of it, at the BTC chain and at a grid
  whose last lanes pass the freeze cap (those lanes must read the frozen
  value and zero tangents, as ``torch.where`` gives).  The kernel sums in
  another order than torch's complex GEMM and gemv, sums each symmetric pair
  of M once and applies L as L0 y + phi (L1 y), and the RK4 carries that
  rounding over 156 steps: the panel is held at 1e-13 of max(|plain|, 1)
  (measured 1.1e-15) and the partials at 1e-12 (measured 2.1e-13, on lanes
  next to the cap).  Skips where g++ is absent.
* The Function's rules, with the rehearsal build or the plain version and
  its ``jacfwd`` partials standing in for the card library: ``jacfwd``
  through ``_lm_residuals`` (the LM's Jacobian), a ``vmap`` over three chains
  (the sweep's), ``jacfwd`` under that ``vmap`` (the sweep's iteration) and
  ``autograd.grad`` of Adam's loss against the torch-op path.  The
  Jacobian is held at 1e-12 of its column's largest entry and Adam's
  gradient at 1e-12 of its largest (measured at most 7.4e-16 and 4.4e-16
  with the rehearsal, 3.0e-16 and 2.2e-16 with the plain partials), the
  launches are counted: one primal and one tangent launch a ``jacfwd`` or
  ``backward`` pass, one launch a batch.
"""
import ctypes
import re
import shutil
import subprocess
from pathlib import Path

import numpy as np
import pytest
import torch
from torch.func import jacfwd, vmap

import stochvolmodels_torch as svt
from stochvolmodels_torch.models.logsv import fast_calibration as tfc
from stochvolmodels_torch.models.logsv.pricer import logsv_chain_price_grid
from stochvolmodels_torch.ops import _build, bsm, mgf
from stochvolmodels_torch.ops import affine_rk4 as ar
from stochvolmodels_torch.ops.lm import residuals_and_jacobian

ROOT = Path(__file__).resolve().parents[1]
CSRC = ROOT / "stochvolmodels_torch" / "csrc"
STUB = Path(__file__).resolve().parent / "cuda_stub"
OTHER_KERNELS = ("logsv_mc", "heston_mc", "rough_mc", "hawkes_mc", "logsv_variants", "mc_payoff")
PANEL_RTOL, PARTIALS_RTOL = 1e-13, 1e-12
JACOBIAN_RTOL, GRAD_RTOL = 1e-12, 1e-12
# bench.py's start point of the LM benchmark, PARAMS5 [sigma0, theta, kappa1, beta, volvol]
P0 = np.array([0.8, 1.0, 2.21, 0.15, 1.85])
# a coarse RK4 keeps the CPU's torch-op references short; the BTC chain's
# first LM residuals are finite at 60 steps a year
YEAR_STEPS = 60


def f64(x):
    return torch.as_tensor(x, dtype=torch.float64)


def _btc_pvec() -> torch.Tensor:
    p = svt.LOGSV_BTC_PARAMS
    return f64([p.sigma0, p.theta, p.kappa1, p.kappa2, p.beta, p.volvol])


def _btc_chain():
    chain = svt.get_btc_test_chain_data()
    vol_scaler = svt.set_vol_scaler(chain.get_chain_atm_vols()[0], chain.ttms[0])
    return chain, vol_scaler, tuple(float(t) for t in chain.ttms)


def _plain_partials(pvec, phi_grid, schedule) -> torch.Tensor:
    """(6, T, N) complex: ``jacfwd`` of the plain version."""
    jac = jacfwd(lambda p: torch.view_as_real(ar.log_mgf_chain_plain(p, phi_grid, schedule)))
    return torch.view_as_complex(jac(pvec).movedim(-1, 0).contiguous())


def _scaled_gap(out, ref) -> float:
    """max |out - ref| / max(|ref|, 1), inf where the NaN patterns differ."""
    out, ref = np.asarray(out), np.asarray(ref)
    if not np.array_equal(np.isnan(out), np.isnan(ref)):
        return float("inf")
    ok = ~np.isnan(ref)
    return float(np.max(np.abs(out[ok] - ref[ok]) / np.maximum(np.abs(ref[ok]), 1.0),
                        initial=0.0))


# --------------------------------------------------------------------------
# the wrapper's refusals and the plain path
# --------------------------------------------------------------------------

def _inputs(n=16, dtype=torch.float64):
    return _btc_pvec().to(dtype), mgf.get_phi_grid(max_phi=n, vol_scaler=0.2, device="cpu")


SCHEDULE = ((16, 0.01), (20, 0.01))


def test_wrapper_raises_on_a_cpu_tensor():
    with pytest.raises(ValueError, match="CUDA tensors"):
        ar.log_mgf_chain_cuda(*_inputs(), SCHEDULE)


def test_wrapper_raises_on_a_wrong_dtype():
    with pytest.raises(TypeError, match="float64 parameters and a complex128 grid"):
        ar.log_mgf_chain_cuda(*_inputs(dtype=torch.float32), SCHEDULE)
    pvec, phi = _inputs()
    with pytest.raises(TypeError, match="complex128 grid"):
        ar.log_mgf_chain_cuda(pvec, phi.to(torch.complex64), SCHEDULE)


@pytest.mark.parametrize("schedule", [(), ((16, 0.01),) * (ar.MAX_SEGMENTS + 1), ((0, 0.01),),
                                      ((16, float("nan")),), ((16.0, 0.01),)])
def test_wrapper_raises_on_an_unsupported_schedule(schedule):
    with pytest.raises(ValueError, match="maturit"):
        ar.log_mgf_chain_cuda(*_inputs(), schedule)


@pytest.mark.parametrize("kw", [dict(expansion_order=svt.ExpansionOrder.FIRST),
                                dict(is_spot_measure=False)])
def test_wrapper_raises_on_an_unsupported_expansion(kw):
    with pytest.raises(NotImplementedError, match="SECOND-order expansion under the spot"):
        ar.log_mgf_chain_cuda(*_inputs(), SCHEDULE, **kw)


def test_wrapper_raises_on_mismatched_batch_shapes():
    pvec, phi = _inputs()
    with pytest.raises(ValueError, match="one batch shape"):
        ar.log_mgf_chain_cuda(pvec.expand(3, 6), phi.expand(2, -1), SCHEDULE)


def test_schedule_is_solve_a_ode_grid_s():
    _, _, ttms = _btc_chain()
    schedule = ar.chain_schedule(ttms, 360)
    assert [s for s, _ in schedule] == [16, 21, 35, 84]
    ttm0 = 0.0
    for ttm, (steps, dt) in zip(ttms, schedule):
        assert steps == max(int(np.ceil(360 * (ttm - ttm0))), 16)
        assert dt == (ttm - ttm0) / steps
        ttm0 = ttm


def test_cpu_objective_keeps_the_bits_of_the_chain_pricer():
    """on CPU tensors ``_model_vols`` (the plain panel, then a Fourier price
    per slice) equals ``logsv_chain_price_grid`` then the fast IV, values and
    Jacobian, bit for bit; it launches nothing."""
    chain, vol_scaler, ttms = _btc_chain()
    grid = chain.to_grid(device="cpu")
    vs = f64(vol_scaler)

    def pricer_path(pars):
        sigma0, theta, kappa1, beta, volvol = pars.unbind()
        prices = logsv_chain_price_grid(grid, sigma0=sigma0, theta=theta, kappa1=kappa1,
                                        kappa2=kappa1 / theta, beta=beta, volvol=volvol,
                                        vol_scaler=vs, ttms_static=ttms, year_steps=YEAR_STEPS)
        return bsm.infer_bsm_implied_vol_fast(
            forward=grid.forwards[:, None], ttm=grid.ttms[:, None], strike=grid.strikes,
            given_price=prices, discfactor=grid.discfactors[:, None],
            optiontype=grid.optioncodes)

    before = ar.log_mgf_chain_cuda.launches
    objective = lambda pars: tfc._model_vols(pars, grid, vs, ttms, YEAR_STEPS)[0]
    pars = f64(P0)
    np.testing.assert_array_equal(objective(pars).numpy(), pricer_path(pars).numpy())
    np.testing.assert_array_equal(jacfwd(objective)(pars).numpy(),
                                  jacfwd(pricer_path)(pars).numpy())
    assert ar.log_mgf_chain_cuda.launches == before == 0


@pytest.fixture
def csrc_copy(tmp_path, monkeypatch):
    copy = tmp_path / "csrc"
    shutil.copytree(_build.CSRC_DIR, copy)
    monkeypatch.setattr(_build, "CSRC_DIR", copy)
    return copy


def test_digest_follows_the_affine_source_alone(csrc_copy):
    before = {name: _build.source_digest(name) for name in OTHER_KERNELS + ("affine_rk4",)}
    assert len(set(before.values())) == len(before)
    src = csrc_copy / "affine_rk4.cu"
    src.write_text(src.read_text() + "\n// edited\n")
    assert _build.source_digest("affine_rk4") != before["affine_rk4"]
    assert {name: _build.source_digest(name) for name in OTHER_KERNELS} == {
        name: before[name] for name in OTHER_KERNELS}


def test_affine_source_adds_no_header():
    src = (CSRC / "affine_rk4.cu").read_text()
    assert 'extern "C" int affine_rk4_launch(' in src
    assert "#include \"" not in src


# --------------------------------------------------------------------------
# the rehearsal on the CPU
# --------------------------------------------------------------------------

@pytest.fixture(scope="module")
def launch(tmp_path_factory):
    """the C entry point of ``csrc/affine_rk4.cu`` built for the CPU against
    the stand-in runtime."""
    if shutil.which("g++") is None:
        pytest.skip("needs g++ to compile the kernel source for the CPU")
    src, n = re.subn(r"(\w+(?:<\w+>)?)<<<(.*?)>>>\(", r"cuda_stub::launch(\1, \2, ",
                     (CSRC / "affine_rk4.cu").read_text(), flags=re.S)
    assert n == 2
    out_dir = tmp_path_factory.mktemp("affine_rehearsal")
    cpp, lib = out_dir / "affine_rk4.cpp", out_dir / "libaffine_rk4.so"
    cpp.write_text(src)
    subprocess.run(["g++", "-std=c++20", "-O2", "-ffp-contract=off", "-fPIC", "-shared",
                    "-pthread", f"-I{STUB}", f"-I{CSRC}", "-o", str(lib), str(cpp)],
                   check=True, capture_output=True, text=True, timeout=300)
    fn = ctypes.CDLL(str(lib)).affine_rk4_launch
    fn.argtypes, fn.restype = ar.LAUNCH_ARGTYPES, ctypes.c_int
    return fn


def run_kernel(fn, pvec, phi_grid, schedule, tangents=False):
    """the rehearsal's panel (..., T, N), or (panel, partials (..., 6, T, N)),
    as CPU tensors, for the signature of ``log_mgf_chain_cuda``."""
    batch, n = tuple(pvec.shape[:-1]), phi_grid.shape[-1]
    params = np.ascontiguousarray(pvec.detach().numpy().reshape(-1, 6))
    phi = np.ascontiguousarray(phi_grid.detach().numpy().reshape(-1, n))
    b, t = params.shape[0], len(schedule)
    panel = np.full((b, t, n), complex(np.nan, np.nan))
    partials = np.full((b, 6, t, n), complex(np.nan, np.nan))
    steps = np.array([s for s, _ in schedule], dtype=np.int32)
    dts = np.array([[dt, 0.5 * dt, dt / 6.0] for _, dt in schedule])
    err = fn(params.ctypes.data, phi.ctypes.data, panel.ctypes.data, partials.ctypes.data,
             int(tangents), b, n, t, steps.ctypes.data, dts.ctypes.data, None)
    assert err == 0
    panel = torch.from_numpy(panel.reshape(batch + (t, n)))
    if not tangents:
        return panel
    return panel, torch.from_numpy(partials.reshape(batch + (6, t, n)))


def _forced_grid(phi_grid):
    """the grid's first 40 points and 6 lanes far up the imaginary axis, where
    the RK4 at 360 steps a year diverges within the first maturity; the last
    of the 40 sits next to the cap without passing it."""
    tail = torch.complex(torch.full((6,), -0.5, dtype=torch.float64),
                         f64([100.0, 200.0, 400.0, 1e3, 1e4, 1e5]))
    return torch.cat([phi_grid[:40], tail])


@pytest.mark.parametrize("grid_kind", ["btc", "forced"])
def test_rehearsal_matches_the_plain_version_and_jacfwd(launch, grid_kind):
    chain, vol_scaler, ttms = _btc_chain()
    schedule = ar.chain_schedule(ttms, 360)
    phi = mgf.get_phi_grid(vol_scaler=vol_scaler, device="cpu")
    if grid_kind == "forced":
        phi = _forced_grid(phi)
    pvec = _btc_pvec()
    ref, ref_partials = ar.log_mgf_chain_plain(pvec, phi, schedule), \
        _plain_partials(pvec, phi, schedule)
    panel = run_kernel(launch, pvec, phi, schedule)
    panel_t, partials = run_kernel(launch, pvec, phi, schedule, tangents=True)
    assert torch.equal(panel, panel_t)
    assert _scaled_gap(panel.numpy(), ref.numpy()) <= PANEL_RTOL
    for j in range(6):
        assert _scaled_gap(partials[j].numpy(), ref_partials[j].numpy()) <= PARTIALS_RTOL, \
            ar.PARAMS[j]
    if grid_kind == "forced":
        # every term of the six lanes is frozen at (1e6, 0): the panel reads the
        # frozen contraction, the ODE parameters' partials are 0, and sigma0's
        # and theta's are those of the contraction weights alone
        frozen = ref[:, -6:]
        assert torch.equal(panel[:, -6:], frozen)
        assert bool((frozen.imag == 0).all()) and bool((frozen.real > 1e5).all())
        assert bool((partials[2:, :, -6:] == 0).all())
        assert torch.equal(partials[1, :, -6:], -partials[0, :, -6:])


def test_rehearsal_batch_is_each_chain_bit_for_bit(launch):
    _, vol_scaler, ttms = _btc_chain()
    schedule = ar.chain_schedule(ttms, YEAR_STEPS)
    scalers = f64([vol_scaler, 0.9 * vol_scaler, 1.1 * vol_scaler])
    phis = torch.stack([mgf.get_phi_grid(vol_scaler=s, max_phi=64, device="cpu")
                        for s in scalers])
    pvecs = _btc_pvec() * f64([[1.0] * 6, [1.02, 0.98, 1.0, 1.0, 1.0, 1.05],
                               [0.97, 1.01, 1.1, 0.9, 1.2, 0.95]])
    panel, partials = run_kernel(launch, pvecs, phis, schedule, tangents=True)
    for b in range(3):
        one, one_partials = run_kernel(launch, pvecs[b], phis[b], schedule, tangents=True)
        assert torch.equal(panel[b], one) and torch.equal(partials[b], one_partials)


# --------------------------------------------------------------------------
# the autograd.Function's rules with a stand-in for the card library
# --------------------------------------------------------------------------

def _plain_stand_in(pvec, phi_grid, schedule, tangents=False):
    """``log_mgf_chain_cuda``'s results from the plain version and its
    ``jacfwd`` partials, chain by chain."""
    batch, n = tuple(pvec.shape[:-1]), phi_grid.shape[-1]
    pairs = list(zip(pvec.reshape(-1, 6), phi_grid.reshape(-1, n)))
    panel = torch.stack([ar.log_mgf_chain_plain(p, f, schedule) for p, f in pairs])
    panel = panel.reshape(batch + panel.shape[1:])
    if not tangents:
        return panel
    partials = torch.stack([_plain_partials(p, f, schedule) for p, f in pairs])
    return panel, partials.reshape(batch + partials.shape[1:])


@pytest.fixture(params=["plain", "rehearsal"])
def kernel_path(request, monkeypatch):
    """routes CPU grids through the Function with a stand-in for
    ``log_mgf_chain_cuda``; returns the stand-in's call counts."""
    if request.param == "rehearsal":
        fn = request.getfixturevalue("launch")
        inner = lambda *a, **kw: run_kernel(fn, *a, **kw)
    else:
        inner = _plain_stand_in
    counts = {"launches": 0, "tangent_launches": 0}

    def stand_in(pvec, phi_grid, schedule, tangents=False):
        assert pvec.is_contiguous() and phi_grid.is_contiguous()
        counts["tangent_launches" if tangents else "launches"] += 1
        return inner(pvec, phi_grid, schedule, tangents=tangents)

    monkeypatch.setattr(ar, "log_mgf_chain_cuda", stand_in)
    monkeypatch.setattr(ar, "_takes_kernel", lambda phi_grid: True)
    return counts


@pytest.fixture(scope="module")
def lm_problem():
    chain, vol_scaler, ttms = _btc_chain()
    vs, grid, market, weights = tfc._chain_targets(chain, True, "cpu")
    problem = (grid.ttms, grid.forwards, grid.discfactors, grid.strikes, grid.optioncodes,
               grid.mask, f64(market), f64(np.sqrt(weights)), f64(vs))
    return chain, grid, problem, ttms


def _residuals(problem, ttms):
    return tfc._lm_residuals(*problem, ttms_static=ttms, year_steps=YEAR_STEPS,
                             constraints_type=svt.ConstraintsType.UNCONSTRAINT)


def _assert_jacobian_close(J, ref):
    scale = torch.clamp(ref.abs().amax(dim=0), min=1e-300)
    assert float(((J - ref).abs() / scale).max()) <= JACOBIAN_RTOL


@pytest.fixture(scope="module")
def torch_op_jacobian(lm_problem):
    _, _, problem, ttms = lm_problem
    return residuals_and_jacobian(_residuals(problem, ttms), f64(P0))


def test_jacfwd_through_lm_residuals_matches_the_torch_op_path(kernel_path, lm_problem,
                                                               torch_op_jacobian):
    _, _, problem, ttms = lm_problem
    J_ref, r_ref = torch_op_jacobian
    J, r = residuals_and_jacobian(_residuals(problem, ttms), f64(P0))
    # one primal launch in the jacfwd pass and one tangent launch for its five columns
    assert kernel_path == {"launches": 1, "tangent_launches": 1}
    assert float((r - r_ref).abs().max()) <= 1e-12
    _assert_jacobian_close(J, J_ref)


def test_vmap_over_three_chains_equals_three_single_calls(kernel_path, lm_problem):
    """the sweep's shape: the residuals and their Jacobian vmapped over three
    chains (their own parameters and vol scalers) in one launch a pass."""
    _, _, problem, ttms = lm_problem
    scales = f64([1.0, 0.95, 1.05])
    pars = f64(P0) * torch.stack([f64([1.0] * 5), f64([1.01, 0.99, 1.05, 0.9, 1.02]),
                                  f64([0.98, 1.02, 0.95, 1.1, 0.97])])
    batched = [torch.stack([x] * 3) for x in problem[:-1]] + [problem[-1] * scales]

    def one(p, *prob):
        return residuals_and_jacobian(_residuals(prob, ttms), p)

    J, r = vmap(one)(pars, *batched)
    assert kernel_path == {"launches": 1, "tangent_launches": 1}
    for b in range(3):
        J_b, r_b = one(pars[b], *[x[b] for x in batched])
        assert torch.equal(torch.nan_to_num(r[b]), torch.nan_to_num(r_b))
        _assert_jacobian_close(J[b], J_b)
    panels = vmap(lambda p, vs: ar.log_mgf_chain(p, mgf.get_phi_grid(vol_scaler=vs, device="cpu"),
                                                 ar.chain_schedule(ttms, YEAR_STEPS)))(
        torch.stack([_btc_pvec()] * 3) * f64([[1.0], [0.99], [1.01]]), problem[-1] * scales)
    for b in range(3):
        one_panel = ar.log_mgf_chain(_btc_pvec() * f64([1.0, 0.99, 1.01][b]),
                                     mgf.get_phi_grid(vol_scaler=problem[-1] * scales[b],
                                                      device="cpu"),
                                     ar.chain_schedule(ttms, YEAR_STEPS))
        assert torch.equal(panels[b], one_panel)


def _adam_grad(lm_problem):
    """``calibrate_logsv_on_device``'s loss (UNCONSTRAINT) at ``P0`` and its
    gradient by ``torch.autograd.grad``."""
    chain, _, _, ttms = lm_problem
    vol_scaler, grid, market, weights = tfc._chain_targets(chain, True, "cpu")
    market, weights = f64(market), f64(weights)
    pars = f64(P0).requires_grad_(True)
    vols, _ = tfc._model_vols(pars, grid, vol_scaler, ttms, YEAR_STEPS)
    nan_mask = torch.isnan(vols)
    clean = torch.where(nan_mask, market, vols)
    r = weights * torch.square(clean - market)
    loss = torch.sum(torch.where(nan_mask, 0.0, r)) \
        + 0.01 * torch.sum(nan_mask & (weights > 0.0)).to(torch.float64)
    return loss.detach(), torch.autograd.grad(loss, pars)[0]


@pytest.fixture(scope="module")
def torch_op_adam_grad(lm_problem):
    return _adam_grad(lm_problem)


def test_reverse_mode_of_adams_loss_matches_the_torch_op_path(kernel_path, lm_problem,
                                                             torch_op_adam_grad):
    ref_loss, ref_grad = torch_op_adam_grad
    loss, grad = _adam_grad(lm_problem)
    assert kernel_path == {"launches": 1, "tangent_launches": 1}
    assert abs(float(loss - ref_loss)) <= 1e-12 * abs(float(ref_loss))
    assert float((grad - ref_grad).abs().max()) <= GRAD_RTOL * float(ref_grad.abs().max())


def test_adam_fit_runs_through_the_function(kernel_path, lm_problem):
    chain, _, _, _ = lm_problem
    p0 = svt.LogSvParams(sigma0=0.8, theta=1.0, kappa1=2.21, kappa2=2.21, beta=0.15,
                         volvol=1.85)
    fit, loss = tfc.calibrate_logsv_on_device(chain, p0, nb_iters=2, year_steps=YEAR_STEPS,
                                              device="cpu")
    # one primal launch and one tangent launch an iteration, then the final loss
    assert kernel_path == {"launches": 3, "tangent_launches": 2}
    assert np.isfinite(loss) and np.isfinite(fit.sigma0)
