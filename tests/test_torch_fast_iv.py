"""The fast implied vol's kernel (``csrc/fast_iv.cu``) and its
``torch.autograd.Function`` (``ops/bsm.py``) without a card.

* The CUDA wrapper ``fast_iv_cuda`` refuses what the kernel does not take (a
  CPU tensor, a wrong dtype, a non-contiguous input, inputs of two shapes, a
  negative stage count) before it builds or launches anything.
* A rehearsal: the source compiled with ``g++ -std=c++20 -ffp-contract=off``
  against ``tests/cuda_stub/cuda_runtime.h`` (one std::thread per CUDA
  thread, the blocks one after another), run through its C entry point on
  numpy buffers, against the plain version (``_fast_iv_impl``, and
  ``_inverse_vega_and_partials`` at its vol for the rule's five inputs).  The
  panel: the BTC chain's padded panel (its padded slots unbracketed), calls
  and puts deep in and out of the money, unbracketed and NaN prices, a tiny
  ttm, and a ragged last block.  Held at 1e-13 of max(|plain|, 1), with the
  same NaN pattern: the host's libm (glibc exp and log) and the plain
  version's CPU kernels (SLEEF's vectorised exp and log, and a true division
  by sqrt(2) and sqrt(2 pi) where the kernel, as torch on a card, multiplies
  by the reciprocal) part by an ulp now and then, which the Newton polish
  carries into the vol as an ulp of price over vega; a lost stage or a wrong
  branch gives gaps of 1e-7 and more.  Skips where g++ is absent.
* The Function's rules, with the plain version or the rehearsal standing in
  for the card library: values, ``jvp``, ``backward`` and ``vmap`` against
  ``_FastIVCore``; ``jacfwd`` through ``_lm_residuals`` (the LM's Jacobian)
  and a ``vmap`` over three chains (the sweep's) against the torch-op path;
  the launches counted (one a residual pass, one a batch, 1 + 2 an LM
  iteration); ``higher_order=True`` against the CPU's.
"""
import ctypes
import re
import shutil
import subprocess
from pathlib import Path

import numpy as np
import pytest
import torch
from torch.func import jacfwd, jvp, vmap

import stochvolmodels_torch as svt
from stochvolmodels_torch.models.logsv import fast_calibration as tfc
from stochvolmodels_torch.ops import _build, bsm
from stochvolmodels_torch.ops.lm import residuals_and_jacobian

ROOT = Path(__file__).resolve().parents[1]
CSRC = ROOT / "stochvolmodels_torch" / "csrc"
STUB = Path(__file__).resolve().parent / "cuda_stub"
OTHER_KERNELS = ("logsv_mc", "heston_mc", "rough_mc", "hawkes_mc", "logsv_variants", "mc_payoff",
                 "affine_rk4")
REHEARSAL_RTOL = 1e-13
RULE = ("inv_vega", "dp_dforward", "dp_dstrike", "dp_dttm", "dp_ddiscfactor")
# bench.py's start point of the LM benchmark, PARAMS5 [sigma0, theta, kappa1, beta, volvol]
P0 = np.array([0.8, 1.0, 2.21, 0.15, 1.85])
# a coarse RK4 keeps the CPU's torch-op references short; the BTC chain's
# first LM residuals are finite at 60 steps a year
YEAR_STEPS = 60


def f64(x):
    return torch.as_tensor(x, dtype=torch.float64)


def _btc_panel():
    """(price, forward, strike, ttm, discfactor, sgn) of the BTC chain's
    padded (4, 15) panel: prices at the mid vols, 0 on the padded slots."""
    chain = svt.get_btc_test_chain_data()
    _, grid, market, _ = tfc._chain_targets(chain, True, "cpu")
    price = bsm.compute_bsm_vanilla_price(
        forward=grid.forwards[:, None], strike=grid.strikes, ttm=grid.ttms[:, None],
        vol=f64(market), optiontype=grid.optioncodes, discfactor=grid.discfactors[:, None])
    return bsm._broadcast_inputs(grid.forwards[:, None], grid.ttms[:, None], grid.strikes,
                                 price, grid.discfactors[:, None], grid.optioncodes)


def _edge_panel():
    """calls and puts from deep in to deep out of the money at three
    maturities and vols, a tiny ttm, and unbracketed and NaN prices."""
    moneyness = np.array([0.3, 0.5, 0.8, 1.0, 1.25, 2.0, 3.5])
    rows = []
    for ttm, vol in ((0.02, 1.5), (0.5, 0.6), (2.0, 0.25)):
        for call in (True, False):
            for m in moneyness:
                rows.append((1.3, 1.3 * m, ttm, vol, 0.97, call))
    rows += [(1.0, 1.0, 1e-6, 0.5, 1.0, True), (1.0, 1.05, 1e-6, 2.0, 1.0, False)]
    fwd, strike, ttm, vol, disc, call = (np.array(c) for c in zip(*rows))
    price = bsm.compute_bsm_vanilla_price(forward=f64(fwd), strike=f64(strike), ttm=f64(ttm),
                                          vol=f64(vol), optiontype=np.where(call, "C", "P"),
                                          discfactor=f64(disc)).numpy()
    # below any vol's price, above any vol's price, NaN
    price[:3] = -0.01
    price[3:5] = 2.0 * fwd[3:5]
    price[5] = np.nan
    return tuple(f64(a) for a in (price, fwd, strike, ttm, disc, np.where(call, 1.0, -1.0)))


def _panel(kind):
    if kind == "btc":
        return tuple(x.contiguous() for x in _btc_panel())
    return _edge_panel()


def _plain(inputs, nb_bisect=24, nb_newton=4):
    """the plain version's vol and, at it, the rule's five inputs."""
    vol = bsm._fast_iv_impl(*inputs, nb_bisect, nb_newton)
    _, forward, strike, ttm, discfactor, sgn = inputs
    inv_vega, partials = bsm._inverse_vega_and_partials(vol, forward, strike, ttm, discfactor,
                                                        sgn, 1e-12 * forward)
    return (vol, inv_vega) + tuple(partials)


def _scaled_gap(out, ref) -> float:
    """max |out - ref| / max(|ref|, 1), inf where the NaN patterns differ."""
    out, ref = np.asarray(out), np.asarray(ref)
    if not np.array_equal(np.isnan(out), np.isnan(ref)):
        return float("inf")
    ok = ~np.isnan(ref)
    return float(np.max(np.abs(out[ok] - ref[ok]) / np.maximum(np.abs(ref[ok]), 1.0),
                        initial=0.0))


# --------------------------------------------------------------------------
# the wrapper's refusals
# --------------------------------------------------------------------------

def test_wrapper_raises_on_a_cpu_tensor():
    with pytest.raises(ValueError, match="CUDA tensors"):
        bsm.fast_iv_cuda(*_edge_panel())


def test_wrapper_raises_on_a_wrong_dtype():
    inputs = list(_edge_panel())
    inputs[2] = inputs[2].to(torch.float32)
    with pytest.raises(TypeError, match="float64"):
        bsm.fast_iv_cuda(*inputs)


def test_wrapper_raises_on_a_non_contiguous_input():
    inputs = list(_btc_panel())
    assert not inputs[1].is_contiguous()
    inputs = [x.contiguous() for x in inputs[:1]] + inputs[1:]
    with pytest.raises(ValueError, match="contiguous"):
        bsm.fast_iv_cuda(*inputs)


def test_wrapper_raises_on_two_shapes_and_on_a_negative_stage_count():
    inputs = list(_edge_panel())
    with pytest.raises(ValueError, match="one shape"):
        bsm.fast_iv_cuda(*inputs[:5], inputs[5][:-1])
    with pytest.raises(ValueError, match="stage counts"):
        bsm.fast_iv_cuda(*inputs, -1, 4)


def test_cpu_panels_take_the_plain_version():
    """a CPU panel takes ``_FastIVCore`` (the torch ops) and launches nothing."""
    before = bsm.fast_iv_cuda.launches
    inputs = _edge_panel()
    out = svt.infer_bsm_implied_vol_fast(forward=inputs[1], ttm=inputs[3], strike=inputs[2],
                                         given_price=inputs[0], discfactor=inputs[4],
                                         optiontype=np.where(inputs[5] > 0, "C", "P"))
    assert torch.equal(torch.nan_to_num(out), torch.nan_to_num(bsm._fast_iv_impl(*inputs, 24, 4)))
    assert bsm.fast_iv_cuda.launches == before == 0


@pytest.fixture
def csrc_copy(tmp_path, monkeypatch):
    copy = tmp_path / "csrc"
    shutil.copytree(_build.CSRC_DIR, copy)
    monkeypatch.setattr(_build, "CSRC_DIR", copy)
    return copy


def test_digest_follows_the_fast_iv_source_alone(csrc_copy):
    before = {name: _build.source_digest(name) for name in OTHER_KERNELS + ("fast_iv",)}
    assert len(set(before.values())) == len(before)
    src = csrc_copy / "fast_iv.cu"
    src.write_text(src.read_text() + "\n// edited\n")
    assert _build.source_digest("fast_iv") != before["fast_iv"]
    assert {name: _build.source_digest(name) for name in OTHER_KERNELS} == {
        name: before[name] for name in OTHER_KERNELS}


def test_fast_iv_source_adds_no_header():
    src = (CSRC / "fast_iv.cu").read_text()
    assert 'extern "C" int fast_iv_launch(' in src
    assert "#include \"" not in src


# --------------------------------------------------------------------------
# the rehearsal on the CPU
# --------------------------------------------------------------------------

@pytest.fixture(scope="module")
def launch(tmp_path_factory):
    """the C entry point of ``csrc/fast_iv.cu`` built for the CPU against the
    stand-in runtime."""
    if shutil.which("g++") is None:
        pytest.skip("needs g++ to compile the kernel source for the CPU")
    src, n = re.subn(r"(\w+(?:<\w+>)?)<<<(.*?)>>>\(", r"cuda_stub::launch(\1, \2, ",
                     (CSRC / "fast_iv.cu").read_text(), flags=re.S)
    assert n == 1
    out_dir = tmp_path_factory.mktemp("fast_iv_rehearsal")
    cpp, lib = out_dir / "fast_iv.cpp", out_dir / "libfast_iv.so"
    cpp.write_text(src)
    subprocess.run(["g++", "-std=c++20", "-O2", "-ffp-contract=off", "-fPIC", "-shared",
                    "-pthread", f"-I{STUB}", f"-I{CSRC}", "-o", str(lib), str(cpp)],
                   check=True, capture_output=True, text=True, timeout=300)
    fn = ctypes.CDLL(str(lib)).fast_iv_launch
    fn.argtypes, fn.restype = bsm.FAST_IV_ARGTYPES, ctypes.c_int
    return fn


def run_kernel(fn, given_price, forward, strike, ttm, discfactor, sgn, nb_bisect=24,
               nb_newton=4):
    """the rehearsal's six outputs as CPU tensors, for the signature of
    ``fast_iv_cuda``."""
    inputs = [np.ascontiguousarray(x.detach().numpy(), dtype=np.float64)
              for x in (given_price, forward, strike, ttm, discfactor, sgn)]
    outputs = [np.full(inputs[0].shape, -7.0) for _ in range(6)]
    n = inputs[0].size
    err = fn(*(a.ctypes.data for a in inputs + outputs), n, nb_bisect, nb_newton, None)
    assert err == 0
    return tuple(torch.from_numpy(a) for a in outputs)


@pytest.mark.parametrize("kind", ["btc", "edges"])
def test_rehearsal_matches_the_plain_version(launch, kind):
    inputs = _panel(kind)
    ref = _plain(inputs)
    out = run_kernel(launch, *inputs)
    vol = out[0].numpy()
    assert np.isnan(vol).sum() >= (8 if kind == "btc" else 6)
    assert np.isfinite(vol).sum() >= 35
    for name, o, r in zip(("vol",) + RULE, out, ref):
        assert _scaled_gap(o.numpy(), r.numpy()) <= REHEARSAL_RTOL, name
    # the rule's inputs where the vol is NaN: 1/vega 0, the partials at vol 1
    nan = np.isnan(vol)
    assert np.all(out[1].numpy()[nan] == 0.0) and np.all(np.isfinite(out[2].numpy()))


def test_rehearsal_takes_the_stage_counts_and_a_ragged_block(launch):
    """other stage counts (none included) against the plain version, and
    148 slots (a block of 128 and a ragged one of 20)."""
    edges, btc = _edge_panel(), _panel("btc")
    inputs = tuple(torch.cat([e, b.reshape(-1), e]) for e, b in zip(edges, btc))
    assert inputs[0].numel() == 148
    for stages in ((24, 4), (10, 2), (30, 0), (0, 0)):
        out, ref = run_kernel(launch, *inputs, *stages), _plain(inputs, *stages)
        gaps = [_scaled_gap(o.numpy(), r.numpy()) for o, r in zip(out, ref)]
        assert max(gaps) <= REHEARSAL_RTOL, (stages, gaps)


# --------------------------------------------------------------------------
# the autograd.Function's rules with a stand-in for the card library
# --------------------------------------------------------------------------

@pytest.fixture(params=["plain", "rehearsal"])
def kernel_path(request, monkeypatch):
    """routes CPU panels through ``_FastIVKernel`` with a stand-in for
    ``fast_iv_cuda``; returns the stand-in's launch count and name."""
    if request.param == "rehearsal":
        fn = request.getfixturevalue("launch")
        inner = lambda *a: run_kernel(fn, *a)
    else:
        inner = lambda *a: _plain(a[:6], *a[6:])
    counts = {"launches": 0, "stand_in": request.param}

    def stand_in(given_price, forward, strike, ttm, discfactor, sgn, nb_bisect=24, nb_newton=4):
        inputs = (given_price, forward, strike, ttm, discfactor, sgn)
        assert all(x.is_contiguous() and x.shape == given_price.shape for x in inputs)
        counts["launches"] += 1
        return inner(*inputs, nb_bisect, nb_newton)

    monkeypatch.setattr(bsm, "fast_iv_cuda", stand_in)
    monkeypatch.setattr(bsm, "_takes_kernel", lambda given_price: True)
    return counts


def _assert_close(out, ref, exact: bool, rtol=REHEARSAL_RTOL):
    if exact:
        assert torch.equal(torch.nan_to_num(out, nan=-1.0), torch.nan_to_num(ref, nan=-1.0))
    else:
        assert _scaled_gap(out.numpy(), ref.numpy()) <= rtol


def _kernel_fast(*a):
    return bsm._FastIVKernel.apply(*a, 24, 4)[0]


def _core_fast(*a):
    return bsm._FastIVCore.apply(*a, 24, 4)


def test_values_jvp_and_backward_match_the_fast_core(kernel_path):
    inputs = _panel("edges")
    exact = kernel_path["stand_in"] == "plain"
    _assert_close(_kernel_fast(*inputs), _core_fast(*inputs), exact)
    assert kernel_path["launches"] == 1
    rng = np.random.default_rng(5)
    tangents = tuple(f64(rng.normal(size=inputs[0].shape)) for _ in range(5))
    sgn = inputs[5]
    _, out = jvp(lambda *a: _kernel_fast(*a, sgn), inputs[:5], tangents)
    _, ref = jvp(lambda *a: _core_fast(*a, sgn), inputs[:5], tangents)
    _assert_close(out, ref, exact)
    # NaN vols carry a zero tangent
    assert bool((out[torch.isnan(_core_fast(*inputs))] == 0.0).all())
    cot = f64(rng.normal(size=inputs[0].shape))
    leaves = [x.clone().requires_grad_(True) for x in inputs[:5]]
    out = torch.autograd.grad(_kernel_fast(*leaves, sgn), leaves, grad_outputs=cot)
    ref = torch.autograd.grad(_core_fast(*leaves, sgn), leaves, grad_outputs=cot)
    for o, r in zip(out, ref):
        _assert_close(o, r, exact)
    assert kernel_path["launches"] == 3


def test_vmap_folds_a_batch_into_one_launch(kernel_path):
    inputs = _panel("btc")
    scales = f64([1.0, 0.97, 1.04])[:, None, None]
    prices = inputs[0] * scales
    out = vmap(lambda p: _kernel_fast(p, *inputs[1:]))(prices)
    assert kernel_path["launches"] == 1
    for b in range(3):
        _assert_close(out[b], _core_fast(prices[b], *inputs[1:]),
                      kernel_path["stand_in"] == "plain")
    # a batch of tangents under jacfwd: the primal launches once
    J = jacfwd(lambda p: _kernel_fast(p, *inputs[1:]))(inputs[0])
    J_ref = jacfwd(lambda p: _core_fast(p, *inputs[1:]))(inputs[0])
    assert kernel_path["launches"] == 2
    _assert_close(J, J_ref, kernel_path["stand_in"] == "plain")


def test_higher_order_takes_the_kernels_vol(kernel_path):
    """``higher_order=True`` on the kernel route: the kernel's vol, then the
    two Newton steps; its first and second price derivatives against the CPU
    route, which differentiates through the torch ops of the solve."""
    price, forward, strike, ttm, discfactor, sgn = _panel("btc")
    types = np.where(sgn.numpy() > 0, "C", "P")

    def iv(p, route_kernel):
        with pytest.MonkeyPatch.context() as m:
            if not route_kernel:
                m.setattr(bsm, "_takes_kernel", lambda given_price: False)
            return bsm.infer_bsm_implied_vol_fast(forward, ttm, strike, p, discfactor, types,
                                                  higher_order=True)

    ones = torch.ones_like(price)
    second = lambda kernel: jvp(lambda p: jvp(lambda q: iv(q, kernel), (p,), (ones,))[1],
                                (price,), (ones,))
    (d1, d2), (d1_ref, d2_ref) = second(True), second(False)
    assert kernel_path["launches"] >= 1
    _assert_close(iv(price, True), iv(price, False), kernel_path["stand_in"] == "plain")
    for out, ref in ((d1, d1_ref), (d2, d2_ref)):
        ok = torch.isfinite(ref) & (ref != 0.0)
        assert bool(ok.sum() > 30)
        rel = ((out - ref).abs() / ref.abs())[ok]
        assert float(rel.max()) <= 1e-8


@pytest.fixture(scope="module")
def lm_problem():
    chain = svt.get_btc_test_chain_data()
    vs, grid, market, weights = tfc._chain_targets(chain, True, "cpu")
    problem = (grid.ttms, grid.forwards, grid.discfactors, grid.strikes, grid.optioncodes,
               grid.mask, f64(market), f64(np.sqrt(weights)), f64(vs))
    return chain, problem, tuple(float(t) for t in chain.ttms)


def _residuals(problem, ttms):
    return tfc._lm_residuals(*problem, ttms_static=ttms, year_steps=YEAR_STEPS,
                             constraints_type=svt.ConstraintsType.UNCONSTRAINT)


@pytest.fixture(scope="module")
def torch_op_jacobian(lm_problem):
    _, problem, ttms = lm_problem
    return residuals_and_jacobian(_residuals(problem, ttms), f64(P0))


def test_jacfwd_through_lm_residuals_matches_the_torch_op_path(kernel_path, lm_problem,
                                                               torch_op_jacobian):
    _, problem, ttms = lm_problem
    J_ref, r_ref = torch_op_jacobian
    J, r = residuals_and_jacobian(_residuals(problem, ttms), f64(P0))
    # one launch for the jacfwd pass: its five columns combine the saved rule
    assert kernel_path["launches"] == 1
    exact = kernel_path["stand_in"] == "plain"
    _assert_close(r, r_ref, exact)
    scale = torch.clamp(J_ref.abs().amax(dim=0), min=1e-300)
    gap = float(((J - J_ref).abs() / scale).max())
    assert gap == 0.0 if exact else gap <= 1e-12


def test_vmap_over_three_chains_equals_three_single_calls(kernel_path, lm_problem):
    """the sweep's shape: the residuals and their Jacobian vmapped over three
    chains (their own parameters and vol scalers) in one launch."""
    _, problem, ttms = lm_problem
    scales = f64([1.0, 0.95, 1.05])
    pars = f64(P0) * torch.stack([f64([1.0] * 5), f64([1.01, 0.99, 1.05, 0.9, 1.02]),
                                  f64([0.98, 1.02, 0.95, 1.1, 0.97])])
    batched = [torch.stack([x] * 3) for x in problem[:-1]] + [problem[-1] * scales]

    def one(p, *prob):
        return residuals_and_jacobian(_residuals(prob, ttms), p)

    J, r = vmap(one)(pars, *batched)
    assert kernel_path["launches"] == 1
    for b in range(3):
        J_b, r_b = one(pars[b], *[x[b] for x in batched])
        assert torch.equal(torch.nan_to_num(r[b]), torch.nan_to_num(r_b))
        # the Fourier pricing sums in another order under vmap
        scale = torch.clamp(J_b.abs().amax(dim=0), min=1e-300)
        assert float(((J[b] - J_b).abs() / scale).max()) <= 1e-12


def test_an_lm_fit_launches_once_and_twice_an_iteration(kernel_path, lm_problem):
    chain, _, _ = lm_problem
    p0 = svt.LogSvParams(sigma0=0.8, theta=1.0, kappa1=2.21, kappa2=2.21, beta=0.15,
                         volvol=1.85)
    fit, cost = svt.calibrate_logsv_lm_on_device(chain, p0, nb_iters=2, year_steps=YEAR_STEPS,
                                                 device="cpu")
    # the first cost, then each iteration's jacfwd pass and candidate
    assert kernel_path["launches"] == 1 + 2 * 2
    assert np.isfinite(cost) and np.isfinite(fit.sigma0)
