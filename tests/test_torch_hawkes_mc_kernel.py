"""The Hawkes Monte-Carlo kernel's plain PyTorch version against the JAX
package's Pallas kernel, and the CUDA kernel against the plain version.

(a) the uint32 bits of all six streams equal the TPU kernel's interpret-mode
    counter hash, and the two-normal ``_PathNormals.step`` the LogSV, Heston
    and rough kernels draw is unchanged;
(b) path by path against ``simulate_hawkesjd_terminal_pallas(interpret=True)``
    at 2^16 paths (two TPU blocks) and ttm 0.05 (91 steps at 1800/yr), from
    random starting states with lambda drawn around theta.  Both draw the
    same counter-hash stream; what differs is XLA's FMA contraction on the
    CPU, which can flip a thinning test and move a path by a whole jump.
    Measured, for the BTC defaults and for ``tests/test_pallas_mc.py``'s
    ``HAWKES_ARGS``: median absolute gap in x 1.3e-8 and 1.1e-8, median
    relative gap in lambda 0.0; maxima 3.2e-7 in x and 2.9e-7 relative in
    lambda; no path with a gap above 1e-3 (share 0.0).  Limits: medians
    1e-6, share of paths with a gap above 1e-3 at most 1e-3;
(c) moments of the plain version at 2^15 paths, ttm 0.5, 720 steps/yr,
    against the JAX scan engine by the rule of ``tests/test_pallas_mc.py``;
(d) the wrapper refuses CPU, float64 and misaligned input, and the dispatch
    sends CPU tensors to the plain version without a launch;
(e) on a CUDA device only: the kernel equals the plain version bit for bit,
    also with a half-empty last block (it skips here: the kernel has no CPU
    mode).
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from _torch_port import cuda_device  # noqa: F401  (fixture)

from stochvolmodels_tpu.models import hawkes_jd as jh
from stochvolmodels_tpu.ops import pallas_mc
from stochvolmodels_torch.ops import cuda_mc

# the BTC defaults, and the moments case of tests/test_pallas_mc.py
PARAMS = {
    "btc": {k: v for k, v in jh.HawkesJDParams().to_dict().items()
            if k not in ("lambda_p", "lambda_m", "risk_premia_gamma")},
    "hawkes_args": dict(mu=0.0, sigma=0.5, shift_p=0.05, mean_p=0.1, shift_m=-0.05,
                        mean_m=-0.1, theta_p=1.0, kappa_p=3.0, beta1_p=0.6, beta2_p=0.4,
                        theta_m=1.0, kappa_m=3.0, beta1_m=0.4, beta2_m=0.6),
}


def random_state(name, n, seed=11):
    """x around 0 and each lambda uniform in [theta/2, 2 theta]."""
    p = PARAMS[name]
    rng = np.random.default_rng(seed)
    return (rng.normal(0.0, 0.05, n).astype(np.float32),
            (rng.uniform(0.5, 2.0, n) * p["theta_p"]).astype(np.float32),
            (rng.uniform(0.5, 2.0, n) * p["theta_m"]).astype(np.float32))


@pytest.mark.parametrize("seed,nb_path", [(7, 300), (2 ** 31 + 5, 1 << 16)])
def test_stream_bits_equal_the_interpret_counter_hash(seed, nb_path):
    rng = cuda_mc._PathNormals(seed, nb_path, "cpu")
    rows = pallas_mc.BLOCK_ROWS
    assert cuda_mc.BLOCK_PATHS == rows * cuda_mc.LANES
    for step in (0, 5, 1799):
        for stream in range(6):
            got = rng.bits(step, stream).numpy().astype(np.uint32)
            for block in range((nb_path + cuda_mc.BLOCK_PATHS - 1) // cuda_mc.BLOCK_PATHS):
                ref = np.asarray(pallas_mc._counter_bits((rows, cuda_mc.LANES),
                                                         np.uint32((seed + block) % 2 ** 32),
                                                         step, stream)).ravel()
                part = got[block * cuda_mc.BLOCK_PATHS:(block + 1) * cuda_mc.BLOCK_PATHS]
                np.testing.assert_array_equal(part, ref[:part.shape[0]])
    z0, z1 = rng.step(5)
    u1, u2 = (cuda_mc.uniform_from_bits(rng.bits(5, s)) for s in (0, 1))
    r = torch.sqrt(torch.clamp(-2.0 * cuda_mc.poly_log(u1), min=0.0))
    c = cuda_mc.poly_cospi(u2)
    torch.testing.assert_close(z0, r * c, rtol=0.0, atol=0.0)
    assert torch.all(torch.abs(z1) <= r)


def path_gaps(name, n=1 << 16, ttm=0.05):
    """(x abs, lambda_p rel, lambda_m rel) gaps of the plain version against
    the interpret-mode Pallas kernel, path by path."""
    x0, lp0, lm0 = random_state(name, n)
    kw = dict(PARAMS[name], ttm=ttm)
    xj, lpj, lmj = map(np.asarray, pallas_mc.simulate_hawkesjd_terminal_pallas(
        seed=7, x0=jnp.asarray(x0), lambda_p0=jnp.asarray(lp0), lambda_m0=jnp.asarray(lm0),
        interpret=True, **kw))
    xt, lpt, lmt = (t.numpy() for t in cuda_mc.simulate_hawkesjd_terminal_torch(
        7, torch.as_tensor(x0), torch.as_tensor(lp0), torch.as_tensor(lm0), **kw))
    return np.abs(xt - xj), np.abs(lpt - lpj) / np.abs(lpj), np.abs(lmt - lmj) / np.abs(lmj)


@pytest.mark.parametrize("name", sorted(PARAMS))
def test_plain_version_matches_interpret_kernel_path_by_path(name):
    gaps = path_gaps(name)
    for gap in gaps:
        assert np.all(np.isfinite(gap))
        assert np.median(gap) <= 1e-6
    flipped = np.mean(np.max(np.stack(gaps), axis=0) > 1e-3)
    assert flipped <= 1e-3


def test_plain_version_moments_match_jax_scan():
    n, ttm, lam0 = 1 << 15, 0.5, 1.0
    kw = dict(PARAMS["hawkes_args"], ttm=ttm, nb_steps_per_year=720)
    xt, lpt, lmt = (t.double().numpy() for t in cuda_mc.simulate_hawkesjd_terminal_torch(
        5, torch.zeros(n), torch.full((n,), lam0), torch.full((n,), lam0), **kw))
    xs, lps, lms = map(np.asarray, jh.simulate_hawkesjd_terminal(
        key=jax.random.key(5), x0=jnp.zeros(n), lambda_p0=jnp.full(n, lam0),
        lambda_m0=jnp.full(n, lam0), **kw))
    tol = 0.03
    assert np.all(np.isfinite(xt))
    assert abs(xt.mean() - xs.mean()) < tol
    assert abs(xt.std() - xs.std()) < 2.0 * tol
    assert abs(lpt.mean() - lps.mean()) < 3.0 * tol
    assert abs(lmt.mean() - lms.mean()) < 3.0 * tol
    assert abs(np.exp(xt).mean() - 1.0) < 4.0 * tol


def test_cuda_wrapper_refuses_cpu_float64_and_misaligned_input():
    n = 256
    state = (torch.zeros(n), torch.full((n,), 6.55), torch.full((n,), 8.5))
    kw = dict(PARAMS["btc"], ttm=0.01)
    launches = cuda_mc.simulate_hawkesjd_terminal_cuda.launches
    with pytest.raises(ValueError, match="CUDA tensors"):
        cuda_mc.simulate_hawkesjd_terminal_cuda(3, *state, **kw)
    with pytest.raises(TypeError, match="float32"):
        cuda_mc.simulate_hawkesjd_terminal_cuda(3, *(t.double() for t in state), **kw)
    with pytest.raises(ValueError, match="multiple of 128"):
        cuda_mc.simulate_hawkesjd_terminal_cuda(3, *(t[:100] for t in state), **kw)
    with pytest.raises(ValueError, match="one length"):
        cuda_mc.simulate_hawkesjd_terminal_kernel(3, state[0], state[1][:128], state[2], **kw)
    with pytest.raises(ValueError, match="no Hawkes MC kernel"):
        cuda_mc.simulate_hawkesjd_terminal_kernel(3, *(t.to("meta") for t in state), **kw)
    out = cuda_mc.simulate_hawkesjd_terminal_kernel(3, *state, **kw)
    ref = cuda_mc.simulate_hawkesjd_terminal_torch(3, *state, **kw)
    for a, b in zip(out, ref):
        torch.testing.assert_close(a, b, rtol=0.0, atol=0.0)
    assert cuda_mc.simulate_hawkesjd_terminal_cuda.launches == launches


@pytest.mark.gpu
@pytest.mark.parametrize("nb_path", [1 << 18, (1 << 16) + 128])
@pytest.mark.parametrize("name", sorted(PARAMS))
def test_cuda_kernel_matches_plain_version(cuda_device, name, nb_path):  # noqa: F811
    """bit for bit: the kernel's skipped logarithms and jump draws change no
    result.  (1 << 16) + 128 paths leave the last block of 256 half empty."""
    state = [torch.as_tensor(a, device=cuda_device) for a in random_state(name, nb_path, seed=5)]
    kw = dict(PARAMS[name], ttm=0.05)
    launches = cuda_mc.simulate_hawkesjd_terminal_cuda.launches
    out = cuda_mc.simulate_hawkesjd_terminal_cuda(9, *state, **kw)
    torch.cuda.synchronize()
    assert cuda_mc.simulate_hawkesjd_terminal_cuda.launches == launches + 1
    ref = cuda_mc.simulate_hawkesjd_terminal_torch(9, *state, **kw)
    for a, b in zip(out, ref):
        torch.testing.assert_close(a, b, rtol=0.0, atol=0.0)
