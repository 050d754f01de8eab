"""The LogSV Monte-Carlo kernel's plain PyTorch version against the JAX
package's Pallas kernel, and the CUDA kernel against the plain version.

(a) the counter hash: bit for bit against ``pallas_mc._counter_bits``;
(b) the polynomial ln and cos(pi u) against libm: measured max errors 1.3e-6
    and 6.02e-6 (the JAX package documents ~2e-6 and ~6e-6); limits 2e-6 and
    6.5e-6;
(c) path by path against ``simulate_logsv_terminal_pallas(interpret=True)``:
    2^16 paths (two TPU blocks), ttm 0.25, spot and inverse measure.  In
    interpret mode ``pl.reciprocal(approx=True)`` evaluates 1/bf16(sigma)
    in float32, so the plain version is run with that reciprocal injected.
    The other differences are XLA's FMA contraction and transcendental
    ulps.  Measured: median relative gap of sigma 2.1e-7 (both measures),
    max 2.7e-4 (spot) and 1.5e-4 (inverse); limits 1e-6 and 1e-3;
(d) with its default exact reciprocal, moments against the JAX scan engine
    (different random streams), to 0.02 as ``tests/test_pallas_mc.py`` does;
(e) on a CUDA device only: the hand-written kernel against the plain
    version, path by path, within 1e-4 (it skips here: the kernel has no
    CPU mode; tests/test_torch_kernel_rehearsal.py runs its source on the
    CPU).
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from _torch_port import cuda_device  # noqa: F401  (fixture)

from stochvolmodels_tpu.models.logsv.pricer import simulate_logsv_terminal as jax_scan
from stochvolmodels_tpu.ops import pallas_mc
from stochvolmodels_torch.ops import cuda_mc

BTC = dict(theta=1.0413, kappa1=3.1844, kappa2=3.058, beta=0.1514, volvol=1.8458)
SIGMA0 = 0.8376


def bf16_reciprocal(s: torch.Tensor) -> torch.Tensor:
    return 1.0 / s.to(torch.bfloat16).float()


def test_log_coefficients_match():
    np.testing.assert_array_equal(cuda_mc.LOG_C, pallas_mc._LOG_C)


@pytest.mark.parametrize("seed,salt,stream", [(7, 0, 0), (7, 90, 1), (-3, 5, 1),
                                              (2**31 - 1, 123456, 0), (24 + 7919 * 3, 17, 1)])
def test_counter_bits_bit_exact(seed, salt, stream):
    ref = np.asarray(pallas_mc._counter_bits((256, 128), jnp.int32(seed), salt, stream))
    out = cuda_mc.counter_bits(torch.tensor(seed, dtype=torch.int64), salt, stream,
                               torch.arange(256 * 128, dtype=torch.int64))
    np.testing.assert_array_equal(out.numpy(), ref.astype(np.int64).ravel())


def test_poly_log_and_cospi_accuracy():
    """the same grid as the JAX package's test of its polynomials."""
    u = np.linspace(0.0, 1.0, 512 * 128 + 2)[1:-1].astype(np.float32)
    ut = torch.as_tensor(u)
    u64 = u.astype(np.float64)
    assert np.max(np.abs(cuda_mc.poly_log(ut).numpy() - np.log(u64))) < 2e-6
    assert np.max(np.abs(cuda_mc.poly_cospi(ut).numpy() - np.cos(np.pi * u64))) < 6.5e-6


def test_uniforms_in_open_interval():
    bits = torch.tensor([0, 1, 511, 512, 0xFFFFFFFF], dtype=torch.int64)
    u = cuda_mc.uniform_from_bits(bits)
    assert torch.all((u > 0.0) & (u < 1.0))


@pytest.mark.parametrize("is_spot_measure", [True, False])
def test_plain_version_matches_interpret_kernel_path_by_path(is_spot_measure):
    n = 1 << 16
    rng = np.random.default_rng(11)
    x0 = rng.normal(0.0, 0.05, n).astype(np.float32)
    s0 = rng.uniform(0.6, 1.1, n).astype(np.float32)
    q0 = rng.uniform(0.0, 0.05, n).astype(np.float32)
    kw = dict(BTC, ttm=0.25, is_spot_measure=is_spot_measure,
              vol_backbone_eta=1.0 if is_spot_measure else 1.1)
    xj, sj, qj = map(np.asarray, pallas_mc.simulate_logsv_terminal_pallas(
        seed=7, x0=jnp.asarray(x0), sigma0=jnp.asarray(s0), qvar0=jnp.asarray(q0),
        interpret=True, **kw))
    xt, st, qt = (t.numpy() for t in cuda_mc.simulate_logsv_terminal_torch(
        7, torch.as_tensor(x0), torch.as_tensor(s0), torch.as_tensor(q0),
        reciprocal=bf16_reciprocal, **kw))
    rel = np.abs(st - sj) / sj
    assert np.median(rel) <= 1e-6
    assert np.max(rel) <= 1e-3
    assert np.max(np.abs(xt - xj)) <= 1e-3
    assert np.max(np.abs(qt - qj) / qj) <= 1e-3


def test_plain_version_moments_match_scan_engine():
    n = 1 << 15
    kw = dict(BTC, ttm=0.5)
    xt, st, qt = cuda_mc.simulate_logsv_terminal_torch(
        7, torch.zeros(n), torch.full((n,), SIGMA0), torch.zeros(n), **kw)
    xs, ss, qs = map(np.asarray, jax_scan(key=jax.random.key(7), x0=jnp.zeros(n),
                                          sigma0=jnp.full(n, SIGMA0), qvar0=jnp.zeros(n), **kw))
    xt, st, qt = (t.double().numpy() for t in (xt, st, qt))
    tol = 0.02
    assert np.all(np.isfinite(xt))
    assert abs(xt.mean() - xs.mean()) < tol
    assert abs(xt.std() - xs.std()) < tol
    assert abs(st.mean() - ss.mean()) < tol
    assert abs(qt.mean() - qs.mean()) < tol
    assert abs(np.exp(xt).mean() - 1.0) < 4.0 * tol   # martingale under the spot measure


def test_cuda_wrapper_refuses_cpu_tensors_and_dispatch_takes_plain():
    n = 256
    state = (torch.zeros(n), torch.full((n,), SIGMA0), torch.zeros(n))
    launches = cuda_mc.simulate_logsv_terminal_cuda.launches
    with pytest.raises(ValueError, match="CUDA tensors"):
        cuda_mc.simulate_logsv_terminal_cuda(3, *state, ttm=0.1, **BTC)
    with pytest.raises(ValueError, match="multiple of 128"):
        cuda_mc.simulate_logsv_terminal_kernel(3, *(t[:100] for t in state), ttm=0.1, **BTC)
    with pytest.raises(TypeError, match="float32"):
        cuda_mc.simulate_logsv_terminal_kernel(3, *(t.double() for t in state), ttm=0.1, **BTC)
    out = cuda_mc.simulate_logsv_terminal_kernel(3, *state, ttm=0.1, **BTC)
    ref = cuda_mc.simulate_logsv_terminal_torch(3, *state, ttm=0.1, **BTC)
    for a, b in zip(out, ref):
        torch.testing.assert_close(a, b, rtol=0.0, atol=0.0)
    assert cuda_mc.simulate_logsv_terminal_cuda.launches == launches


@pytest.mark.parametrize("seed,nb_path,expected", [(None, 100, (128, 24)), (7, 128, (128, 7)),
                                                   (5.0, 129, (256, 5))])
def test_engine_setup(seed, nb_path, expected):
    assert cuda_mc.engine_setup(seed, nb_path) == expected


def test_engine_setup_rejects_non_integer_seeds():
    with pytest.raises(TypeError):
        cuda_mc.engine_setup(1.5, 128)


@pytest.mark.gpu
@pytest.mark.parametrize("n", [1 << 18, (1 << 16) + 128])
@pytest.mark.parametrize("is_spot_measure", [True, False])
def test_cuda_kernel_matches_plain_version(cuda_device, is_spot_measure, n):  # noqa: F811
    """within 1e-4 (the update's FMAs and approximate 1/sigma, as chip_smoke.py
    holds it), under both measures, also with a half-empty last block of 256
    threads."""
    rng = np.random.default_rng(5)
    state = [torch.as_tensor(a.astype(np.float32), device=cuda_device)
             for a in (rng.normal(0.0, 0.1, n), rng.uniform(0.5, 1.2, n), rng.uniform(0.0, 0.1, n))]
    kw = dict(BTC, ttm=0.25, is_spot_measure=is_spot_measure,
              vol_backbone_eta=1.0 if is_spot_measure else 1.1)
    launches = cuda_mc.simulate_logsv_terminal_cuda.launches
    out = cuda_mc.simulate_logsv_terminal_cuda(9, *state, **kw)
    torch.cuda.synchronize()
    assert cuda_mc.simulate_logsv_terminal_cuda.launches == launches + 1
    ref = cuda_mc.simulate_logsv_terminal_torch(9, *state, **kw)
    for a, b in zip(out, ref):
        torch.testing.assert_close(a, b, rtol=1e-4, atol=1e-4)
