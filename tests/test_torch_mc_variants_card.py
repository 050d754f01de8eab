"""The variant study's CUDA kernel (``csrc/logsv_variants.cu``) on a card.

This file imports no JAX, so that it runs where the card is.  Both tests
are marked ``gpu`` and skip without a CUDA device: the kernel has no CPU
mode.

(a) every variant against its plain version (``run_variant_torch``) at 2^18
    paths x 91 steps, rtol = atol = 1e-4: the kernel's multiply-adds and
    approximate 1/sigma round otherwise than the plain version's one
    rounding per operation;
(b) ``poly-bm`` against ``x + sigma + qvar`` of the production kernel
    ``simulate_logsv_terminal_cuda`` at the study's parameters (eta = 1,
    spot measure, 91 steps at dt = 1/360: ttm 91/360 at 359 steps a year),
    path by path within 1e-5 max(|out|, 1), the limit that
    tests/test_torch_mc_variants.py holds the two plain versions to: the two
    kernels run one step and differ in the order of sigma^2 dt's product and
    in the start (logsv_mc takes exp(log sigma0)).
"""
import numpy as np
import pytest
import torch

from stochvolmodels_torch.ops import cuda_mc, mc_variants
from stochvolmodels_torch.utils.funcs import set_time_grid

DT = 1.0 / 360.0


@pytest.fixture
def cuda_device():
    """a CUDA device, or a skip: the hand-written kernels run on the card only."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the hand-written kernel has no CPU mode")
    return torch.device("cuda")


@pytest.mark.gpu
@pytest.mark.parametrize("variant", mc_variants.VARIANTS)
def test_cuda_kernel_matches_plain_version(cuda_device, variant):
    x0 = torch.as_tensor(np.random.default_rng(5).normal(0.0, 0.1, 1 << 18).astype(np.float32),
                         device=cuda_device)
    launches = mc_variants.run_variant_cuda.launches
    out = mc_variants.run_variant_cuda(9, x0, 91, DT, variant)
    torch.cuda.synchronize()
    assert mc_variants.run_variant_cuda.launches == launches + 1
    ref = mc_variants.run_variant_torch(9, x0, 91, DT, variant)
    torch.testing.assert_close(out, ref, rtol=1e-4, atol=1e-4)


@pytest.mark.gpu
def test_poly_bm_kernel_is_the_production_kernels_step(cuda_device):
    n = 1 << 18
    nb_steps, dt, _ = set_time_grid(91 / 360, 359)
    assert nb_steps == 91 and np.float32(dt) == np.float32(DT)
    x0 = torch.as_tensor(np.random.default_rng(4).normal(0.0, 0.05, n).astype(np.float32),
                         device=cuda_device)
    x, sigma, qvar = cuda_mc.simulate_logsv_terminal_cuda(
        11, x0, torch.full_like(x0, float(mc_variants.SIGMA0)), torch.zeros_like(x0),
        ttm=91 / 360, nb_steps_per_year=359, theta=1.04, kappa1=3.18, kappa2=3.06, beta=0.15,
        volvol=1.85)
    ref = x + sigma + qvar
    out = mc_variants.run_variant_cuda(11, x0, 91, DT, "poly-bm")
    torch.cuda.synchronize()
    assert bool(torch.isfinite(out).all())
    assert bool(((out - ref).abs() <= 1e-5 * ref.abs().clamp(min=1.0)).all())
