"""The variant study of the LogSV path loop (``ops/mc_variants.py``) against
the JAX package's TPU study and the production plain version.

(a) ``no-prng`` against the TPU study's ``_kernel`` (imported from
    ``scripts/bench_pallas_variants.py`` by path), run in its own
    ``pallas_call`` under ``pltpu.InterpretParams()`` on one 256 x 128 block,
    8 steps at dt = 1/360.  Only ``no-prng`` can be held against it on the
    CPU: there the TPU PRNG gives every element of a block the same bits.
    The plain version takes 1/bf16(sigma), the interpret mode's approximate
    reciprocal.  Measured max relative gap 1.8e-7; limit 1e-6;
(b) ``poly-bm`` against ``x + sigma + qvar`` of the production plain version
    ``simulate_logsv_terminal_torch`` at the study's parameters: 91 steps at
    dt = 1/360 (ttm 91/360 at 359 steps a year).  The two associate the ln
    sigma update differently.  Measured max gap 9.5e-7 x max(|out|, 1);
    limit 1e-5 x max(|out|, 1), since x + sigma + qvar crosses 0 on some paths;
(c) the variants that simulate the model (``VALID``) have sanity means
    within 4 standard errors of ``poly-bm``'s at 2^15 paths;
(d) every variant gives finite outputs, because the polynomial-ln radius is
    clamped at 0 as the production Box-Muller clamps it: the polynomial ln is
    positive on 7 of the 2^23 uniforms;
(e) on a CUDA device only: the kernel against the plain version, per
    variant (it skips here: the kernel has no CPU mode).
"""
import functools
import importlib.util
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from _torch_port import cuda_device  # noqa: F401  (fixture)
from jax.experimental import pallas as pl
from jax.experimental.pallas import tpu as pltpu

from stochvolmodels_torch.ops import cuda_mc, mc_variants
from stochvolmodels_torch.utils.funcs import set_time_grid

DT = 1.0 / 360.0
VALID = ("full-fast", "full-sincos", "poly-bm2", "poly-exp", "poly-all", "sigma-carry", "one-prng")


def bf16_reciprocal(s: torch.Tensor) -> torch.Tensor:
    return 1.0 / s.to(torch.bfloat16).float()


def tpu_study():
    path = Path(__file__).resolve().parents[1] / "scripts" / "bench_pallas_variants.py"
    spec = importlib.util.spec_from_file_location("bench_pallas_variants", path)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


def test_no_prng_matches_the_tpu_study_kernel_in_interpret_mode():
    x0 = np.random.default_rng(3).normal(0.0, 0.1, (256, 128)).astype(np.float32)
    kernel = functools.partial(tpu_study()._kernel, nb_steps=8, dt=DT, variant="no-prng",
                               unroll=2)
    block = pl.BlockSpec((256, 128), lambda i: (i, 0))
    with jax.enable_x64(False):
        ref = pl.pallas_call(kernel, grid=(1,),
                             in_specs=[pl.BlockSpec(memory_space=pltpu.SMEM), block],
                             out_specs=block,
                             out_shape=jax.ShapeDtypeStruct((256, 128), jnp.float32),
                             interpret=pltpu.InterpretParams())(jnp.asarray([5], jnp.int32),
                                                                jnp.asarray(x0))
    ref = np.asarray(ref).ravel()
    out = mc_variants.run_variant_torch(5, torch.as_tensor(x0.ravel()), 8, DT, "no-prng",
                                        reciprocal=bf16_reciprocal).numpy()
    assert np.max(np.abs(out - ref) / np.abs(ref)) <= 1e-6


def test_poly_bm_is_the_production_step():
    n = 1 << 13
    nb_steps, dt, _ = set_time_grid(91 / 360, 359)
    assert nb_steps == 91 and np.float32(dt) == np.float32(DT)
    assert np.float32(np.sqrt(dt)) == np.float32(np.sqrt(DT))
    x0 = torch.as_tensor(np.random.default_rng(4).normal(0.0, 0.05, n).astype(np.float32))
    x, sigma, qvar = cuda_mc.simulate_logsv_terminal_torch(
        11, x0, torch.full((n,), float(mc_variants.SIGMA0)), torch.zeros(n), ttm=91 / 360,
        nb_steps_per_year=359, theta=1.04, kappa1=3.18, kappa2=3.06, beta=0.15, volvol=1.85)
    ref = (x + sigma + qvar).numpy()
    out = mc_variants.run_variant_torch(11, x0, 91, DT, "poly-bm").numpy()
    assert np.all(np.abs(out - ref) <= 1e-5 * np.maximum(np.abs(ref), 1.0))


@pytest.fixture(scope="module")
def poly_bm_at_2_15():
    return mc_variants.run_variant_torch(0, torch.zeros(1 << 15), 91, DT, "poly-bm").double()


@pytest.mark.parametrize("variant", VALID)
def test_valid_variants_agree_with_poly_bm_in_distribution(poly_bm_at_2_15, variant):
    ref = poly_bm_at_2_15
    out = mc_variants.run_variant_torch(0, torch.zeros(1 << 15), 91, DT, variant).double()
    stderr = np.hypot(float(ref.std()), float(out.std())) / np.sqrt(ref.numel())
    assert abs(float(out.mean() - ref.mean())) < 4.0 * stderr


@pytest.mark.parametrize("variant", mc_variants.VARIANTS)
def test_every_variant_is_finite(variant):
    x0 = torch.as_tensor(np.random.default_rng(6).normal(0.0, 0.1, 1 << 12).astype(np.float32))
    out = mc_variants.run_variant_torch(2, x0, 120, DT, variant)
    assert out.shape == x0.shape and out.dtype == torch.float32
    assert bool(torch.isfinite(out).all())


def test_polynomial_log_is_positive_on_seven_uniforms():
    """why the radius is clamped: without the clamp, sqrt(-2 ln u) of these
    uniforms is NaN."""
    u = cuda_mc.uniform_from_bits(torch.arange(1 << 23, dtype=torch.int64) << 9)
    positive = cuda_mc.poly_log(u) > 0.0
    assert int(positive.sum()) == 7
    assert float(u[positive].min()) > 1.0 - 1e-5


def test_cuda_wrapper_refuses_what_the_kernel_does_not_take():
    x0 = torch.zeros(256)
    launches = mc_variants.run_variant_cuda.launches
    with pytest.raises(ValueError, match="CUDA tensors"):
        mc_variants.run_variant_cuda(1, x0, 4, DT, "poly-bm")
    with pytest.raises(ValueError, match="unknown variant"):
        mc_variants.run_variant_cuda(1, x0, 4, DT, "poly-everything")
    with pytest.raises(ValueError, match="multiple of 128"):
        mc_variants.run_variant_torch(1, x0[:100], 4, DT, "poly-bm")
    with pytest.raises(TypeError, match="float32"):
        mc_variants.run_variant_torch(1, x0.double(), 4, DT, "poly-bm")
    assert mc_variants.run_variant_cuda.launches == launches


@pytest.mark.gpu
@pytest.mark.parametrize("variant", mc_variants.VARIANTS)
def test_cuda_kernel_matches_plain_version(cuda_device, variant):  # noqa: F811
    x0 = torch.as_tensor(np.random.default_rng(5).normal(0.0, 0.1, 1 << 18).astype(np.float32),
                         device=cuda_device)
    launches = mc_variants.run_variant_cuda.launches
    out = mc_variants.run_variant_cuda(9, x0, 91, DT, variant)
    torch.cuda.synchronize()
    assert mc_variants.run_variant_cuda.launches == launches + 1
    ref = mc_variants.run_variant_torch(9, x0, 91, DT, variant)
    torch.testing.assert_close(out, ref, rtol=1e-4, atol=1e-4)
