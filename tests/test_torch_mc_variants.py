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
(e) the kernel's multiply-adds as the plain version takes them for
    ``no-exp`` (``_run_abs_sigma_fused``): ``_fma`` rounds a * b + c once
    (against exact rational arithmetic, and on a sum whose float64 rounding
    is a float32 tie), and the fused step holds to the unfused one at the
    limits of (a) and (b) on the two non-model variants that are not chaotic
    (``alu-floor``, ``no-prng``; ``no-exp``, chaotic near sigma = 0, parts
    from its unfused step by 3.9e-4 within 8 steps, which is why its plain
    version is fused); the fused step refuses the variants whose sigma is
    not |1 + ln sigma|;
(f) the op counts tie the study's baseline to the production kernel, the
    wrapper refuses blocks other than 256 threads, and the SASS script
    reads two steps a pass from the study's source.

The kernel against the plain version runs on a CUDA device only, in
``tests/test_torch_mc_variants_card.py`` (a file that does not import JAX).
"""
import functools
import importlib.util
from fractions import Fraction
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import _torch_port  # noqa: F401  (one torch thread per test worker)
from jax.experimental import pallas as pl
from jax.experimental.pallas import tpu as pltpu

from stochvolmodels_torch.ops import cuda_mc, mc_variants
from stochvolmodels_torch.utils.funcs import set_time_grid

ROOT = Path(__file__).resolve().parents[1]
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


def test_cuda_wrapper_refuses_blocks_other_than_256():
    x0 = torch.zeros(256)
    launches = mc_variants.run_variant_cuda.launches
    assert mc_variants.BLOCK_ROWS == 256
    for block_rows in (32, 128, 512, 1024):
        with pytest.raises(ValueError, match="block of 256 threads"):
            mc_variants.run_variant_cuda(1, x0, 4, DT, "poly-bm", block_rows=block_rows)
    with pytest.raises(ValueError, match="unroll"):
        mc_variants.run_variant_cuda(1, x0, 4, DT, "poly-bm", unroll=1)
    assert mc_variants.run_variant_cuda.launches == launches


def test_poly_bm_ops_are_the_production_kernels():
    """poly-bm draws from the same ring as logsv_mc, so their integer counts
    agree; its float count is logsv_mc's less what only logsv_mc has: the
    eta sigma product of the x update (1) and the adj sigma multiply-add of
    the drift (2, an FMA counts two)."""
    f32, i32 = mc_variants.OPS_PER_STEP["poly-bm"]
    prod_f32, prod_i32 = cuda_mc.OPS_PER_STEP["logsv_mc"]
    assert i32 == prod_i32
    assert f32 == prod_f32 - 1 - 2
    assert set(mc_variants.OPS_PER_STEP) == set(mc_variants.VARIANTS)


def test_fma_rounds_once():
    # (1 + 2^-12) (1 - 2^-12 + 2^-24) 2^-24 + 1 = 1 + 2^-24 + 2^-60: float64
    # rounds it to the float32 tie 1 + 2^-24, which would round to even (1.0)
    a = torch.tensor([1.0 + 2.0 ** -12])
    b = torch.tensor([(1.0 - 2.0 ** -12 + 2.0 ** -24) * 2.0 ** -24])
    assert float((a.double() * b.double() + 1.0).float()) == 1.0
    assert float(mc_variants._fma(a, b, 1.0)) == 1.0 + 2.0 ** -23
    rng = np.random.default_rng(8)
    n = 3000
    x, y = (rng.normal(0.0, 1.0, n).astype(np.float32) for _ in range(2))
    z = rng.normal(0.0, 1.0, n).astype(np.float32)
    z[: n // 2] = (-(x[: n // 2].astype(np.float64) * y[: n // 2])
                   * (1.0 + rng.normal(0.0, 1e-7, n // 2))).astype(np.float32)   # cancellation
    got = mc_variants._fma(*(torch.as_tensor(v) for v in (x, y, z))).numpy()
    for xi, yi, zi, gi in zip(x, y, z, got):
        exact = Fraction(float(xi)) * Fraction(float(yi)) + Fraction(float(zi))
        near = np.float32(float(exact))
        candidates = (np.nextafter(near, np.float32(-np.inf)), near,
                      np.nextafter(near, np.float32(np.inf)))
        best = min(candidates, key=lambda v: (abs(Fraction(float(v)) - exact),
                                              int(np.float32(v).view(np.int32)) & 1))
        assert gi == best


@pytest.mark.parametrize("variant", ("alu-floor", "no-prng"))
@pytest.mark.parametrize("case", ("a", "b"))
def test_fused_plain_step_holds_to_the_unfused_one(variant, case):
    if case == "a":   # test (a): one 256 x 128 block, 8 steps, 1e-6 relative
        x0 = np.random.default_rng(3).normal(0.0, 0.1, 256 * 128).astype(np.float32)
        nb_steps, scale = 8, lambda ref: ref.abs()
        limit = 1e-6
    else:             # test (b): 2^13 paths, 91 steps, 1e-5 max(|out|, 1)
        x0 = np.random.default_rng(4).normal(0.0, 0.05, 1 << 13).astype(np.float32)
        nb_steps, scale = 91, lambda ref: ref.abs().clamp(min=1.0)
        limit = 1e-5
    x0 = torch.as_tensor(x0)
    ref = mc_variants.run_variant_torch(5, x0, nb_steps, DT, variant)
    out = mc_variants._run_abs_sigma_fused(5, x0, nb_steps, DT, variant)
    assert bool(torch.isfinite(out).all())
    assert float(((out - ref).abs() / scale(ref)).max()) <= limit


def test_fused_plain_step_takes_only_abs_sigma_variants():
    x0 = torch.zeros(128)
    for variant in set(mc_variants.VARIANTS) - {"no-exp", "alu-floor", "no-prng"}:
        with pytest.raises(ValueError, match="sigma = "):
            mc_variants._run_abs_sigma_fused(1, x0, 2, DT, variant)


def test_sass_script_reads_two_steps_a_pass():
    spec = importlib.util.spec_from_file_location("sass_step_loops",
                                                  ROOT / "scripts" / "sass_step_loops.py")
    sass = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(sass)
    assert sass.steps_per_pass("logsv_variants") == 2
    src = (ROOT / "stochvolmodels_torch" / "csrc" / "logsv_variants.cu").read_text()
    assert "step += kStepsPerPass" in src and "j < kStepsPerPass" in src
