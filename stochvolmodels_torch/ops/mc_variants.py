"""
The variant study of the LogSV path loop: where a path-step's time goes.

Counterpart of ``scripts/bench_pallas_variants.py`` (its TPU kernel
``_kernel``, with ``_normals`` and ``_poly_exp_small``).  Each variant of
:data:`VARIANTS` changes one piece of the production Euler step of
``csrc/logsv_mc.cu`` (library vs polynomial transcendentals, no exp, no
normals, no random bits, fewer state registers), so that its time says what
that piece costs; ``csrc/logsv_variants.cu`` lists what each one does.  Every
variant runs the study's fixed parameters from ln sigma = log 0.84 and
returns x + sigma + qvar per path.

* :func:`run_variant_cuda` launches the hand-written kernel; CUDA float32
  tensors only, it raises on anything else, and its ``.launches`` counts
  launches.
* :func:`run_variant_torch` is the plain version: the same random stream
  (``_PathNormals``), polynomials and float32 step on whole tensors,
  operation for operation, on any device.

Nothing dispatches between the two: the study calls the kernel, the tests
and ``chip_smoke.py`` hold it against the plain version.
"""
from __future__ import annotations

import ctypes
from typing import Callable, Tuple

import numpy as np
import torch

from stochvolmodels_torch.ops import cuda_mc
from stochvolmodels_torch.ops.cuda_mc import (
    LOG_C,
    _PathNormals,
    poly_log,
    uniform_from_bits,
)

# the order of the Variant enum of csrc/logsv_variants.cu
VARIANTS = ("full-fast", "full-sincos", "no-normals", "no-exp", "alu-floor", "poly-bm",
            "poly-bm2", "poly-exp", "poly-all", "sigma-carry", "no-qvar",
            "sigma-carry-noqvar", "one-prng", "no-prng")
# the step-loop unrolls the kernel is built for: the TPU study's configurations
UNROLLS = (2,)
# (float32, 32-bit integer) operations per path-step of each variant, counted
# from csrc/logsv_variants.cu by the rules of cuda_mc.OPS_PER_STEP.  A libm
# call is one source operation but several instructions, so the library
# variants' counts are lower bounds of their work.
OPS_PER_STEP = {
    "full-fast": (44, 45), "full-sincos": (39, 43), "no-normals": (36, 43), "no-exp": (45, 45),
    "alu-floor": (34, 43), "poly-bm": (73, 49), "poly-bm2": (76, 49), "poly-exp": (56, 45),
    "poly-all": (85, 49), "sigma-carry": (73, 49), "no-qvar": (68, 49),
    "sigma-carry-noqvar": (68, 49), "one-prng": (46, 25), "no-prng": (31, 2)}

_f32 = np.float32
# the study's fixed parameters and start, float32 as the TPU kernel takes them
THETA, KAPPA1, KAPPA2, BETA, VOLVOL = (_f32(1.04), _f32(3.18), _f32(3.06), _f32(0.15),
                                       _f32(1.85))
SIGMA0 = _f32(0.84)
LNS0 = _f32(np.log(0.84))

_PI = float(_f32(np.pi))
_TWO_PI = float(_f32(2.0 * np.pi))
_HALF_PI = float(_f32(np.pi / 2.0))
_SQRT6 = float(_f32(np.sqrt(6.0)))
_EXP_C = [float(_f32(c)) for c in (0.16666667, 0.041666666, 0.008333452, 0.0013908)]
_COS_C = [float(_f32(c)) for c in (0.99999999, -0.49999997, 0.041666418, -0.0013888397,
                                   0.0000247609)]
_SIN_C = [float(_f32(c)) for c in (-0.16666658, 0.008332824, -0.00019810997, 2.7525562e-06)]


def _scalars(dt: float) -> np.ndarray:
    """the 11 float32 scalars of the step, laid out as ``VariantArgs``: dt,
    sqrt(dt) (taken in float64), theta, kappa1, kappa2, beta, volvol,
    kappa1 theta, (beta^2 + volvol^2) / 2, lns0, sigma0."""
    k1theta = KAPPA1 * THETA
    half_vt2 = _f32(0.5) * (BETA * BETA + VOLVOL * VOLVOL)
    return np.array([dt, np.sqrt(dt), THETA, KAPPA1, KAPPA2, BETA, VOLVOL, k1theta, half_vt2,
                     LNS0, SIGMA0], dtype=np.float32)


def _check(x0: torch.Tensor, variant: str) -> int:
    if variant not in VARIANTS:
        raise ValueError(f"unknown variant {variant!r}; the variants are {VARIANTS}")
    if x0.dim() != 1 or x0.dtype != torch.float32:
        raise TypeError(f"x0 must be 1-D float32, got {tuple(x0.shape)} {x0.dtype}")
    return cuda_mc._check_nb_path(x0.shape[0])


def _poly_exp_small(x: torch.Tensor) -> torch.Tensor:
    c3, c4, c5, c6 = _EXP_C
    return 1.0 + x * (1.0 + x * (0.5 + x * (c3 + x * (c4 + x * (c5 + x * c6)))))


def _sign(bits: torch.Tensor, mask: int) -> torch.Tensor:
    return torch.where((bits & mask) == 0, 1.0, -1.0).to(torch.float32)


def _draws(rng: _PathNormals, step: int, variant: str,
           x: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """the two draws of step ``step``, as ``draws<V>`` of the kernel."""
    if variant in ("poly-bm", "poly-all", "sigma-carry", "no-qvar", "sigma-carry-noqvar"):
        return rng.step(step)
    if variant == "no-prng":
        z0 = x * float(_f32(1e-6)) + float(_f32(0.01))
        return z0, z0 * 0.5
    if variant == "one-prng":
        b = rng.bits(step, 0)
        u1 = ((b >> 16).to(torch.float32) + 0.5) * 2.0 ** -16
        u2 = ((b & 0xFFFF).to(torch.float32) + 0.5) * 2.0 ** -16
        r = torch.sqrt(-2.0 * torch.log(u1))
        c = torch.cos(_PI * u2)
        return r * c, _sign(b, 0x10000) * r * torch.sqrt(torch.clamp(1.0 - c * c, min=0.0))
    b1, b2 = rng.bits(step, 0), rng.bits(step, 1)
    u1, u2 = uniform_from_bits(b1), uniform_from_bits(b2)
    if variant == "alu-floor":
        return u1 - 0.5, u2 - 0.5
    if variant == "no-normals":
        return _SQRT6 * (u1 + u2 - 1.0), _SQRT6 * (u2 - u1)
    if variant == "poly-bm2":
        r = torch.sqrt(torch.clamp(-2.0 * poly_log(u1), min=0.0))
        t = (2.0 * u2 - 1.0) * _HALF_PI
        t2 = t * t
        sp = t * (1.0 + t2 * (_SIN_C[0] + t2 * (_SIN_C[1] + t2 * (_SIN_C[2] + t2 * _SIN_C[3]))))
        cp = _COS_C[0] + t2 * (_COS_C[1] + t2 * (_COS_C[2] + t2 * (_COS_C[3] + t2 * _COS_C[4])))
        return r * (-sp), r * (_sign(b2, 1) * cp)
    r = torch.sqrt(-2.0 * torch.log(u1))   # full-fast, full-sincos, no-exp, poly-exp
    if variant == "full-sincos":
        t = _TWO_PI * u2
        return r * torch.cos(t), r * torch.sin(t)
    c = torch.cos(_PI * u2)
    return r * c, r * (_sign(b2, 1) * torch.sqrt(torch.clamp(1.0 - c * c, min=0.0)))


def run_variant_torch(seed: int,
                      x0: torch.Tensor,
                      nb_steps: int,
                      dt: float,
                      variant: str,
                      reciprocal: Callable[[torch.Tensor], torch.Tensor] = torch.reciprocal
                      ) -> torch.Tensor:
    """x + sigma + qvar per path after ``nb_steps`` Euler steps of ``variant``,
    by the plain tensor version of the kernel, on ``x0``'s device.

    The same random stream and float32 step as the CUDA kernel, operation
    for operation.  ``reciprocal`` is the 1/sigma of the ln-sigma drift
    (exact by default); tests swap it to emulate the TPU kernel's
    approximate reciprocal.
    """
    nb_path = _check(x0, variant)
    dt, sdt, theta, kappa1, kappa2, beta, volvol, k1theta, half_vt2, lns0, sigma0 = (
        float(v) for v in _scalars(dt))
    has_lns = variant not in ("sigma-carry", "sigma-carry-noqvar")
    has_qvar = variant not in ("no-qvar", "sigma-carry-noqvar")
    rng = _PathNormals(seed, nb_path, x0.device)
    x = x0.clone()
    lns = torch.full_like(x0, lns0)
    sigma = torch.full_like(x0, sigma0)
    qvar = torch.zeros_like(x0)
    for step in range(nb_steps):
        z0, z1 = _draws(rng, step, variant, x)
        w0 = z0 * sdt
        w1 = z1 * sdt
        sig2dt = sigma * sigma * dt
        x = x - 0.5 * sig2dt + sigma * w0
        dln = (((k1theta * reciprocal(sigma) - kappa1) + kappa2 * (theta - sigma)) - half_vt2) \
            * dt + beta * w0 + volvol * w1
        if has_lns:
            lns = lns + dln
        if variant in ("no-exp", "alu-floor", "no-prng"):
            sigma_new = torch.abs(1.0 + lns)
        elif variant in ("poly-exp", "poly-all"):
            sigma_new = sigma * _poly_exp_small(dln)
        elif not has_lns:
            sigma_new = sigma * torch.exp(dln)
        else:
            sigma_new = torch.exp(lns)
        if has_qvar:
            qvar = qvar + 0.5 * (sig2dt + sigma_new * sigma_new * dt)
        sigma = sigma_new
    return x + sigma + qvar


# logsv_variants_launch: (x0, out, nb_path, seed, nb_steps, variant, unroll,
# threads, host args, stream)
_LAUNCH_ARGTYPES = [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_longlong, ctypes.c_uint32,
                    ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_void_p,
                    ctypes.c_void_p]


def run_variant_cuda(seed: int,
                     x0: torch.Tensor,
                     nb_steps: int,
                     dt: float,
                     variant: str,
                     block_rows: int = 256,
                     unroll: int = 2) -> torch.Tensor:
    """x + sigma + qvar per path by the hand-written CUDA kernel.

    Mirrors ``_run`` of the TPU study: ``block_rows`` becomes the CUDA block
    size (a multiple of 32 up to 1024) and ``unroll`` the step-loop unroll
    (one of ``UNROLLS``).  ``x0`` is (nb_path,) float32, contiguous, on a CUDA device,
    with nb_path a multiple of 128.  Launches on the current stream without
    synchronising; a refused launch raises.  ``run_variant_cuda.launches``
    counts launches.
    """
    nb_path = _check(x0, variant)
    cuda_mc._check_cuda_state(x0)
    if unroll not in UNROLLS or block_rows % 32 or not 32 <= block_rows <= 1024:
        raise ValueError(f"the kernel takes unroll in {UNROLLS} and a block of 32..1024 "
                         f"threads in steps of 32, got unroll {unroll}, block {block_rows}")
    launch = cuda_mc._launcher("logsv_variants", _LAUNCH_ARGTYPES)
    host_args = np.concatenate([_scalars(dt), LOG_C])
    out = torch.empty_like(x0)
    with torch.cuda.device(x0.device):
        stream = torch.cuda.current_stream().cuda_stream
        err = launch(x0.data_ptr(), out.data_ptr(), nb_path, int(seed) & cuda_mc._M32, nb_steps,
                     VARIANTS.index(variant), unroll, block_rows, host_args.ctypes.data, stream)
    cuda_mc._raise_on_error("logsv_variants", err)
    run_variant_cuda.launches += 1
    return out


run_variant_cuda.launches = 0
