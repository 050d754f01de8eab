"""
The LogSV Monte-Carlo path loop: a hand-written CUDA kernel and its plain
PyTorch version.

Counterpart of ``stochvolmodels_tpu/ops/pallas_mc.py`` for ``_logsv_kernel``.
The whole simulation of a path runs inside one CUDA thread
(``csrc/logsv_mc.cu``): the normals come from the murmur3 counter hash over
(program seed, step, stream, in-block path index) that the TPU kernel uses in
interpret mode, the state stays in registers, and only the terminal
(x, sigma, qvar) is written back.

* :func:`simulate_logsv_terminal_cuda` launches the kernel; CUDA float32
  tensors only, it raises on anything else.
* :func:`simulate_logsv_terminal_torch` is the plain version: the same hash,
  uniforms, polynomials and Euler step on whole tensors, in int64 and
  float32, on any device.
* :func:`simulate_logsv_terminal_kernel` is what the chain pricer calls: CUDA
  tensors go to the kernel, CPU tensors to the plain version.
"""
from __future__ import annotations

import ctypes
from typing import Callable, NamedTuple, Optional, Tuple

import numpy as np
import torch

from stochvolmodels_torch.ops import _build
from stochvolmodels_torch.utils.funcs import set_time_grid

LANES = 128
BLOCK_PATHS = 256 * LANES   # paths per TPU program: one (256, 128) block
_M32 = 0xFFFFFFFF

# near-minimax coefficients for ln(1+f)/f on f in [0,1): least squares on
# Chebyshev nodes, the same numpy computation as the JAX package's _LOG_C
_LOG_NODES = 0.5 - 0.5 * np.cos((2 * np.arange(1, 201) - 1) * np.pi / 400)
LOG_C = np.polyfit(_LOG_NODES, np.log1p(_LOG_NODES) / _LOG_NODES, 6).astype(np.float32)
_LN2_F32 = float(np.float32(0.6931471805599453))
_HALF_PI_F32 = float(np.float32(np.pi / 2.0))
_SIN_C = [float(np.float32(c)) for c in (-0.16666658, 0.008332824, -0.00019810997,
                                         2.7525562e-06)]
_FLT_MIN = 1.1754944e-38


# --------------------------------------------------------------------------
# the plain version: uint32 arithmetic carried in int64
# --------------------------------------------------------------------------

def _mul32(x: torch.Tensor, c: int) -> torch.Tensor:
    """(x * c) mod 2^32 for int64 x in [0, 2^32): the constant is split into
    16-bit halves so that no product passes 2^63."""
    lo, hi = c & 0xFFFF, c >> 16
    return (x * lo + (((x * hi) & 0xFFFF) << 16)) & _M32


def hash_u32(x: torch.Tensor) -> torch.Tensor:
    """murmur3 finalizer on uint32 values held in int64."""
    x = x ^ (x >> 16)
    x = _mul32(x, 0x85EBCA6B)
    x = x ^ (x >> 13)
    x = _mul32(x, 0xC2B2AE35)
    return x ^ (x >> 16)


def _counter_key(seed: torch.Tensor, salt: int, stream: int) -> torch.Tensor:
    """hash(seed*0x9E3779B9 + salt*0x7FEB352D + stream*0x846CA68B), seed mod 2^32."""
    return hash_u32((_mul32(seed & _M32, 0x9E3779B9) + ((salt * 0x7FEB352D) & _M32)
                     + ((stream * 0x846CA68B) & _M32)) & _M32)


def counter_bits(seed: torch.Tensor, salt: int, stream: int, idx: torch.Tensor) -> torch.Tensor:
    """uint32 bits (in int64) of the TPU kernel's counter hash:
    hash(idx ^ key(seed, salt, stream)), with ``seed`` (int64) broadcasting
    against the in-block path index ``idx``."""
    return hash_u32(idx ^ _counter_key(seed, salt, stream))


def uniform_from_bits(bits: torch.Tensor) -> torch.Tensor:
    """uint32 bits (int64) -> (0, 1) float32 via the mantissa bitcast."""
    f = ((bits >> 9) | 0x3F800000).to(torch.int32).view(torch.float32)
    return torch.clamp(f - 1.0, min=_FLT_MIN)


def poly_log(u: torch.Tensor) -> torch.Tensor:
    """ln(u) for float32 u in (0, 1): exponent extraction + degree-6 polynomial."""
    bits = u.view(torch.int32)
    e = (bits >> 23) - 127
    f = ((bits & 0x007FFFFF) | 0x3F800000).view(torch.float32) - 1.0
    p = torch.full_like(f, float(LOG_C[0]))
    for c in LOG_C[1:]:
        p = p * f + float(c)
    return e.to(torch.float32) * _LN2_F32 + f * p


def poly_cospi(u: torch.Tensor) -> torch.Tensor:
    """cos(pi u) for float32 u in [0, 1) via the odd sin minimax on [-pi/2, pi/2)."""
    x = (2.0 * u - 1.0) * _HALF_PI_F32
    x2 = x * x
    s = x * (1.0 + x2 * (_SIN_C[0] + x2 * (_SIN_C[1] + x2 * (_SIN_C[2] + x2 * _SIN_C[3]))))
    return -s


class _EulerScalars(NamedTuple):
    """float32 scalars of the Euler step (stored as Python floats that are
    exactly float32), rounded from float64 as the TPU kernel's wrapper does."""
    dt: float
    sdt: float
    alpha: float
    theta: float
    kappa1: float
    kappa2: float
    beta: float
    volvol: float
    eta: float
    adj: float


def _euler_scalars(ttm, theta, kappa1, kappa2, beta, volvol, vol_backbone_eta,
                   is_spot_measure, nb_steps_per_year) -> Tuple[int, _EulerScalars]:
    nb_steps, dt, _ = set_time_grid(ttm=ttm, nb_steps_per_year=nb_steps_per_year)
    if is_spot_measure:
        alpha, adj = -1.0, 0.0
    else:
        alpha, adj = 1.0, beta * vol_backbone_eta
    values = np.array([dt, np.sqrt(dt), alpha, theta, kappa1, kappa2, beta, volvol,
                       vol_backbone_eta, adj], dtype=np.float32)
    return nb_steps, _EulerScalars(*(float(v) for v in values))


def _check_paths(x0: torch.Tensor, sigma0: torch.Tensor, qvar0: torch.Tensor) -> int:
    nb_path = x0.shape[0]
    for t in (x0, sigma0, qvar0):
        if t.dim() != 1 or t.shape[0] != nb_path:
            raise ValueError("x0, sigma0 and qvar0 must be 1-D of one length")
        if t.dtype != torch.float32:
            raise TypeError(f"the LogSV MC kernel takes float32 state, got {t.dtype}")
        if t.device != x0.device:
            raise ValueError("x0, sigma0 and qvar0 must be on one device")
    if nb_path == 0 or nb_path % LANES:
        raise ValueError(f"nb_path must be a positive multiple of {LANES}, got {nb_path}")
    return nb_path


def simulate_logsv_terminal_torch(seed: int,
                                  x0: torch.Tensor,
                                  sigma0: torch.Tensor,
                                  qvar0: torch.Tensor,
                                  ttm: float,
                                  theta: float,
                                  kappa1: float,
                                  kappa2: float,
                                  beta: float,
                                  volvol: float,
                                  vol_backbone_eta: float = 1.0,
                                  is_spot_measure: bool = True,
                                  nb_steps_per_year: int = 360,
                                  reciprocal: Callable[[torch.Tensor], torch.Tensor] = torch.reciprocal
                                  ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """terminal (x, sigma, qvar) by the plain tensor version of the kernel.

    Same random stream and float32 Euler step, operation for operation, as
    the CUDA kernel and as the TPU kernel in interpret mode.  ``reciprocal``
    is the 1/sigma of the ln-sigma drift (exact by default); tests swap it to
    emulate the TPU kernel's approximate reciprocal.
    """
    nb_path = _check_paths(x0, sigma0, qvar0)
    device = x0.device
    nb_steps, a = _euler_scalars(ttm, theta, kappa1, kappa2, beta, volvol,
                                 vol_backbone_eta, is_spot_measure, nb_steps_per_year)
    f32 = np.float32
    eta2 = float(f32(a.eta) * f32(a.eta))
    half_vt2 = float(f32(0.5) * (f32(a.beta) * f32(a.beta) + f32(a.volvol) * f32(a.volvol)))
    alpha_half = float(f32(a.alpha) * f32(0.5))
    k1theta = float(f32(a.kappa1) * f32(a.theta))

    p = torch.arange(nb_path, dtype=torch.int64, device=device)
    idx = p & (BLOCK_PATHS - 1)
    block = p >> 15
    nb_blocks = (nb_path + BLOCK_PATHS - 1) // BLOCK_PATHS
    block_seeds = int(seed) + torch.arange(nb_blocks, dtype=torch.int64, device=device)

    x = x0.clone()
    lns = torch.log(sigma0)
    qvar = qvar0.clone()
    sigma = torch.exp(lns)
    for step in range(nb_steps):
        # one key per TPU block, gathered to its paths
        b1 = hash_u32(idx ^ _counter_key(block_seeds, step, 0)[block])
        b2 = hash_u32(idx ^ _counter_key(block_seeds, step, 1)[block])
        r = torch.sqrt(torch.clamp(-2.0 * poly_log(uniform_from_bits(b1)), min=0.0))
        c = poly_cospi(uniform_from_bits(b2))
        sign = torch.where((b2 & 1) == 0, 1.0, -1.0).to(torch.float32)
        sn = sign * torch.sqrt(torch.clamp(1.0 - c * c, min=0.0))
        w0 = (r * c) * a.sdt
        w1 = (r * sn) * a.sdt
        sig2dt = ((eta2 * sigma) * sigma) * a.dt
        x = (x + alpha_half * sig2dt) + (a.eta * sigma) * w0
        drift = (((k1theta * reciprocal(sigma) - a.kappa1) + a.kappa2 * (a.theta - sigma))
                 + a.adj * sigma) - half_vt2
        lns = ((lns + drift * a.dt) + a.beta * w0) + a.volvol * w1
        sigma_new = torch.exp(lns)
        qvar = qvar + 0.5 * (sig2dt + ((eta2 * sigma_new) * sigma_new) * a.dt)
        sigma = sigma_new
    return x, sigma, qvar


# --------------------------------------------------------------------------
# the CUDA kernel
# --------------------------------------------------------------------------

def _load_kernel() -> ctypes.CDLL:
    lib = _build.load_library("logsv_mc")
    fn = lib.logsv_mc_launch
    if fn.argtypes is None:
        fn.argtypes = [ctypes.c_void_p] * 6 + [ctypes.c_longlong, ctypes.c_uint32,
                                               ctypes.c_int, ctypes.c_void_p, ctypes.c_void_p]
        fn.restype = ctypes.c_int
    return lib


def simulate_logsv_terminal_cuda(seed: int,
                                 x0: torch.Tensor,
                                 sigma0: torch.Tensor,
                                 qvar0: torch.Tensor,
                                 ttm: float,
                                 theta: float,
                                 kappa1: float,
                                 kappa2: float,
                                 beta: float,
                                 volvol: float,
                                 vol_backbone_eta: float = 1.0,
                                 is_spot_measure: bool = True,
                                 nb_steps_per_year: int = 360
                                 ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """terminal (x, sigma, qvar) by the hand-written CUDA kernel (float32).

    Mirrors ``simulate_logsv_terminal_pallas``: state tensors are (nb_path,)
    float32, contiguous, on one CUDA device, with nb_path a multiple of 128.
    Launches on the current stream without synchronising; a refused launch
    raises.  ``simulate_logsv_terminal_cuda.launches`` counts launches.
    """
    nb_path = _check_paths(x0, sigma0, qvar0)
    if x0.device.type != "cuda":
        raise ValueError(f"the CUDA kernel needs CUDA tensors, got {x0.device}")
    if not (x0.is_contiguous() and sigma0.is_contiguous() and qvar0.is_contiguous()):
        raise ValueError("x0, sigma0 and qvar0 must be contiguous")
    lib = _load_kernel()
    nb_steps, a = _euler_scalars(ttm, theta, kappa1, kappa2, beta, volvol,
                                 vol_backbone_eta, is_spot_measure, nb_steps_per_year)
    host_args = np.concatenate([np.asarray(a, dtype=np.float32), LOG_C])
    lns0 = torch.log(sigma0)
    x, sig, qvar = (torch.empty_like(x0) for _ in range(3))
    with torch.cuda.device(x0.device):
        stream = torch.cuda.current_stream().cuda_stream
        err = lib.logsv_mc_launch(x0.data_ptr(), lns0.data_ptr(), qvar0.data_ptr(),
                                  x.data_ptr(), sig.data_ptr(), qvar.data_ptr(),
                                  nb_path, int(seed) & _M32, nb_steps,
                                  host_args.ctypes.data, stream)
    if err != 0:
        raise RuntimeError(f"logsv_mc kernel launch failed: cudaError_t {err}")
    simulate_logsv_terminal_cuda.launches += 1
    return x, sig, qvar


simulate_logsv_terminal_cuda.launches = 0


def simulate_logsv_terminal_kernel(seed: int, x0: torch.Tensor, sigma0: torch.Tensor,
                                   qvar0: torch.Tensor, **kwargs
                                   ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """the chain pricer's path loop: CUDA tensors run the CUDA kernel, CPU
    tensors its plain version.  Nothing else dispatches."""
    if x0.device.type == "cuda":
        return simulate_logsv_terminal_cuda(seed, x0, sigma0, qvar0, **kwargs)
    if x0.device.type == "cpu":
        return simulate_logsv_terminal_torch(seed, x0, sigma0, qvar0, **kwargs)
    raise ValueError(f"no LogSV MC kernel for device {x0.device}")


def engine_setup(seed: Optional[int], nb_path: int, default_seed: int = 24) -> Tuple[int, int]:
    """shared preamble of the engine='cuda' chain pricers: (padded path
    count, integer base seed).  Seeds must be integers (or None -> 24)."""
    if seed is None:
        base_seed = default_seed
    elif isinstance(seed, (int, np.integer)) and not isinstance(seed, bool):
        base_seed = int(seed)
    elif isinstance(seed, float) and float(seed).is_integer():
        base_seed = int(seed)
    else:
        raise TypeError(f"engine='cuda' needs an integer seed (got {type(seed).__name__})")
    nb_pad = ((nb_path + LANES - 1) // LANES) * LANES
    return nb_pad, base_seed
