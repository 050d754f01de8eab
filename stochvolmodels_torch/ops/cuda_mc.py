"""
The Monte-Carlo path loops: hand-written CUDA kernels and their plain
PyTorch versions.

Counterpart of ``stochvolmodels_tpu/ops/pallas_mc.py`` for ``_logsv_kernel``
(``csrc/logsv_mc.cu``), ``_heston_kernel`` (``csrc/heston_mc.cu``),
``_rough_kernel`` (``csrc/rough_mc.cu``) and ``_hawkes_kernel``
(``csrc/hawkes_mc.cu``).  The whole simulation of a path runs inside one
CUDA thread: the random draws come from the murmur3 counter hash over
(program seed, step, stream, in-block path index) that the TPU kernels use in
interpret mode (``csrc/counter_rng.cuh``), the state stays in registers, and
only the terminal state is written back.  The kernels take the per-program
keys of that hash from a ring in shared memory; the LogSV kernel carries
sigma^2 dt from step to step; the Hawkes
kernel skips the logarithms and jump draws that cannot change its result
(``hawkes_pretest_bound``, ``hawkes_branch_shares``).  The LogSV, Heston and
rough kernels' updates use FMA (LogSV also the approximate 1/sigma of the
TPU kernel), so they are held to their plain versions at 1e-4 in x and a
stated tolerance in the other outputs (``chip_smoke.py``); the Hawkes
kernel equals its plain version bit for bit.  For each model:

* ``simulate_<model>_terminal_cuda`` launches the kernel; CUDA float32
  tensors only, it raises on anything else, and its ``.launches`` counts
  launches;
* ``simulate_<model>_terminal_torch`` is the plain version: the same hash,
  uniforms, polynomials and float32 step on whole tensors, operation for
  operation, on any device;
* ``simulate_<model>_terminal_kernel`` is what the chain pricers call: CUDA
  runs the kernel, the CPU the plain version.
"""
from __future__ import annotations

import ctypes
from typing import Callable, NamedTuple, Optional, Tuple

import numpy as np
import torch

from stochvolmodels_torch.ops import _build
from stochvolmodels_torch.utils.funcs import set_time_grid
from stochvolmodels_torch.utils.profiling import MC_PATH_SPAN, annotate

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

# (float32, 32-bit integer) operations per path-step of each kernel, counted
# from its source: every arithmetic operator, comparison, select,
# min/max/abs, int-float conversion and libm call (expf, logf, sqrtf, the
# division) counts one, an explicit FMA two (the peak counts it as two);
# negation is free; loop-invariant terms are hoisted; the loop counter is two
# integer operations; a shared-memory load is no operation.  normal_pair is
# 46 + 47; with its keys read from the block's ring (normal_pair_from_keys)
# 46 + 28, and the ring's row, its refill test and the loop counter are 6
# integer operations.  The ring's fill, one key hash per thread per 32 or
# 128 steps, is below one operation per path-step and not counted.  Every
# kernel takes its keys from the ring.
# logsv_mc: the normals 46 + 28, the Euler step 27 (the increments 2, x 5,
# the ln sigma drift with its reciprocal and adj sigma 8, ln sigma 6, expf 1,
# the carried sigma^2 dt 2, qvar 3).
# heston_mc: the normals 46 + 28, the step 22 (the increments 2, sqrtf 1,
# v dt 1, x 4, qvar 1, v 9, the floor that keeps NaN 4).
# rough_mc at N nodes (ROUGH_OPS_PER_STEP; its OPS_PER_STEP entry is N = 3):
# an N-term dot 2N - 1 (a product, N - 1 FMAs), the drift's right-hand side
# 3N + 4 (g 4, each factor a difference and an FMA), one RK4 half step 4
# right-hand sides, 3 stage dots and 5N for the stages and the combination:
# 31N + 13, the second one 33N + 12 (its seed dot is not carried); the
# diffusion 3N + 6 (the dot, the scaled exponential 5, the spread N + 2);
# the floor test and the two remaining dots 4N - 1; with the normals 46 +
# 28 and the log-spot and variance algebra 28: 71N + 104 float32 and 34
# integer operations a path-step (N = 3: 317 + 34).
# hawkes_mc's entry counts what every path-step runs; HAWKES_BRANCH_OPS adds
# what its branches run.  They set the kernels' roofline bounds.
ROUGH_OPS_PER_STEP = {n: (46 + (31 * n + 13) + (33 * n + 12) + (3 * n + 6) + (4 * n - 1) + 28,
                          34) for n in range(1, 6)}
OPS_PER_STEP = {"logsv_mc": (73, 34), "heston_mc": (68, 34), "rough_mc": ROUGH_OPS_PER_STEP[3],
                "hawkes_mc": (76, 54)}
# operations of a hawkes_mc branch, per path-step that takes it, on each side:
# "log" is the exact thinning test where the pre-test fails (the polynomial
# ln, the product and the comparison), "jump" draws the jump size where the
# jump fires (the hash of the fifth or sixth stream, its uniform and ln, the
# size).  hawkes_branch_shares measures how often each runs.
HAWKES_BRANCH_OPS = {"log": (19, 4), "jump": (21, 15)}
# the thinning pre-test of csrc/hawkes_mc.cu (kPreC, kPreMargin): a jump
# cannot fire where lambda < ((1 - u) - PRETEST_C) * inv_dt * (1 - PRETEST_MARGIN)
PRETEST_C = 2e-6
PRETEST_MARGIN = 1e-6


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


class _PathNormals:
    """the random stream of every path, as the kernels draw it: path p takes
    TPU program seed ``seed + (p >> 15)`` and in-block index ``p & 32767``;
    step ``step`` salts every stream.  ``step`` gives the two normals of
    streams 0 and 1 (sign-bit Box-Muller with the polynomial ln and
    cos(pi u)), ``bits`` the uint32 bits of any stream."""

    def __init__(self, seed: int, nb_path: int, device):
        p = torch.arange(nb_path, dtype=torch.int64, device=device)
        self.idx = p & (BLOCK_PATHS - 1)
        self.block = p >> 15
        nb_blocks = (nb_path + BLOCK_PATHS - 1) // BLOCK_PATHS
        self.block_seeds = int(seed) + torch.arange(nb_blocks, dtype=torch.int64, device=device)

    def bits(self, step: int, stream: int) -> torch.Tensor:
        # one key per TPU block, gathered to its paths
        return hash_u32(self.idx ^ _counter_key(self.block_seeds, step, stream)[self.block])

    def step(self, step: int) -> Tuple[torch.Tensor, torch.Tensor]:
        b1 = self.bits(step, 0)
        b2 = self.bits(step, 1)
        r = torch.sqrt(torch.clamp(-2.0 * poly_log(uniform_from_bits(b1)), min=0.0))
        c = poly_cospi(uniform_from_bits(b2))
        sign = torch.where((b2 & 1) == 0, 1.0, -1.0).to(torch.float32)
        sn = sign * torch.sqrt(torch.clamp(1.0 - c * c, min=0.0))
        return r * c, r * sn


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
            raise TypeError(f"the MC kernels take float32 state, got {t.dtype}")
        if t.device != x0.device:
            raise ValueError("x0, sigma0 and qvar0 must be on one device")
    return _check_nb_path(nb_path)


def _check_nb_path(nb_path: int) -> int:
    if nb_path <= 0 or nb_path % LANES:
        raise ValueError(f"nb_path must be a positive multiple of {LANES}, got {nb_path}")
    return nb_path


def _check_cuda_state(*state: torch.Tensor) -> None:
    if state[0].device.type != "cuda":
        raise ValueError(f"the CUDA kernel needs CUDA tensors, got {state[0].device}")
    if not all(t.is_contiguous() for t in state):
        raise ValueError("the state tensors must be contiguous")


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

    normals = _PathNormals(seed, nb_path, device)
    x = x0.clone()
    lns = torch.log(sigma0)
    qvar = qvar0.clone()
    sigma = torch.exp(lns)
    for step in range(nb_steps):
        z0, z1 = normals.step(step)
        w0 = z0 * a.sdt
        w1 = z1 * a.sdt
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

# C entry points: (state in, state out, nb_path, seed, nb_steps, host args, stream)
_STATE_LAUNCH_ARGTYPES = [ctypes.c_void_p] * 6 + [ctypes.c_longlong, ctypes.c_uint32,
                                                  ctypes.c_int, ctypes.c_void_p, ctypes.c_void_p]
# rough_mc_launch: (out x3, nb_path, seed, nb_steps, n_nodes, host args, stream)
_ROUGH_LAUNCH_ARGTYPES = [ctypes.c_void_p] * 3 + [ctypes.c_longlong, ctypes.c_uint32, ctypes.c_int,
                                                  ctypes.c_int, ctypes.c_void_p, ctypes.c_void_p]


def _launcher(name: str, argtypes) -> Callable[..., int]:
    """the C entry point ``<name>_launch`` of ``csrc/<name>.cu``, built and
    loaded at first use."""
    fn = getattr(_build.load_library(name), f"{name}_launch")
    if fn.argtypes is None:
        fn.argtypes = argtypes
        fn.restype = ctypes.c_int
    return fn


def _raise_on_error(name: str, err: int) -> None:
    if err != 0:
        raise RuntimeError(f"{name} kernel launch failed: cudaError_t {err}")


def _batch_first(x: torch.Tensor, dim, size: int) -> torch.Tensor:
    """``x`` with its vmapped dimension first (repeated ``size`` times where
    it has none): a kernel's batch axis in a ``vmap`` rule."""
    return x.expand(size, *x.shape) if dim is None else x.movedim(dim, 0)


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
    _check_cuda_state(x0, sigma0, qvar0)
    launch = _launcher("logsv_mc", _STATE_LAUNCH_ARGTYPES)
    nb_steps, a = _euler_scalars(ttm, theta, kappa1, kappa2, beta, volvol,
                                 vol_backbone_eta, is_spot_measure, nb_steps_per_year)
    host_args = np.concatenate([np.asarray(a, dtype=np.float32), LOG_C])
    lns0 = torch.log(sigma0)
    x, sig, qvar = (torch.empty_like(x0) for _ in range(3))
    with torch.cuda.device(x0.device):
        stream = torch.cuda.current_stream().cuda_stream
        err = launch(x0.data_ptr(), lns0.data_ptr(), qvar0.data_ptr(),
                     x.data_ptr(), sig.data_ptr(), qvar.data_ptr(),
                     nb_path, int(seed) & _M32, nb_steps, host_args.ctypes.data, stream)
    _raise_on_error("logsv_mc", err)
    simulate_logsv_terminal_cuda.launches += 1
    return x, sig, qvar


simulate_logsv_terminal_cuda.launches = 0


def simulate_logsv_terminal_kernel(seed: int, x0: torch.Tensor, sigma0: torch.Tensor,
                                   qvar0: torch.Tensor, **kwargs
                                   ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """the chain pricer's path loop: CUDA tensors run the CUDA kernel, CPU
    tensors its plain version.  Nothing else dispatches.  One
    ``MC_PATH_SPAN``."""
    with annotate(MC_PATH_SPAN):
        if x0.device.type == "cuda":
            return simulate_logsv_terminal_cuda(seed, x0, sigma0, qvar0, **kwargs)
        if x0.device.type == "cpu":
            return simulate_logsv_terminal_torch(seed, x0, sigma0, qvar0, **kwargs)
    raise ValueError(f"no LogSV MC kernel for device {x0.device}")


# --------------------------------------------------------------------------
# Heston: full-truncation Euler (_heston_kernel)
# --------------------------------------------------------------------------

VAR_FLOOR = 1e-4  # full-truncation floor of the variance


def _heston_scalars(ttm, theta, kappa, rho, volvol, nb_steps_per_year) -> Tuple[int, np.ndarray]:
    """(nb_steps, float32 [dt, sqrt(dt), theta, kappa, rho, volvol]), rounded
    from float64 as the TPU kernel's wrapper does."""
    nb_steps, dt, _ = set_time_grid(ttm=ttm, nb_steps_per_year=nb_steps_per_year)
    return nb_steps, np.array([dt, np.sqrt(dt), theta, kappa, rho, volvol], dtype=np.float32)


def simulate_heston_terminal_torch(seed: int,
                                   x0: torch.Tensor,
                                   var0: torch.Tensor,
                                   qvar0: torch.Tensor,
                                   ttm: float,
                                   theta: float,
                                   kappa: float,
                                   rho: float,
                                   volvol: float,
                                   nb_steps_per_year: int = 360
                                   ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """terminal (x, var, qvar) under Heston by the plain tensor version of the
    kernel: the same random stream and float32 step, operation for
    operation.  rho_1 = sqrt(1 - rho^2) is taken in float32, as the TPU
    kernel takes it from its float32 parameters."""
    nb_path = _check_paths(x0, var0, qvar0)
    nb_steps, a = _heston_scalars(ttm, theta, kappa, rho, volvol, nb_steps_per_year)
    rho_1 = float(np.sqrt(np.float32(1.0) - a[4] * a[4]))
    dt, sdt, theta, kappa, rho, volvol = (float(v) for v in a)
    normals = _PathNormals(seed, nb_path, x0.device)
    x, var, qvar = x0.clone(), var0.clone(), qvar0.clone()
    for step in range(nb_steps):
        z0, z1 = normals.step(step)
        w0 = z0 * sdt
        w1 = z1 * sdt
        sigma = torch.sqrt(var)
        var_dt = var * dt
        x = (x - 0.5 * var_dt) + sigma * w0
        qvar = qvar + var_dt
        var = (var + (kappa * (theta - var)) * dt) + (sigma * volvol) * (rho * w0 + rho_1 * w1)
        var = torch.clamp(var, min=VAR_FLOOR)
    return x, var, qvar


def simulate_heston_terminal_cuda(seed: int,
                                  x0: torch.Tensor,
                                  var0: torch.Tensor,
                                  qvar0: torch.Tensor,
                                  ttm: float,
                                  theta: float,
                                  kappa: float,
                                  rho: float,
                                  volvol: float,
                                  nb_steps_per_year: int = 360
                                  ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """terminal (x, var, qvar) under Heston by the hand-written CUDA kernel.

    Mirrors ``simulate_heston_terminal_pallas``: (nb_path,) float32,
    contiguous CUDA tensors, nb_path a multiple of 128.  Launches on the
    current stream without synchronising; a refused launch raises.
    ``simulate_heston_terminal_cuda.launches`` counts launches.
    """
    nb_path = _check_paths(x0, var0, qvar0)
    _check_cuda_state(x0, var0, qvar0)
    launch = _launcher("heston_mc", _STATE_LAUNCH_ARGTYPES)
    nb_steps, a = _heston_scalars(ttm, theta, kappa, rho, volvol, nb_steps_per_year)
    host_args = np.concatenate([a, LOG_C])
    x, var, qvar = (torch.empty_like(x0) for _ in range(3))
    with torch.cuda.device(x0.device):
        stream = torch.cuda.current_stream().cuda_stream
        err = launch(x0.data_ptr(), var0.data_ptr(), qvar0.data_ptr(),
                     x.data_ptr(), var.data_ptr(), qvar.data_ptr(),
                     nb_path, int(seed) & _M32, nb_steps, host_args.ctypes.data, stream)
    _raise_on_error("heston_mc", err)
    simulate_heston_terminal_cuda.launches += 1
    return x, var, qvar


simulate_heston_terminal_cuda.launches = 0


def simulate_heston_terminal_kernel(seed: int, x0: torch.Tensor, var0: torch.Tensor,
                                    qvar0: torch.Tensor, **kwargs
                                    ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """the Heston chain pricer's path loop: CUDA tensors run the CUDA kernel,
    CPU tensors its plain version.  Nothing else dispatches.  One
    ``MC_PATH_SPAN``."""
    with annotate(MC_PATH_SPAN):
        if x0.device.type == "cuda":
            return simulate_heston_terminal_cuda(seed, x0, var0, qvar0, **kwargs)
        if x0.device.type == "cpu":
            return simulate_heston_terminal_torch(seed, x0, var0, qvar0, **kwargs)
    raise ValueError(f"no Heston MC kernel for device {x0.device}")


# --------------------------------------------------------------------------
# rough LogSV: Strang splitting of the Markovian lift (_rough_kernel)
# --------------------------------------------------------------------------

MAX_NODES = 5
ROUGH_VOL_FLOOR = 1e-6  # each factor of a path whose weighted vol is NaN or <= 0


class _RoughScalars(NamedTuple):
    """float32 scalars of the Strang step, as the TPU kernel and
    ``csrc/rough_mc.cu`` compute them from their float32 parameters."""
    nodes: Tuple[float, ...]
    weights: Tuple[float, ...]
    wl: Tuple[float, ...]        # w_i * x_i
    hf: float                    # dt
    h2: float                    # dt / 2
    h6: float                    # h2 / 6
    sqh: float                   # sqrt(dt)
    theta: float
    kappa1: float
    kappa2: float
    rho: float
    v0f: float                   # sigma0 / sum w, taken in float64
    rho_comp: float              # sqrt(max(1 - rho^2, 0))
    volvol_s: float              # volvol * sum w
    w_inv: float                 # 1 / sum w
    inv_volvol: float
    diff_drift: float            # -volvol_s^2 dt / 2
    w_lam_v0: float              # sum(w_i x_i) v0f
    k1theta: float
    k12: float                   # kappa1 - kappa2 theta
    half_h: float                # dt / 2


def _rough_args(ttm, sigma0, theta, kappa1, kappa2, rho, volvol, nodes, weights,
                nb_steps_per_year) -> Tuple[int, np.ndarray, _RoughScalars]:
    """(nb_steps, the 26 float32 kernel arguments, the step's scalars)."""
    nodes = np.asarray(nodes, dtype=np.float64).ravel()
    weights = np.asarray(weights, dtype=np.float64).ravel()
    n = len(nodes)
    if not 1 <= n <= MAX_NODES or len(weights) != n:
        raise ValueError(f"the rough kernel takes 1..{MAX_NODES} nodes and as many weights, "
                         f"got {n} and {len(weights)}")
    nb_steps, dt, _ = set_time_grid(ttm=ttm, nb_steps_per_year=nb_steps_per_year)
    v0f = float(sigma0) / float(np.sum(weights))
    head = np.array([dt, 0.5 * dt, np.sqrt(dt), theta, kappa1, kappa2, rho, volvol, v0f],
                    dtype=np.float32)
    pad = np.zeros(MAX_NODES - n, dtype=np.float32)
    x32, w32 = nodes.astype(np.float32), weights.astype(np.float32)
    host_args = np.concatenate([head, x32, pad, w32, pad, LOG_C])

    f32 = np.float32
    hf, h2, sqh, theta, kappa1, kappa2, rho, volvol, v0f = head
    wl = [w * x for w, x in zip(w32, x32)]
    w_sum, wlam_sum = w32[0], wl[0]
    for w, l in zip(w32[1:], wl[1:]):
        w_sum, wlam_sum = w_sum + w, wlam_sum + l
    volvol_s = volvol * w_sum
    scalars = _RoughScalars(
        nodes=tuple(map(float, x32)), weights=tuple(map(float, w32)), wl=tuple(map(float, wl)),
        hf=float(hf), h2=float(h2), h6=float(h2 / f32(6.0)), sqh=float(sqh),
        theta=float(theta), kappa1=float(kappa1), kappa2=float(kappa2), rho=float(rho),
        v0f=float(v0f), rho_comp=float(np.sqrt(max(f32(1.0) - rho * rho, f32(0.0)))),
        volvol_s=float(volvol_s), w_inv=float(f32(1.0) / w_sum),
        inv_volvol=float(f32(1.0) / volvol),
        diff_drift=float(f32(-0.5) * volvol_s * volvol_s * hf),
        w_lam_v0=float(wlam_sum * v0f), k1theta=float(kappa1 * theta),
        k12=float(kappa1 - kappa2 * theta), half_h=float(f32(0.5) * hf))
    return nb_steps, host_args, scalars


def _dot(w: Tuple[float, ...], v) -> torch.Tensor:
    acc = w[0] * v[0]
    for wi, vi in zip(w[1:], v[1:]):
        acc = acc + wi * vi
    return acc


def _lift_rk4(v, h: float, h6: float, c: _RoughScalars):
    """RK4 step of length h of the lifted drift ODE, one tensor per factor."""
    def rhs(z):
        zw = _dot(c.weights, z)
        g = (c.kappa1 + c.kappa2 * zw) * (c.theta - zw)
        return [-x * (zi - c.v0f) + g for x, zi in zip(c.nodes, z)]

    s1 = rhs(v)
    s2 = rhs([vi + (0.5 * h) * si for vi, si in zip(v, s1)])
    s3 = rhs([vi + (0.5 * h) * si for vi, si in zip(v, s2)])
    s4 = rhs([vi + h * si for vi, si in zip(v, s3)])
    return [vi + h6 * (((a + 2.0 * b) + 2.0 * cc) + d)
            for vi, a, b, cc, d in zip(v, s1, s2, s3, s4)]


def simulate_rough_terminal_torch(seed: int,
                                  nb_path: int,
                                  ttm: float,
                                  sigma0: float,
                                  theta: float,
                                  kappa1: float,
                                  kappa2: float,
                                  rho: float,
                                  volvol: float,
                                  nodes,
                                  weights,
                                  nb_steps_per_year: int = 360,
                                  device="cuda"
                                  ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """terminal (log-spot, weighted vol, integrated var) of the rough LogSV
    lift by the plain tensor version of the kernel, float32 on ``device``.

    The kernel's operation order, one tensor per factor; the log-spot takes
    sqrt(max(term2, 0)) as the TPU kernel does (the JAX scan engine takes
    sqrt(term2)).  The step's divide by dt is a true division on every
    device (a CUDA tensor divided by a Python scalar would be multiplied by
    its reciprocal).
    """
    _check_nb_path(nb_path)
    nb_steps, _, c = _rough_args(ttm, sigma0, theta, kappa1, kappa2, rho, volvol,
                                 nodes, weights, nb_steps_per_year)
    hf_t = torch.tensor(c.hf, dtype=torch.float32, device=device)
    normals = _PathNormals(seed, nb_path, device)
    zero = torch.zeros(nb_path, dtype=torch.float32, device=device)
    v = [torch.full_like(zero, c.v0f) for _ in c.nodes]
    log_s, y = zero, zero
    for step in range(nb_steps):
        z0, z1 = normals.step(step)
        d_inn = _lift_rk4(v, c.h2, c.h6, c)
        yw = _dot(c.weights, d_inn)
        y_h = yw * torch.exp(c.diff_drift + c.volvol_s * (z0 * c.sqh))
        q = (y_h - yw) * c.w_inv
        vol_h = _lift_rk4([d + q for d in d_inn], c.h2, c.h6, c)
        w_vol_h = _dot(c.weights, vol_h)
        bad = torch.isnan(w_vol_h) | (w_vol_h <= 0.0)
        vol_h = [torch.where(bad, ROUGH_VOL_FLOOR, vh) for vh in vol_h]

        vw = _dot(c.weights, v)
        volw_h = _dot(c.weights, vol_h)
        sq_vw = vw * vw
        sq_vhw = volw_h * volw_h
        w_lam_vol = _dot(c.wl, v)
        w_lam_vol_h = _dot(c.wl, vol_h)
        a_term = ((((volw_h - vw) / hf_t + 0.5 * w_lam_vol) + 0.5 * w_lam_vol_h)
                  - c.w_lam_v0) * c.w_inv
        inner = (((a_term - c.k1theta) + c.k12 * (0.5 * vw + 0.5 * volw_h))
                 + c.kappa2 * (0.5 * sq_vw + 0.5 * sq_vhw))
        term1 = (c.inv_volvol * inner) * c.hf
        term2 = c.half_h * sq_vw + c.half_h * sq_vhw
        log_s = ((log_s - 0.5 * term2) + c.rho * term1) \
            + (c.rho_comp * torch.sqrt(torch.clamp(term2, min=0.0))) * z1
        y = y + c.half_h * (sq_vw + sq_vhw)
        v = vol_h
    return log_s, _dot(c.weights, v), y


def simulate_rough_terminal_cuda(seed: int,
                                 nb_path: int,
                                 ttm: float,
                                 sigma0: float,
                                 theta: float,
                                 kappa1: float,
                                 kappa2: float,
                                 rho: float,
                                 volvol: float,
                                 nodes,
                                 weights,
                                 nb_steps_per_year: int = 360,
                                 device="cuda"
                                 ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """terminal (log-spot, weighted vol, integrated var) of the rough LogSV
    lift by the hand-written CUDA kernel, float32 on the CUDA ``device``.

    Mirrors ``simulate_rough_terminal_pallas``: nb_path a multiple of 128,
    1..5 nodes.  Launches on the current stream without synchronising; a
    refused launch raises.  ``simulate_rough_terminal_cuda.launches`` counts
    launches.
    """
    _check_nb_path(nb_path)
    device = torch.device(device)
    if device.type != "cuda":
        raise ValueError(f"the CUDA kernel needs a CUDA device, got {device}")
    launch = _launcher("rough_mc", _ROUGH_LAUNCH_ARGTYPES)
    nb_steps, host_args, c = _rough_args(ttm, sigma0, theta, kappa1, kappa2, rho, volvol,
                                         nodes, weights, nb_steps_per_year)
    x, vw, y = (torch.empty(nb_path, dtype=torch.float32, device=device) for _ in range(3))
    with torch.cuda.device(device):
        stream = torch.cuda.current_stream().cuda_stream
        err = launch(x.data_ptr(), vw.data_ptr(), y.data_ptr(), nb_path, int(seed) & _M32,
                     nb_steps, len(c.nodes), host_args.ctypes.data, stream)
    _raise_on_error("rough_mc", err)
    simulate_rough_terminal_cuda.launches += 1
    return x, vw, y


simulate_rough_terminal_cuda.launches = 0


def simulate_rough_terminal_kernel(seed: int, nb_path: int, device="cuda", **kwargs
                                   ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """the rough chain pricer's path loop: a CUDA ``device`` runs the CUDA
    kernel, the CPU its plain version.  Nothing else dispatches."""
    device = torch.device(device)
    if device.type == "cuda":
        return simulate_rough_terminal_cuda(seed, nb_path, device=device, **kwargs)
    if device.type == "cpu":
        return simulate_rough_terminal_torch(seed, nb_path, device=device, **kwargs)
    raise ValueError(f"no rough MC kernel for device {device}")


# --------------------------------------------------------------------------
# Hawkes jump-diffusion: Euler with intensity thinning (_hawkes_kernel)
# --------------------------------------------------------------------------

def _hawkes_args(ttm, mu, sigma, shift_p, mean_p, shift_m, mean_m, theta_p, kappa_p, beta1_p,
                 beta2_p, theta_m, kappa_m, beta1_m, beta2_m,
                 nb_steps_per_year) -> Tuple[int, np.ndarray]:
    """(nb_steps, the 19 float32 scalars of the step): the TPU kernel's 16
    parameters [mu, sigma, shift_p, mean_p, shift_m, mean_m, theta_p,
    kappa_p, beta1_p, beta2_p, theta_m, kappa_m, beta1_m, beta2_m,
    comp_p dt, comp_m dt], then dt, sqrt(dt) and 1/dt.  Each is taken in
    float64 and rounded once, as the TPU kernel's wrapper does."""
    nb_steps, dt, _ = set_time_grid(ttm=ttm, nb_steps_per_year=nb_steps_per_year)
    comp_p_dt = float(dt) * (np.exp(shift_p) / (1.0 - mean_p) - 1.0)
    comp_m_dt = float(dt) * (np.exp(shift_m) / (1.0 - mean_m) - 1.0)
    return nb_steps, np.array([mu, sigma, shift_p, mean_p, shift_m, mean_m, theta_p, kappa_p,
                               beta1_p, beta2_p, theta_m, kappa_m, beta1_m, beta2_m,
                               comp_p_dt, comp_m_dt, dt, np.sqrt(dt), 1.0 / dt],
                              dtype=np.float32)


def simulate_hawkesjd_terminal_torch(seed: int,
                                     x0: torch.Tensor,
                                     lambda_p0: torch.Tensor,
                                     lambda_m0: torch.Tensor,
                                     ttm: float,
                                     mu: float,
                                     sigma: float,
                                     shift_p: float,
                                     mean_p: float,
                                     shift_m: float,
                                     mean_m: float,
                                     theta_p: float,
                                     kappa_p: float,
                                     beta1_p: float,
                                     beta2_p: float,
                                     theta_m: float,
                                     kappa_m: float,
                                     beta1_m: float,
                                     beta2_m: float,
                                     nb_steps_per_year: int = 1800
                                     ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """terminal (x, lambda_p, lambda_m) of the Hawkes JD model by the plain
    tensor version of the kernel: the same random stream and float32 step,
    operation for operation.

    Per step: one normal from streams 0 and 1 (radius times cos, no second
    normal), exponentials -ln u from streams 2-5; a jump fires when
    lambda > e / dt, taken as ``e * f32(1/dt)`` on every device."""
    _check_paths(x0, lambda_p0, lambda_m0)
    nb_steps, a = _hawkes_args(ttm, mu, sigma, shift_p, mean_p, shift_m, mean_m, theta_p, kappa_p,
                               beta1_p, beta2_p, theta_m, kappa_m, beta1_m, beta2_m,
                               nb_steps_per_year)
    state = (x0.clone(), lambda_p0.clone(), lambda_m0.clone())
    for state, _ in _hawkes_steps(seed, *state, nb_steps, a):
        pass
    return state


class _ThinningDraws(NamedTuple):
    """a Hawkes step's thinning tests, on each side (p, m): lambda before the
    step, the test's uniform, and where the jump fired."""
    lam: Tuple[torch.Tensor, torch.Tensor]
    u: Tuple[torch.Tensor, torch.Tensor]
    fired: Tuple[torch.Tensor, torch.Tensor]


def _hawkes_steps(seed: int, x: torch.Tensor, lam_p: torch.Tensor, lam_m: torch.Tensor,
                  nb_steps: int, a: np.ndarray):
    """the plain version's steps from (x, lambda_p, lambda_m) with the 19
    scalars ``a`` of :func:`_hawkes_args`: yields, after each step, the state
    and the step's :class:`_ThinningDraws`."""
    drift_dt = float((a[0] - (np.float32(0.5) * a[1]) * a[1]) * a[16])
    (mu, sigma, shift_p, mean_p, shift_m, mean_m, theta_p, kappa_p, beta1_p, beta2_p, theta_m,
     kappa_m, beta1_m, beta2_m, comp_p_dt, comp_m_dt, dt, sdt, inv_dt) = (float(v) for v in a)
    rng = _PathNormals(seed, x.shape[0], x.device)
    uniform = lambda step, stream: uniform_from_bits(rng.bits(step, stream))
    for step in range(nb_steps):
        r = torch.sqrt(torch.clamp(-2.0 * poly_log(uniform(step, 0)), min=0.0))
        z = r * poly_cospi(uniform(step, 1))
        u_up, u_um, u_jp, u_jm = (uniform(step, stream) for stream in (2, 3, 4, 5))
        e_up, e_um, e_jp, e_jm = (-poly_log(u) for u in (u_up, u_um, u_jp, u_jm))
        j_p = shift_p + e_jp * mean_p
        j_m = shift_m - e_jm * (-mean_m)
        diffusion = ((drift_dt - comp_p_dt * lam_p) - comp_m_dt * lam_m) + sigma * (z * sdt)
        fired = (lam_p > e_up * inv_dt, lam_m > e_um * inv_dt)
        draws = _ThinningDraws((lam_p, lam_m), (u_up, u_um), fired)
        jump_p = torch.where(fired[0], j_p, 0.0)
        jump_m = torch.where(fired[1], j_m, 0.0)
        x = ((x + diffusion) + jump_p) + jump_m
        load_p = beta1_p * jump_p + beta2_p * jump_m
        load_m = beta1_m * jump_p + beta2_m * jump_m
        lam_p = (lam_p + (kappa_p * (theta_p - lam_p)) * dt) + load_p
        lam_m = (lam_m + (kappa_m * (theta_m - lam_m)) * dt) + load_m
        yield (x, lam_p, lam_m), draws


def hawkes_pretest_bound(u: torch.Tensor, inv_dt: float) -> torch.Tensor:
    """the bound of ``csrc/hawkes_mc.cu``'s thinning pre-test, in its float32
    arithmetic: ((1 - u) - PRETEST_C) * (inv_dt * (1 - PRETEST_MARGIN))."""
    f32 = np.float32
    pre_scale = float(f32(inv_dt) * (f32(1.0) - f32(PRETEST_MARGIN)))
    return ((1.0 - u) - float(f32(PRETEST_C))) * pre_scale


def hawkes_pretest_rules_out(lam: torch.Tensor, u: torch.Tensor, inv_dt: float) -> torch.Tensor:
    """where the pre-test proves that ``lam > -ln(u) * inv_dt`` cannot fire,
    so the kernel skips the logarithm: lam < the bound; False for NaN lam."""
    return lam < hawkes_pretest_bound(u, inv_dt)


WARP = 32  # paths a CUDA warp steps together


def hawkes_branch_shares(seed: int, x0: torch.Tensor, lambda_p0: torch.Tensor,
                         lambda_m0: torch.Tensor, ttm: float, nb_steps_per_year: int = 1800,
                         **params) -> dict:
    """how often ``csrc/hawkes_mc.cu``'s branches run on these inputs, from the
    plain version's draws: for each side ``"p"`` and ``"m"``, the share of
    path-steps whose pre-test fails (``"log"``: the exact test runs) and
    whose jump fires (``"jump"``), and the same shares of (32-path warp,
    step) pairs in which some path does (``"warp_log"``, ``"warp_jump"``).
    ``params`` are the model parameters of simulate_hawkesjd_terminal_torch;
    nb_path must be a multiple of 32."""
    _check_paths(x0, lambda_p0, lambda_m0)
    nb_steps, a = _hawkes_args(ttm, nb_steps_per_year=nb_steps_per_year, **params)
    inv_dt = float(a[18])
    counts = {f"{k}_{side}": 0 for k in ("log", "jump", "warp_log", "warp_jump")
              for side in "pm"}
    for _, draws in _hawkes_steps(seed, x0, lambda_p0, lambda_m0, nb_steps, a):
        for side, lam, u, fired in zip("pm", draws.lam, draws.u, draws.fired):
            log = ~hawkes_pretest_rules_out(lam, u, inv_dt)
            for name, taken in (("log", log), ("jump", fired)):
                counts[f"{name}_{side}"] += int(taken.sum())
                counts[f"warp_{name}_{side}"] += int(taken.view(-1, WARP).any(dim=1).sum())
    path_steps = x0.shape[0] * nb_steps
    return {k: v / (path_steps / WARP if k.startswith("warp") else path_steps)
            for k, v in counts.items()}


def simulate_hawkesjd_terminal_cuda(seed: int,
                                    x0: torch.Tensor,
                                    lambda_p0: torch.Tensor,
                                    lambda_m0: torch.Tensor,
                                    ttm: float,
                                    mu: float,
                                    sigma: float,
                                    shift_p: float,
                                    mean_p: float,
                                    shift_m: float,
                                    mean_m: float,
                                    theta_p: float,
                                    kappa_p: float,
                                    beta1_p: float,
                                    beta2_p: float,
                                    theta_m: float,
                                    kappa_m: float,
                                    beta1_m: float,
                                    beta2_m: float,
                                    nb_steps_per_year: int = 1800
                                    ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """terminal (x, lambda_p, lambda_m) of the Hawkes JD model by the
    hand-written CUDA kernel.

    Mirrors ``simulate_hawkesjd_terminal_pallas``: (nb_path,) float32,
    contiguous CUDA tensors, nb_path a multiple of 128.  Launches on the
    current stream without synchronising; a refused launch raises.
    ``simulate_hawkesjd_terminal_cuda.launches`` counts launches.
    """
    nb_path = _check_paths(x0, lambda_p0, lambda_m0)
    _check_cuda_state(x0, lambda_p0, lambda_m0)
    launch = _launcher("hawkes_mc", _STATE_LAUNCH_ARGTYPES)
    nb_steps, a = _hawkes_args(ttm, mu, sigma, shift_p, mean_p, shift_m, mean_m, theta_p, kappa_p,
                               beta1_p, beta2_p, theta_m, kappa_m, beta1_m, beta2_m,
                               nb_steps_per_year)
    host_args = np.concatenate([a, LOG_C])
    x, lam_p, lam_m = (torch.empty_like(x0) for _ in range(3))
    with torch.cuda.device(x0.device):
        stream = torch.cuda.current_stream().cuda_stream
        err = launch(x0.data_ptr(), lambda_p0.data_ptr(), lambda_m0.data_ptr(),
                     x.data_ptr(), lam_p.data_ptr(), lam_m.data_ptr(),
                     nb_path, int(seed) & _M32, nb_steps, host_args.ctypes.data, stream)
    _raise_on_error("hawkes_mc", err)
    simulate_hawkesjd_terminal_cuda.launches += 1
    return x, lam_p, lam_m


simulate_hawkesjd_terminal_cuda.launches = 0


def simulate_hawkesjd_terminal_kernel(seed: int, x0: torch.Tensor, lambda_p0: torch.Tensor,
                                      lambda_m0: torch.Tensor, **kwargs
                                      ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """the Hawkes chain pricer's path loop: CUDA tensors run the CUDA kernel,
    CPU tensors its plain version.  Nothing else dispatches.  One
    ``MC_PATH_SPAN``."""
    with annotate(MC_PATH_SPAN):
        if x0.device.type == "cuda":
            return simulate_hawkesjd_terminal_cuda(seed, x0, lambda_p0, lambda_m0, **kwargs)
        if x0.device.type == "cpu":
            return simulate_hawkesjd_terminal_torch(seed, x0, lambda_p0, lambda_m0, **kwargs)
    raise ValueError(f"no Hawkes MC kernel for device {x0.device}")


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
