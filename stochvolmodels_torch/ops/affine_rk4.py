"""
The LogSV affine RK4 of a whole chain as one kernel launch: the log-MGF
panel of every maturity, and its sensitivities in the six model parameters.

The chain's maturities fix a host schedule (:func:`chain_schedule`: a step
count and a step size per maturity segment, as ``solve_a_ode_grid`` sets
them); the 5-term state of the SECOND-order expansion under the spot measure
(vol backbone eta 1, psi 0) advances over it on the transform grid, carried
from one maturity to the next, and is contracted with (1, y, .., y^4), y =
sigma0 - theta, at each maturity: a (T, N) complex128 panel.

* :func:`log_mgf_chain_plain` is the plain PyTorch version: the chain loop of
  ``models/logsv/affine.py``'s RK4 and ``contract_log_mgf``, with the bits of
  ``logsv_chain_price_grid``'s panels.
* :func:`log_mgf_chain_cuda` launches the hand-written kernel of
  ``csrc/affine_rk4.cu`` (the panel, or with ``tangents`` the panel and its
  (6, T, N) partials in sigma0, theta, kappa1, kappa2, beta, volvol) on the
  current stream; it raises on anything the kernel does not take.
* :func:`log_mgf_chain` is the calibration objectives' entry: a CUDA grid
  takes the kernel through a ``torch.autograd.Function`` whose forward-mode
  rule contracts the tangent launch's partials with the input tangents
  (``torch.func.jacfwd``), whose reverse-mode rule is built from the same
  partials (``backward``), and whose ``vmap`` rule folds a batch of chains
  into the kernel's chain axis; a CPU grid takes the plain version.  The
  partials are first-order only: a second derivative through this entry
  raises.
"""
from __future__ import annotations

import ctypes
import math
from typing import Sequence, Tuple

import numpy as np
import torch

from stochvolmodels_torch.models.logsv import affine as afe
from stochvolmodels_torch.models.logsv.affine import ExpansionOrder
from stochvolmodels_torch.ops.cuda_mc import _batch_first, _launcher, _raise_on_error

# a host step schedule: (steps, dt) of each maturity segment
Schedule = Tuple[Tuple[int, float], ...]

PARAMS = ("sigma0", "theta", "kappa1", "kappa2", "beta", "volvol")
# csrc/affine_rk4.cu: the most maturities a launch takes (its kMaxSegments)
MAX_SEGMENTS = 32
# float64 operations a point-step, counted from csrc/affine_rk4.cu: the
# primal RK4 step, and each of the five ODE directions' tangent on top of it
PRIMAL_FLOPS, DIRECTION_FLOPS = 1122, 2098
# affine_rk4_launch: (params, phi_grid, log_mgf, partials, tangent, chains,
# points, segments, steps, dts, stream)
LAUNCH_ARGTYPES = ([ctypes.c_void_p] * 4 + [ctypes.c_int] * 4 + [ctypes.c_void_p] * 3)


def chain_schedule(ttms_static: Sequence[float], year_steps: int) -> Schedule:
    """(steps, dt) of each maturity segment: max(ceil(year_steps x span),
    16) uniform steps over the span from the previous maturity, as
    ``logsv_chain_price_grid`` calls ``solve_a_ode_grid``."""
    out, ttm0 = [], 0.0
    for ttm in ttms_static:
        span = float(ttm - ttm0)
        steps = max(int(np.ceil(year_steps * span)), 16)
        out.append((steps, span / steps))
        ttm0 = ttm
    return tuple(out)


def log_mgf_chain_plain(pvec: torch.Tensor, phi_grid: torch.Tensor, schedule: Schedule
                        ) -> torch.Tensor:
    """the (T, N) complex128 log-MGF panel of one chain by the torch-op RK4:
    ``pvec`` (6,) float64 (sigma0, theta, kappa1, kappa2, beta, volvol),
    ``phi_grid`` (N,) complex128."""
    sigma0, theta, kappa1, kappa2, beta, volvol = pvec.unbind(-1)
    psi_grid = torch.zeros_like(phi_grid)
    a_t = torch.zeros((phi_grid.shape[0], 5), dtype=torch.complex128, device=phi_grid.device)
    panel = []
    for steps, dt in schedule:
        a_t = afe._solve_a_ode_grid_dts([dt] * steps, theta, kappa1, kappa2, beta, volvol,
                                        phi_grid, psi_grid, a_t, True, ExpansionOrder.SECOND, 1.0)
        panel.append(afe.contract_log_mgf(a_t, sigma0 - theta, ExpansionOrder.SECOND))
    return torch.stack(panel)


def _check_schedule(schedule: Schedule) -> None:
    if not 1 <= len(schedule) <= MAX_SEGMENTS:
        raise ValueError(f"the affine RK4 kernel takes 1 to {MAX_SEGMENTS} maturities, got "
                         f"{len(schedule)}")
    for steps, dt in schedule:
        if not (isinstance(steps, int) and 1 <= steps < 2 ** 31 and math.isfinite(dt)):
            raise ValueError(f"the affine RK4 kernel takes a positive step count and a finite "
                             f"dt a maturity, got ({steps}, {dt})")


def _check_inputs(pvec: torch.Tensor, phi_grid: torch.Tensor) -> None:
    if pvec.dtype != torch.float64 or phi_grid.dtype != torch.complex128:
        raise TypeError(f"the affine RK4 kernel takes float64 parameters and a complex128 grid, "
                        f"got {pvec.dtype} and {phi_grid.dtype}")
    if pvec.dim() < 1 or pvec.shape[-1] != len(PARAMS) or phi_grid.dim() != pvec.dim() \
            or phi_grid.shape[:-1] != pvec.shape[:-1]:
        raise ValueError(f"parameters (..., 6) and a grid (..., N) of one batch shape, got "
                         f"{tuple(pvec.shape)} and {tuple(phi_grid.shape)}")
    if pvec.device.type != "cuda":
        raise ValueError(f"the affine RK4 kernel needs CUDA tensors, got {pvec.device}")
    if phi_grid.device != pvec.device:
        raise ValueError("the parameters and the grid must be on one device")
    if not (pvec.is_contiguous() and phi_grid.is_contiguous()):
        raise ValueError("the affine RK4 kernel takes contiguous tensors")


def log_mgf_chain_cuda(pvec: torch.Tensor, phi_grid: torch.Tensor, schedule: Schedule,
                       tangents: bool = False,
                       expansion_order: ExpansionOrder = ExpansionOrder.SECOND,
                       is_spot_measure: bool = True):
    """the log-MGF panel (..., T, N) by ``csrc/affine_rk4.cu``, or with
    ``tangents`` (panel, partials (..., 6, T, N)), complex128 CUDA tensors
    without gradient.

    ``pvec`` (..., 6) float64 and ``phi_grid`` (..., N) complex128,
    contiguous, on one CUDA device, with one batch shape: each batch entry
    is a chain of the kernel's chain axis.  SECOND order under the spot
    measure only.  Launches one kernel on the current stream without
    synchronising; anything else, or a refused launch, raises.  Counts:
    ``log_mgf_chain_cuda.launches`` (primal launches) and
    ``.tangent_launches``.
    """
    if expansion_order != ExpansionOrder.SECOND or not is_spot_measure:
        raise NotImplementedError("the affine RK4 kernel runs the SECOND-order expansion under "
                                  "the spot measure only")
    _check_schedule(schedule)
    _check_inputs(pvec, phi_grid)
    batch, nb_points = tuple(pvec.shape[:-1]), phi_grid.shape[-1]
    nb_chains = math.prod(batch)
    if not (1 <= nb_chains and 5 * nb_chains < 2 ** 31 and 1 <= nb_points < 2 ** 31):
        raise ValueError(f"the affine RK4 kernel takes 1 to 2^31 / 5 chains of 1 to 2^31 "
                         f"points, got {nb_chains} of {nb_points}")
    nb_segments = len(schedule)
    kw = dict(dtype=torch.complex128, device=pvec.device)
    log_mgf = torch.empty(batch + (nb_segments, nb_points), **kw)
    partials = torch.empty(batch + (len(PARAMS), nb_segments, nb_points), **kw) if tangents \
        else None
    steps = np.array([s for s, _ in schedule], dtype=np.int32)
    # the plain version's 0.5 * dt and dt / 6.0, rounded on the host
    dts = np.array([[dt, 0.5 * dt, dt / 6.0] for _, dt in schedule], dtype=np.float64)
    launch = _launcher("affine_rk4", LAUNCH_ARGTYPES)
    with torch.cuda.device(pvec.device):
        stream = torch.cuda.current_stream().cuda_stream
        err = launch(pvec.data_ptr(), phi_grid.data_ptr(), log_mgf.data_ptr(),
                     partials.data_ptr() if tangents else None, int(tangents), nb_chains,
                     nb_points, nb_segments, steps.ctypes.data, dts.ctypes.data, stream)
    _raise_on_error("affine_rk4", err)
    if tangents:
        log_mgf_chain_cuda.tangent_launches += 1
    else:
        log_mgf_chain_cuda.launches += 1
    return (log_mgf, partials) if tangents else log_mgf


log_mgf_chain_cuda.launches = 0
log_mgf_chain_cuda.tangent_launches = 0


class _ChainPartials(torch.autograd.Function):
    """the tangent launch's (..., 6, T, N) partials: an op with a ``vmap``
    rule and no derivative of its own."""

    @staticmethod
    def forward(pvec, phi_grid, schedule):
        return log_mgf_chain_cuda(pvec.contiguous(), phi_grid.contiguous(), schedule,
                                  tangents=True)[1]

    @staticmethod
    def setup_context(ctx, inputs, output):
        pass

    @staticmethod
    def vmap(info, in_dims, pvec, phi_grid, schedule):
        return _ChainPartials.apply(_batch_first(pvec, in_dims[0], info.batch_size),
                                    _batch_first(phi_grid, in_dims[1], info.batch_size),
                                    schedule), 0


class _ChainLogMgf(torch.autograd.Function):
    """the log-MGF panel by the kernel, differentiable in the parameters
    (not in the grid: a tangent of it is dropped, a gradient raises):
    forward mode contracts the partials with the tangents, reverse mode
    takes Re(sum grad conj(partials))."""

    @staticmethod
    def forward(pvec, phi_grid, schedule):
        return log_mgf_chain_cuda(pvec.contiguous(), phi_grid.contiguous(), schedule)

    @staticmethod
    def setup_context(ctx, inputs, output):
        pvec, phi_grid, schedule = inputs
        ctx.schedule = schedule
        ctx.save_for_forward(pvec, phi_grid)
        ctx.save_for_backward(pvec, phi_grid)

    @staticmethod
    def jvp(ctx, d_pvec, _d_phi_grid, _d_schedule):
        # torch.func hands the grid a zero tangent where it has none; the
        # objectives' grid follows the vol scaler, which no fit moves
        pvec, phi_grid = ctx.saved_tensors
        partials = _ChainPartials.apply(pvec, phi_grid, ctx.schedule)
        return (partials * d_pvec[..., :, None, None]).sum(-3)

    @staticmethod
    def backward(ctx, grad):
        if ctx.needs_input_grad[1]:
            raise NotImplementedError("the affine RK4 kernel takes no gradient of the grid")
        pvec, phi_grid = ctx.saved_tensors
        partials = _ChainPartials.apply(pvec, phi_grid, ctx.schedule)
        return (grad[..., None, :, :] * partials.conj()).real.sum((-2, -1)), None, None

    @staticmethod
    def vmap(info, in_dims, pvec, phi_grid, schedule):
        return _ChainLogMgf.apply(_batch_first(pvec, in_dims[0], info.batch_size),
                                  _batch_first(phi_grid, in_dims[1], info.batch_size),
                                  schedule), 0


def _takes_kernel(phi_grid: torch.Tensor) -> bool:
    return phi_grid.is_cuda


def log_mgf_chain(pvec: torch.Tensor, phi_grid: torch.Tensor, schedule: Schedule
                  ) -> torch.Tensor:
    """the (T, N) complex128 log-MGF panel of a chain at the (6,) float64
    parameter vector (sigma0, theta, kappa1, kappa2, beta, volvol), SECOND
    order under the spot measure: by the kernel for a CUDA grid (forward
    and reverse mode, ``vmap``), by :func:`log_mgf_chain_plain` for a CPU
    one."""
    if _takes_kernel(phi_grid):
        return _ChainLogMgf.apply(pvec, phi_grid, schedule)
    return log_mgf_chain_plain(pvec, phi_grid, schedule)
