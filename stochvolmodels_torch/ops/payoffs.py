"""
Monte-Carlo payoff evaluation for vanilla, inverse and quadratic-variance
options.

PyTorch counterpart of ``stochvolmodels_tpu/ops/payoffs.py``, computed in
float64 whatever the dtype of the simulated state:

* simulated spots are recentred on the forward before payoffs, so put-call
  parity holds across the slice;
* means and stds drop NaN paths, as ``jnp.nanmean`` and ``jnp.nanstd`` do
  (torch has no ``nanstd``: :func:`nanstd` is written here);
* the returned std is the standard error ``nanstd / sqrt(nb_path)``; with
  ``antithetic`` it is taken over the P/2 pair averages, and with
  ``nb_replicates`` R over the R replicate means (ddof 1).

:func:`mc_vars_payoff` keeps tensors (the MC calibration and the MC greeks
differentiate through it) and runs on any device.
:func:`mc_vars_payoff_cuda` computes the same on the card by the
hand-written kernels of ``csrc/mc_payoff.cu`` (three passes over the
terminal state and a last step, no (strikes, paths) panel, no gradient).
:func:`compute_mc_vars_payoff` returns numpy: CUDA tensors take the kernels,
CPU tensors the plain version.
"""
from __future__ import annotations

import ctypes
import functools
import math
from typing import Tuple

import numpy as np
import torch

from stochvolmodels_torch.config import VariableType
from stochvolmodels_torch.ops.bsm import as_option_codes
from stochvolmodels_torch.ops.cuda_mc import _launcher, _raise_on_error
from stochvolmodels_torch.utils.profiling import MC_PAYOFF_SPAN, annotate, to_device, to_host

# csrc/mc_payoff.cu: threads a block, strikes a tile, and the blocks of 256
# threads that an SM holds at once (__launch_bounds__(256, 2))
PAYOFF_THREADS, PAYOFF_TILE, PAYOFF_BLOCKS_PER_SM = 256, 16, 2
# mc_payoff_launch: (x, q, x_is_f64, paired, qvar, strikes, codes, prices,
# stds, dscratch, iscratch, nb_path, nb_strikes, nb_groups, bx_spot, bx_pay,
# host args, stream)
PAYOFF_LAUNCH_ARGTYPES = ([ctypes.c_void_p] * 2 + [ctypes.c_int] * 3 + [ctypes.c_void_p] * 6
                          + [ctypes.c_longlong] + [ctypes.c_int] * 4 + [ctypes.c_void_p] * 2)


def nanstd(a: torch.Tensor, dim: int, ddof: int = 0) -> torch.Tensor:
    """NaN-dropping standard deviation along ``dim``, as ``jnp.nanstd``:
    sum over the finite-or-inf entries of (a - nanmean)^2 over (count -
    ddof), NaN where that count is not above ``ddof``."""
    nan = torch.isnan(a)
    mean = torch.nanmean(a, dim=dim, keepdim=True)
    centered = torch.where(nan, 0.0, a - mean)
    count = (~nan).sum(dim=dim).to(a.dtype)
    var = torch.sum(centered * centered, dim=dim) / (count - ddof)
    return torch.sqrt(torch.where(count > ddof, var, torch.nan))


def _underlying(x: torch.Tensor, qvar: torch.Tensor, ttm, forward,
                variable_type: VariableType) -> Tuple[torch.Tensor, torch.Tensor]:
    """(spots recentred on the forward along the last axis, the payoff's
    underlying): the spots for LOG_RETURN, annualised qvar for Q_VAR."""
    spots = forward * torch.exp(x)
    spots = spots - (torch.nanmean(spots, dim=-1, keepdim=True) - forward)
    if variable_type == VariableType.LOG_RETURN:
        return spots, spots
    if variable_type == VariableType.Q_VAR:
        return spots, qvar / ttm
    raise NotImplementedError(f"variable_type={variable_type}")


def _payoffs(u: torch.Tensor, spots: torch.Tensor, strikes: torch.Tensor,
             codes: torch.Tensor) -> torch.Tensor:
    """(K, ...) payoffs of calls and puts (inverse: over the spot) on the
    underlying ``u`` (...), strikes and codes (K,)."""
    extra = (None,) * u.dim()
    k = strikes[(slice(None),) + extra]
    c = codes[(slice(None),) + extra]
    is_call = (c & 1).to(torch.bool)
    is_inverse = (c & 2).to(torch.bool)
    call_pay = torch.where(u > k, u - k, 0.0)
    put_pay = torch.where(u < k, k - u, 0.0)
    payoff = torch.where(is_call, call_pay, put_pay)
    return torch.where(is_inverse, payoff / spots, payoff)


@annotate(MC_PAYOFF_SPAN)
def mc_vars_payoff(x0: torch.Tensor,
                   qvar0: torch.Tensor,
                   ttm,
                   forward,
                   strikes: torch.Tensor,
                   codes: torch.Tensor,
                   discfactor=1.0,
                   variable_type: VariableType = VariableType.LOG_RETURN,
                   antithetic: bool = False,
                   nb_replicates: int = 0
                   ) -> Tuple[torch.Tensor, torch.Tensor]:
    """(discounted mean payoff, standard error) per strike, as float64
    tensors that carry the gradients of the paths and of ``forward``.

    ``strikes`` (K,) float64 and ``codes`` (K,) int8 on the paths' device;
    ``ttm``, ``forward`` and ``discfactor`` are floats or 0-dim tensors.
    ``antithetic``: path i and i + P/2 are a pair, the stderr is over the
    pair averages.  ``nb_replicates`` R > 1: the paths are R contiguous
    replicate groups, each recentred on its own, the price is the mean of
    the replicate means and the stderr their std (ddof 1) over sqrt(R).
    """
    if antithetic and nb_replicates > 1:
        raise NotImplementedError("antithetic pairing and QMC replicates are mutually "
                                  "exclusive reductions")
    x = x0.to(torch.float64)
    qvar = qvar0.to(torch.float64)
    nb_path = x.shape[0]
    if nb_replicates > 1:
        if nb_path % nb_replicates:
            raise ValueError(f"nb_path={nb_path} not divisible by nb_replicates={nb_replicates}")
        x = x.reshape(nb_replicates, -1)
        qvar = qvar.reshape(nb_replicates, -1)
    spots, u = _underlying(x, qvar, ttm, forward, variable_type)
    payoff = _payoffs(u, spots, strikes, codes)
    if nb_replicates > 1:
        rep_means = torch.nanmean(payoff, dim=2)                     # (K, R)
        return (discfactor * torch.nanmean(rep_means, dim=1),
                discfactor * nanstd(rep_means, dim=1, ddof=1) / math.sqrt(nb_replicates))
    if antithetic:
        half = nb_path // 2
        payoff = 0.5 * (payoff[:, :half] + payoff[:, half:])
        nb_path = half
    return (discfactor * torch.nanmean(payoff, dim=1),
            discfactor * nanstd(payoff, dim=1) / math.sqrt(nb_path))


def payoff_grid(nb_path: int, nb_strikes: int, nb_groups: int, paired: bool, pack: int,
                target_blocks: int) -> Tuple[int, int]:
    """(blocks along a group's paths in the spot pass, blocks along the
    paths of a (group, strike tile) in the payoff passes): about
    ``target_blocks`` in each pass, and no more than the packs of ``pack``
    paths give a thread one each."""
    tiles = -(-nb_strikes // PAYOFF_TILE)
    per_block = PAYOFF_THREADS * pack
    spot_len = nb_path // nb_groups
    pay_len = nb_path // 2 if paired else spot_len
    bx_spot = max(1, min(target_blocks // nb_groups, -(-spot_len // per_block)))
    bx_pay = max(1, min(target_blocks // (nb_groups * tiles), -(-pay_len // per_block)))
    return bx_spot, bx_pay


def payoff_scratch_sizes(nb_strikes: int, nb_groups: int, bx_spot: int, bx_pay: int
                         ) -> Tuple[int, int]:
    """(float64, int64) entries of the kernels' partial sums: the spots'
    sums and NaN counts, each strike's payoff sums and NaN counts, and each
    strike's squared deviations."""
    spot, pay = nb_groups * bx_spot, nb_strikes * nb_groups * bx_pay
    return spot + pay + nb_strikes * bx_pay, spot + pay


@functools.lru_cache(maxsize=None)
def _sm_count(index: int) -> int:
    return torch.cuda.get_device_properties(index).multi_processor_count


def _check_payoff_inputs(x0: torch.Tensor, qvar0: torch.Tensor, strikes: torch.Tensor,
                         codes: torch.Tensor) -> None:
    if x0.dim() != 1 or qvar0.shape != x0.shape:
        raise ValueError("x0 and qvar0 must be 1-D of one length")
    if x0.dtype not in (torch.float32, torch.float64) or qvar0.dtype != x0.dtype:
        raise TypeError(f"the payoff kernels take float32 or float64 state of one dtype, got "
                        f"{x0.dtype} and {qvar0.dtype}")
    if strikes.dtype != torch.float64 or codes.dtype != torch.int8:
        raise TypeError(f"strikes must be float64 and codes int8, got {strikes.dtype} and "
                        f"{codes.dtype}")
    if strikes.dim() != 1 or codes.shape != strikes.shape:
        raise ValueError("strikes and codes must be 1-D of one length")
    if not all(t.is_contiguous() for t in (x0, qvar0, strikes, codes)):
        raise ValueError("the payoff kernels take contiguous tensors")
    if x0.device.type != "cuda":
        raise ValueError(f"the payoff kernels need CUDA tensors, got {x0.device}")
    if any(t.device != x0.device for t in (qvar0, strikes, codes)):
        raise ValueError("x0, qvar0, strikes and codes must be on one device")


@annotate(MC_PAYOFF_SPAN)
def mc_vars_payoff_cuda(x0: torch.Tensor,
                        qvar0: torch.Tensor,
                        ttm: float,
                        forward: float,
                        strikes: torch.Tensor,
                        codes: torch.Tensor,
                        discfactor: float = 1.0,
                        variable_type: VariableType = VariableType.LOG_RETURN,
                        antithetic: bool = False,
                        nb_replicates: int = 0
                        ) -> Tuple[torch.Tensor, torch.Tensor]:
    """(discounted mean payoff, standard error) per strike by the
    hand-written kernels of ``csrc/mc_payoff.cu``, as float64 CUDA tensors
    without gradient: what :func:`mc_vars_payoff` computes on the card, the
    same float64 operation on each element, summed in another order.

    ``x0``/``qvar0``: (nb_path,) float32 or float64, contiguous, on one CUDA
    device (``qvar0`` is read for ``Q_VAR`` only); ``strikes`` (K,) float64
    and ``codes`` (K,) int8 there too.  Launches three or four kernels on the
    current stream without synchronising; anything else, or a refused launch,
    raises.  ``mc_vars_payoff_cuda.launches`` counts calls that launch.
    """
    if antithetic and nb_replicates > 1:
        raise NotImplementedError("antithetic pairing and QMC replicates are mutually "
                                  "exclusive reductions")
    if variable_type not in (VariableType.LOG_RETURN, VariableType.Q_VAR):
        raise NotImplementedError(f"variable_type={variable_type}")
    _check_payoff_inputs(x0, qvar0, strikes, codes)
    nb_path, nb_strikes = x0.shape[0], strikes.shape[0]
    nb_groups = nb_replicates if nb_replicates > 1 else 1
    if nb_path == 0 or nb_path % nb_groups or (antithetic and nb_path % 2):
        raise ValueError(f"nb_path={nb_path} must be positive and divisible by the "
                         f"replicates ({nb_groups}) or, antithetic, by 2")
    prices = torch.empty(nb_strikes, dtype=torch.float64, device=x0.device)
    stds = torch.empty(nb_strikes, dtype=torch.float64, device=x0.device)
    if nb_strikes == 0:
        return prices, stds
    launch = _launcher("mc_payoff", PAYOFF_LAUNCH_ARGTYPES)
    is_f64 = x0.dtype == torch.float64
    bx_spot, bx_pay = payoff_grid(nb_path, nb_strikes, nb_groups, antithetic, 2 if is_f64 else 4,
                                  PAYOFF_BLOCKS_PER_SM * _sm_count(x0.device.index or 0))
    nd, ni = payoff_scratch_sizes(nb_strikes, nb_groups, bx_spot, bx_pay)
    dscratch = torch.empty(nd, dtype=torch.float64, device=x0.device)
    iscratch = torch.empty(ni, dtype=torch.int64, device=x0.device)
    is_qvar = variable_type == VariableType.Q_VAR
    nb_sample = nb_groups if nb_groups > 1 else (nb_path // 2 if antithetic else nb_path)
    # the card divides a tensor by a number through the number's reciprocal, rounded on the host
    host_args = np.array([forward, 1.0 / ttm if is_qvar else 0.0, discfactor,
                          1.0 / math.sqrt(nb_sample)], dtype=np.float64)
    with torch.cuda.device(x0.device):
        stream = torch.cuda.current_stream().cuda_stream
        err = launch(x0.data_ptr(), qvar0.data_ptr(), int(is_f64), int(antithetic), int(is_qvar),
                     strikes.data_ptr(), codes.data_ptr(), prices.data_ptr(), stds.data_ptr(),
                     dscratch.data_ptr(), iscratch.data_ptr(), nb_path, nb_strikes, nb_groups,
                     bx_spot, bx_pay, host_args.ctypes.data, stream)
    _raise_on_error("mc_payoff", err)
    mc_vars_payoff_cuda.launches += 1
    return prices, stds


mc_vars_payoff_cuda.launches = 0


def compute_mc_vars_payoff(x0: torch.Tensor,
                           sigma0: torch.Tensor,
                           qvar0: torch.Tensor,
                           ttm: float,
                           forward: float,
                           strikes_ttm,
                           optiontypes_ttm,
                           discfactor: float = 1.0,
                           variable_type: VariableType = VariableType.LOG_RETURN,
                           antithetic: bool = False,
                           nb_replicates: int = 0
                           ) -> Tuple[np.ndarray, np.ndarray]:
    """discounted mean payoff and standard error per strike for one slice,
    as numpy ((K,), (K,)).

    ``x0``/``qvar0``: terminal log-return and quadratic variance paths
    (nb_path,); ``sigma0`` is accepted for signature symmetry and unused.
    The reductions are those of :func:`mc_vars_payoff`: on a CUDA device by
    :func:`mc_vars_payoff_cuda`, on the CPU by :func:`mc_vars_payoff`.
    Strikes and string option types go up and the results come back through
    ``utils/profiling``'s transfers: four a slice.
    """
    del sigma0
    device = x0.device
    if device.type == "cuda":
        payoff, x0, qvar0 = mc_vars_payoff_cuda, x0.contiguous(), qvar0.contiguous()
    else:
        payoff = mc_vars_payoff
    strikes = to_device(np.asarray(strikes_ttm, dtype=np.float64), torch.float64, device)
    codes = as_option_codes(optiontypes_ttm, device)
    prices, stds = payoff(x0, qvar0, float(ttm), float(forward), strikes, codes,
                          discfactor=float(discfactor), variable_type=variable_type,
                          antithetic=antithetic, nb_replicates=nb_replicates)
    return to_host(prices), to_host(stds)
