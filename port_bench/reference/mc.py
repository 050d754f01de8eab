"""
Plain reference of the Monte-Carlo chain: the counter-based random stream,
the chain loop that carries the terminal state across maturities, and the
payoff reductions.

The random stream is the published one of the original TPU kernels, which
the models' Euler steps draw from: path p of a 32,768-path block takes the
block seed ``seed + (p >> 15)`` and the in-block index ``p & 32767``; step
s, stream j draws ``murmur3(idx ^ murmur3(seed 0x9E3779B9 + s 0x7FEB352D +
j 0x846CA68B))`` (uint32 arithmetic, carried here in int64), and the two
normals of a step come from a sign-bit Box-Muller with a degree-6
polynomial ln and an odd minimax cos.  Slice i of a chain takes the seed
``base + 7919 i``.  The state's precision is an argument (float32 for the
reference, bfloat16 for the control); payoffs run in ``payoff_dtype``.
"""
from __future__ import annotations

import math
from typing import Callable, Dict, List, Tuple

import numpy as np
import torch

from .common import OPTION_CODES

LANES = 128
BLOCK_PATHS = 256 * LANES
M32 = 0xFFFFFFFF
_NODES = 0.5 - 0.5 * np.cos((2 * np.arange(1, 201) - 1) * np.pi / 400)
LOG_C = np.polyfit(_NODES, np.log1p(_NODES) / _NODES, 6).astype(np.float32)
LN2_F32 = float(np.float32(0.6931471805599453))
HALF_PI_F32 = float(np.float32(np.pi / 2.0))
SIN_C = [float(np.float32(c)) for c in (-0.16666658, 0.008332824, -0.00019810997,
                                        2.7525562e-06)]
FLT_MIN = 1.1754944e-38


def time_grid(ttm: float, year_steps: int) -> Tuple[int, float]:
    """(steps, dt) of one slice: int(ttm year_steps) + 1 steps, dt the first
    spacing of the linspace over [0, ttm]."""
    nb_steps = int(ttm * year_steps) + 1
    grid = np.linspace(0.0, ttm, nb_steps + 1)
    return nb_steps, float(grid[1] - grid[0])


def _mul32(x: torch.Tensor, c: int) -> torch.Tensor:
    lo, hi = c & 0xFFFF, c >> 16
    return (x * lo + (((x * hi) & 0xFFFF) << 16)) & M32


def _hash(x: torch.Tensor) -> torch.Tensor:
    x = x ^ (x >> 16)
    x = _mul32(x, 0x85EBCA6B)
    x = x ^ (x >> 13)
    x = _mul32(x, 0xC2B2AE35)
    return x ^ (x >> 16)


def _key(seed: torch.Tensor, salt: int, stream: int) -> torch.Tensor:
    return _hash((_mul32(seed & M32, 0x9E3779B9) + ((salt * 0x7FEB352D) & M32)
                  + ((stream * 0x846CA68B) & M32)) & M32)


def _uniform(bits: torch.Tensor) -> torch.Tensor:
    f = ((bits >> 9) | 0x3F800000).to(torch.int32).view(torch.float32)
    return torch.clamp(f - 1.0, min=FLT_MIN)


def _poly_log(u: torch.Tensor) -> torch.Tensor:
    bits = u.view(torch.int32)
    e = (bits >> 23) - 127
    f = ((bits & 0x007FFFFF) | 0x3F800000).view(torch.float32) - 1.0
    p = torch.full_like(f, float(LOG_C[0]))
    for c in LOG_C[1:]:
        p = p * f + float(c)
    return e.to(torch.float32) * LN2_F32 + f * p


def _poly_cospi(u: torch.Tensor) -> torch.Tensor:
    x = (2.0 * u - 1.0) * HALF_PI_F32
    x2 = x * x
    s = x * (1.0 + x2 * (SIN_C[0] + x2 * (SIN_C[1] + x2 * (SIN_C[2] + x2 * SIN_C[3]))))
    return -s


class Normals:
    """the two float32 normals of every path at each step."""

    def __init__(self, seed: int, nb_path: int, device):
        p = torch.arange(nb_path, dtype=torch.int64, device=device)
        self.idx = p & (BLOCK_PATHS - 1)
        self.block = p >> 15
        nb_blocks = (nb_path + BLOCK_PATHS - 1) // BLOCK_PATHS
        self.seeds = int(seed) + torch.arange(nb_blocks, dtype=torch.int64, device=device)

    def step(self, step: int) -> Tuple[torch.Tensor, torch.Tensor]:
        b1 = _hash(self.idx ^ _key(self.seeds, step, 0)[self.block])
        b2 = _hash(self.idx ^ _key(self.seeds, step, 1)[self.block])
        r = torch.sqrt(torch.clamp(-2.0 * _poly_log(_uniform(b1)), min=0.0))
        c = _poly_cospi(_uniform(b2))
        sign = torch.where((b2 & 1) == 0, 1.0, -1.0).to(torch.float32)
        return r * c, r * (sign * torch.sqrt(torch.clamp(1.0 - c * c, min=0.0)))


def _nanstd(a: torch.Tensor, dim: int) -> torch.Tensor:
    nan = torch.isnan(a)
    mean = torch.nanmean(a, dim=dim, keepdim=True)
    centered = torch.where(nan, 0.0, a - mean)
    count = (~nan).sum(dim=dim).to(a.dtype)
    var = torch.sum(centered * centered, dim=dim) / count
    return torch.sqrt(torch.where(count > 0, var, torch.nan))


def payoffs(x: torch.Tensor, forward: float, strikes: np.ndarray, types, discfactor: float,
            dtype: torch.dtype) -> Tuple[np.ndarray, np.ndarray]:
    """(discounted mean payoff, standard error) per strike of one slice from
    the terminal log-returns ``x``: spots recentred on the forward, calls and
    puts (inverse ones over the spot), NaN paths dropped."""
    nb_path = x.shape[0]
    x = x.to(dtype)
    spots = forward * torch.exp(x)
    spots = spots - (torch.nanmean(spots, dim=-1, keepdim=True) - forward)
    codes = torch.as_tensor([OPTION_CODES[str(t)] for t in types], device=x.device)
    k = torch.as_tensor(np.asarray(strikes), dtype=dtype, device=x.device)[:, None]
    is_call = (codes & 1).to(torch.bool)[:, None]
    is_inverse = (codes & 2).to(torch.bool)[:, None]
    pay = torch.where(is_call, torch.where(spots > k, spots - k, 0.0),
                      torch.where(spots < k, k - spots, 0.0))
    pay = torch.where(is_inverse, pay / spots, pay)
    price = discfactor * torch.nanmean(pay, dim=1)
    stderr = discfactor * _nanstd(pay, dim=1) / math.sqrt(nb_path)
    return (price.double().cpu().numpy(), stderr.double().cpu().numpy())


def mc_chain(advance: Callable, state0: Callable[[int], Tuple[torch.Tensor, ...]],
             quotes: Dict, nb_path: int, seed: int, year_steps: int,
             payoff_dtype: torch.dtype) -> Tuple[List[np.ndarray], List[np.ndarray]]:
    """chain prices and standard errors: ``state0(nb_pad)`` is (x, v, qvar),
    ``advance(seed, state, nb_steps, dt)`` the model's Euler loop over one
    slice; the state is carried from slice to slice."""
    nb_pad = ((nb_path + LANES - 1) // LANES) * LANES
    state = state0(nb_pad)
    prices, stderrs = [], []
    ttm0 = 0.0
    for i, ttm in enumerate(quotes["ttms"]):
        nb_steps, dt = time_grid(float(ttm - ttm0), year_steps)
        state = advance(seed + 7919 * i, state, nb_steps, dt)
        ttm0 = float(ttm)
        p, s = payoffs(state[0][:nb_path], float(quotes["forwards"][i]), quotes["strikes"][i],
                       quotes["types"][i], float(quotes["discfactors"][i]), payoff_dtype)
        prices.append(p)
        stderrs.append(s)
    return prices, stderrs
