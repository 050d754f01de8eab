"""
Normal distribution helpers on tensors (array-likes go to the device
default, the card, as float64 tensors).

The BSM layer evaluates the normal CDF through the Numerical Recipes rational
approximation to erfc (accuracy ~1.2e-7), as the JAX package and its
reference do: implied vols agree across packages only with the same
approximation.
"""
from __future__ import annotations

import math

import numpy as np
import torch


# the rational fit's exponent: -z^2 + c0 + t (c1 + t (c2 + ... + t c9))
ERFCC_COEFFS = (-1.26551223, 1.00002368, 0.37409196, 0.09678418, -0.18628806,
                0.27886807, -1.13520398, 1.48851587, -0.82215223, 0.17087277)


def _device_of(*xs, device="cuda") -> torch.device:
    """the device of the first tensor among ``xs``, else ``device`` (the
    card: numpy inputs go to the card)."""
    for x in xs:
        if isinstance(x, torch.Tensor):
            return x.device
    return torch.device(device)


def _tensor(x) -> torch.Tensor:
    """``x`` itself if it is a tensor, else a float64 tensor of it on the
    device default (as the JAX package takes numpy arrays and floats)."""
    if isinstance(x, torch.Tensor):
        return x
    return torch.as_tensor(np.asarray(x, dtype=np.float64), device=_device_of())


def erfcc(x: torch.Tensor) -> torch.Tensor:
    """complementary error function by the Numerical Recipes rational fit."""
    x = _tensor(x)
    z = torch.abs(x)
    t = 1.0 / (1.0 + 0.5 * z)
    r = t * torch.exp(
        -z * z - 1.26551223 + t * (1.00002368 + t * (0.37409196 + t * (0.09678418 + t * (
            -0.18628806 + t * (0.27886807 + t * (-1.13520398 + t * (1.48851587 + t * (
                -0.82215223 + t * 0.17087277))))))))
    )
    return torch.where(x > 0.0, r, 2.0 - r)


def ncdf(x: torch.Tensor) -> torch.Tensor:
    """standard normal CDF via the erfcc approximation."""
    return 1.0 - 0.5 * erfcc(_tensor(x) / math.sqrt(2.0))


def npdf(x: torch.Tensor, mu: float = 0.0, vol: float = 1.0) -> torch.Tensor:
    """normal density with mean mu and standard deviation vol."""
    x = _tensor(x)
    return torch.exp(-0.5 * torch.square((x - mu) / vol)) / (vol * math.sqrt(2.0 * math.pi))


def norm_ppf(q: torch.Tensor) -> torch.Tensor:
    """inverse standard normal CDF, sqrt(2) erfinv(2q - 1) (exact, not the
    erfcc fit)."""
    return math.sqrt(2.0) * torch.erfinv(2.0 * _tensor(q) - 1.0)
