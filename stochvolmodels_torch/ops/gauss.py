"""
Normal distribution helpers on tensors.

The BSM layer evaluates the normal CDF through the Numerical Recipes rational
approximation to erfc (accuracy ~1.2e-7), as the JAX package and its
reference do: implied vols agree across packages only with the same
approximation.
"""
from __future__ import annotations

import math

import torch


# the rational fit's exponent: -z^2 + c0 + t (c1 + t (c2 + ... + t c9))
ERFCC_COEFFS = (-1.26551223, 1.00002368, 0.37409196, 0.09678418, -0.18628806,
                0.27886807, -1.13520398, 1.48851587, -0.82215223, 0.17087277)


def erfcc(x: torch.Tensor) -> torch.Tensor:
    """complementary error function by the Numerical Recipes rational fit."""
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
    return 1.0 - 0.5 * erfcc(x / math.sqrt(2.0))


def npdf(x: torch.Tensor, mu: float = 0.0, vol: float = 1.0) -> torch.Tensor:
    """normal density with mean mu and standard deviation vol."""
    return torch.exp(-0.5 * torch.square((x - mu) / vol)) / (vol * math.sqrt(2.0 * math.pi))


def norm_ppf(q: torch.Tensor) -> torch.Tensor:
    """inverse standard normal CDF, sqrt(2) erfinv(2q - 1) (exact, not the
    erfcc fit)."""
    return math.sqrt(2.0) * torch.erfinv(2.0 * q - 1.0)
