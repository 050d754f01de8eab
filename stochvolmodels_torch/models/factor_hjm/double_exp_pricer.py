"""
Double-exponential (tanh-sinh) series pricer for swaptions and rate futures.

PyTorch port's copy of ``stochvolmodels_tpu/models/factor_hjm/double_exp_pricer.py``
(host numpy).  The adaptive refinement loop is data-dependent host logic;
each level's node batch is evaluated by one call of ``ff`` (which wraps the
batched MGF solve, one captured CUDA graph per padded batch on a card), so
the device work stays batched while the truncation and refinement decisions
run on the host.
"""
from __future__ import annotations

from typing import Callable, Tuple, Union

import numpy as np


def tanh_sinh_nodes(h: float = 0.125, x_max: float = 2.75
                    ) -> Tuple[np.ndarray, np.ndarray]:
    """fixed tanh-sinh node/weight panel for integrals over p in (0, inf).

    int_0^inf f(p) dp ~= sum_k w_k f(p_k) with p_k = exp(pi/2 sinh(k h)),
    w_k = h pi/2 cosh(k h) p_k, |k h| <= x_max.  The static panel replaces
    the adaptive refinement loop of ``de_pricer`` on the differentiable
    pricing path: one fixed shape, one captured program, differentiable.  Defaults cover p in [4.5e-6, 2.2e5], enough for swaption
    inversion integrands at expiries >= ~0.25y (the double-exponential decay
    makes the truncation error negligible next to the expansion error).
    """
    k_max = int(np.floor(x_max / h + 1e-9))
    x = h * np.arange(-k_max, k_max + 1)
    half_pi = 0.5 * np.pi
    p = np.exp(half_pi * np.sinh(x))
    w = h * half_pi * np.cosh(x) * p
    return p, w


def _call_padded(ff: Callable, x_k: np.ndarray) -> np.ndarray:
    """evaluate ff on a power-of-two-padded node batch.

    The refinement loop produces batches of many different lengths
    (1, n1, n2, 2*n1, ...); each distinct length would capture another
    CUDA graph of the batched MGF solve behind ``ff``.  Padding to the next
    power of two (repeating the last node) bounds the graph count at
    log2(max batch), and the duplicate rows are sliced off after.
    """
    n = x_k.shape[0]
    m = 1 << max(n - 1, 0).bit_length()
    if m != n:
        x_k = np.concatenate([x_k, np.full(m - n, x_k[-1])])
    out = np.asarray(ff(x_k))
    return out[:n]


def func(ff: Callable, x: Union[float, np.ndarray]) -> np.ndarray:
    """weighted integrand terms w_k f(x_k) of the tanh-sinh scheme
    (double_exp_pricer.py:75-88)."""
    if isinstance(x, float):
        x = np.array([x])
    half_pi = 0.5 * np.pi
    exp_x = np.exp(x)
    sinh_x = 0.5 * (exp_x - 1.0 / exp_x)
    cosh_x = 0.5 * (exp_x + 1.0 / exp_x)
    exp_sinh_x = np.exp(half_pi * sinh_x)
    w_k = half_pi * cosh_x * exp_sinh_x
    x_k = exp_sinh_x
    return (_call_padded(ff, x_k).T * w_k).T


def part_sum(ff: Callable, h2: float, delta: int, N: int) -> np.ndarray:
    """partial sum of the series up to the truncation index."""
    func_vals = func(ff, h2 + np.arange(0.0, N, 1.0) * delta * h2)
    return np.sum(func_vals, axis=0)


def trunc_index(ff: Callable, h2: float, delta: int, s: np.ndarray,
                Nmax: float, eps0: float) -> Tuple[int, np.ndarray]:
    """smallest index at which the series term falls below tolerance."""
    x = h2
    k = 1
    for k in np.arange(1.0, Nmax):
        xi = func(ff, x)
        s = s + xi
        if np.all(np.linalg.norm(xi, axis=0) <= eps0 * np.linalg.norm(s, axis=0)):
            break
        x = x + delta * h2
    return int(k), s


def de_pricer(ff: Callable, ff_transf: Callable
              ) -> Tuple[np.ndarray, np.ndarray]:
    """adaptive tanh-sinh valuation, refining until the implied vols converge
    (double_exp_pricer.py:20-72, <= 7 refinement levels)."""
    eps0 = 1e-6
    h = 0.5
    eps = 1e-6
    Nmax = 12.0
    maxlev = 7

    s = func(ff, 0.0)
    n1, s = trunc_index(ff, h2=h, delta=1, s=s, Nmax=Nmax, eps0=eps0)
    n2, s = trunc_index(ff, h2=-h, delta=1, s=s, Nmax=Nmax, eps0=eps0)
    model_prices_prev = h * s
    model_ivs_prev = ff_transf(model_prices_prev)[1]
    m = 0
    err_ivol = 1.0
    model_prices = model_prices_prev
    model_ivs = model_ivs_prev
    for m in np.arange(1.0, maxlev):
        h = h / 2.0
        s1 = part_sum(ff, h2=h, delta=2, N=n1)
        s2 = part_sum(ff, h2=-h, delta=2, N=n2)
        model_prices = 0.5 * model_prices_prev + h * (s1 + s2)
        model_ivs = ff_transf(model_prices)[1]
        err_ivol = np.linalg.norm(np.nan_to_num(np.asarray(model_ivs)
                                                - np.asarray(model_ivs_prev)))
        rel_diff = (np.linalg.norm(model_prices - model_prices_prev)
                    <= eps * np.linalg.norm(model_prices))
        if rel_diff or err_ivol <= 1e-6:
            break
        model_prices_prev = model_prices
        model_ivs_prev = model_ivs
        n1 = 2 * n1
        n2 = 2 * n2
    model_prices = ff_transf(model_prices)[0]
    return model_prices, model_ivs
