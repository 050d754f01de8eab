"""
Markovian approximation of the fractional kernel t^(H-1/2)/Gamma(H+1/2) by a
sum of exponentials  K(t) ~ sum_i w_i exp(-x_i t).

Counterpart of ``stochvolmodels_tpu/models/rough/kernel.py`` for the rule the
rough Monte Carlo uses (``european_rule``), ported as it is: numpy and scipy
on the host.  Given the N nodes, the weights that minimize the L2 error on
[DELTA, T] solve a linear least-squares problem with analytic Gram
integrals, so only the N log-nodes are optimized numerically; the result is
cached on (H, N, T).  The other quadrature rules are not ported yet.
"""
from __future__ import annotations

from functools import lru_cache
from typing import Tuple

import numpy as np
from scipy.optimize import minimize
from scipy.special import gamma as sp_gamma
from scipy.special import gammainc


# lower integration cutoff: behavior below the simulation time step cannot be
# resolved, and for small H the t -> 0 singularity would otherwise dominate
# the objective; ~1/3 of a daily step
DELTA = 1e-3
# node cap: the RK4 drift half-step is stable for node * h/2 < ~2.8, i.e.
# node < ~2000 at 360 steps/yr; cap well inside that
MAX_NODE = 500.0


def kernel_gram(nodes: np.ndarray, T: float, delta: float = DELTA) -> np.ndarray:
    """A_ij = int_delta^T e^{-(x_i + x_j) t} dt."""
    s = nodes[:, None] + nodes[None, :]
    return (np.exp(-s * delta) - np.exp(-s * T)) / s


def kernel_cross(nodes: np.ndarray, H: float, T: float,
                 delta: float = DELTA) -> np.ndarray:
    """b_i = int_delta^T t^{H-1/2} e^{-x_i t} dt / Gamma(H+1/2)
    = x_i^{-(H+1/2)} [P(a, x_i T) - P(a, x_i delta)], P regularized lower gamma."""
    a = H + 0.5
    return np.power(nodes, -a) * (gammainc(a, nodes * T) - gammainc(a, nodes * delta))


def kernel_self(H: float, T: float, delta: float = DELTA) -> float:
    """c = int_delta^T K(t)^2 dt = (T^{2H} - delta^{2H}) / (2H Gamma(H+1/2)^2)."""
    return (T ** (2.0 * H) - delta ** (2.0 * H)) / (2.0 * H * sp_gamma(H + 0.5) ** 2)


def l2_error_and_weights(nodes: np.ndarray, H: float, T: float
                         ) -> Tuple[float, np.ndarray]:
    """optimal weights for given nodes and the resulting squared L2 error."""
    A = kernel_gram(nodes, T)
    b = kernel_cross(nodes, H, T)
    w = np.linalg.solve(A, b)
    err2 = kernel_self(H, T) - b @ w
    return float(max(err2, 0.0)), w


@lru_cache(maxsize=256)
def _l2_node_search_cached(H: float, N: int, T: float, max_node: float,
                           require_pos_weights: bool
                           ) -> Tuple[Tuple[float, ...], Tuple[float, ...]]:
    """Nelder-Mead over the N log-nodes with the closed-form optimal weights
    (the numeric problem is N-dimensional, not 2N).  ``max_node`` caps the
    fastest node; ``require_pos_weights`` penalizes negative weights (the
    split simulation needs w_i > 0; the reference's unbounded OL2 optimum
    does not)."""
    # geometric initial nodes spanning [1/T, fast] decades
    x0 = np.geomspace(0.5 / T, min(20.0 ** (N - 1) / T, 0.5 * max_node)
                      if N > 1 else 5.0 / T, N)
    log_cap = np.log(max_node)

    def objective(log_nodes: np.ndarray) -> float:
        nodes = np.exp(np.minimum(log_nodes, log_cap))
        try:
            err2, w = l2_error_and_weights(nodes, H, T)
        except np.linalg.LinAlgError:
            return 1e10
        # penalize capped nodes (keeps the optimizer inside the stable region)
        penalty = np.sum(np.square(np.maximum(log_nodes - log_cap, 0.0)))
        if require_pos_weights:
            penalty += np.sum(np.square(np.minimum(w, 0.0)))
        return err2 + 1e3 * penalty

    best = None
    for scale in (0.5, 1.0, 2.0):
        res = minimize(objective, np.log(x0 * scale), method='Nelder-Mead',
                       options={'maxiter': 2000, 'xatol': 1e-10, 'fatol': 1e-14})
        if best is None or res.fun < best.fun:
            best = res
    nodes = np.exp(np.minimum(best.x, log_cap))
    _, weights = l2_error_and_weights(nodes, H, T)
    order = np.argsort(nodes)
    nodes, weights = nodes[order], weights[order]
    if require_pos_weights:
        weights = np.maximum(weights, 1e-12)
    return tuple(nodes.tolist()), tuple(weights.tolist())


def _european_rule_cached(H: float, N: int, T: float
                          ) -> Tuple[Tuple[float, ...], Tuple[float, ...]]:
    return _l2_node_search_cached(H, N, T, MAX_NODE, True)


def european_rule(H: float, N: int, T: float) -> Tuple[np.ndarray, np.ndarray]:
    """(nodes, weights) of the N-point Markovian lift of the fractional kernel
    over [DELTA, T] with nodes capped for simulation stability
    (the JAX package's ``european_rule``)."""
    nodes, weights = _european_rule_cached(float(H), int(N), float(T))
    return np.asarray(nodes), np.asarray(weights)
