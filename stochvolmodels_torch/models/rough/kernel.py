"""
Markovian approximation of the fractional kernel t^(H-1/2)/Gamma(H+1/2) by a
sum of exponentials  K(t) ~ sum_i w_i exp(-x_i t).

Counterpart of ``stochvolmodels_tpu/models/rough/kernel.py``, ported as it is:
numpy and scipy on the host.  Given the N nodes, the weights that minimize
the L2 error on [DELTA, T] solve a linear least-squares problem with analytic
Gram integrals, so only the N log-nodes are optimized numerically; the result
is cached on (H, N, T).  ``european_rule`` is the production rule (nodes
capped for the simulation's stability); the other rules (unbounded L2, L1,
Abi Jaber-El Euch, Alfonsi-Kebaier, Gaussian, Harms), the error functionals,
the Mittag-Leffler function and the discrete-kernel helpers ``kernel_frac``
and ``kernel_rheston`` serve error studies and research schemes.
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


def optimized_l2_rule(H: float, N: int, T: float) -> Tuple[np.ndarray, np.ndarray]:
    """true unbounded L2 optimum (counterpart of the reference's OL2 path,
    ``optimize_error_l2`` with bound=1e100, RoughKernel.py:746-871): nodes
    unconstrained, weights the closed-form optimum — which may be NEGATIVE,
    so this rule is for error studies, not for the split simulation (use
    :func:`european_rule` there; its cap keeps the RK4 drift half-step
    stable).  Never weaker than european_rule on L2 error by construction."""
    # 1e8 is "unbounded" at float precision of the Gram integrals: e^{-x t}
    # underflows on [DELTA, T] long before the node hits the cap
    nodes, weights = _l2_node_search_cached(float(H), int(N), float(T),
                                            1e8, False)
    return np.asarray(nodes), np.asarray(weights)


def kernel_l2_relative_error(H: float, nodes: np.ndarray, weights: np.ndarray,
                             T: float) -> float:
    """relative L2 approximation error of the lift, for diagnostics."""
    A = kernel_gram(nodes, T)
    b = kernel_cross(nodes, H, T)
    c = kernel_self(H, T)
    err2 = max(c - 2.0 * weights @ b + weights @ A @ weights, 0.0)
    return float(np.sqrt(err2 / c))


# ----------------------------------------------------------------------------
# research quadrature rules (counterparts of the vendored alternatives in
# RoughKernel.py: AbiJaber-ElEuch :172, Alfonsi-Kebaier :134, Gaussian :311,
# dispatcher :1030).  The fractional kernel is the Laplace transform of the
# measure mu(dx) = x^{-H-1/2} dx / (Gamma(H+1/2) Gamma(1/2-H)); each rule is
# a different discretization of mu.  european_rule remains the production
# path (logsv_params.approximate_kernel); these are provided for parity and
# research comparisons.
# ----------------------------------------------------------------------------

def _mu_norm(H: float) -> float:
    """normalization of the kernel measure mu."""
    return 1.0 / (sp_gamma(H + 0.5) * sp_gamma(0.5 - H))


def _mu_moments(H: float, a: float, b: float) -> Tuple[float, float]:
    """(mass, first moment) of mu on [a, b]:
    int x^{-H-1/2} dx = (b^(1/2-H) - a^(1/2-H)) / (1/2-H),
    int x^(1/2-H) dx = (b^(3/2-H) - a^(3/2-H)) / (3/2-H)."""
    c = _mu_norm(H)
    p0, p1 = 0.5 - H, 1.5 - H
    mass = c * (b ** p0 - a ** p0) / p0
    mom1 = c * (b ** p1 - a ** p1) / p1
    return mass, mom1


def abi_jaber_el_euch_rule(H: float, N: int, T: float
                           ) -> Tuple[np.ndarray, np.ndarray]:
    """uniform-partition rule of Abi Jaber & El Euch (2019): split [0, eta_N]
    into N equal cells of width pi_N ~ N^(-1/5)/T and take the cell mass as
    weight, cell mean as node (one-point moment matching per cell)."""
    pi_n = N ** (-0.2) / T * (np.sqrt(10.0) * (1.0 - 2.0 * H) / (5.0 - 2.0 * H)) ** 0.4
    edges = pi_n * np.arange(N + 1)
    nodes = np.empty(N)
    weights = np.empty(N)
    for i in range(N):
        mass, mom1 = _mu_moments(H, edges[i], edges[i + 1])
        weights[i] = mass
        nodes[i] = mom1 / mass
    return nodes, weights


def ak_geometric_rule(H: float, N: int, T: float, K: float = None
                      ) -> Tuple[np.ndarray, np.ndarray]:
    """Alfonsi-Kebaier-style hybrid partition: uniform cells on [0, K], then
    a geometrically growing tail; per-cell one-point moment matching, with
    the tail growth factor and a global weight scale tuned against the L2
    error functional."""
    if N == 1:
        return european_rule(H, 1, T)
    n_half = max(N // 2, 1)
    if K is None:
        K = n_half ** 0.8

    def build(growth: float) -> Tuple[np.ndarray, np.ndarray]:
        edges = np.concatenate([np.linspace(0.0, K, n_half + 1),
                                K * growth ** np.arange(1, N - n_half + 1)])
        nodes = np.empty(N)
        weights = np.empty(N)
        for i in range(N):
            mass, mom1 = _mu_moments(H, edges[i], edges[i + 1])
            weights[i] = mass
            nodes[i] = mom1 / mass
        return nodes, weights

    def err(growth: float) -> float:
        nodes, weights = build(growth)
        return kernel_l2_relative_error(H, nodes, weights, T)

    res = minimize(lambda g: err(float(g[0])), x0=np.array([1.2]),
                   bounds=((1.01, 50.0),))
    nodes, weights = build(float(res.x[0]))
    scale = minimize(lambda s: kernel_l2_relative_error(H, nodes, s[0] * weights, T),
                     x0=np.array([1.0]), bounds=((0.0, None),))
    return nodes, float(scale.x[0]) * weights


def gaussian_rule(H: float, N: int, T: float, m: int = 1
                  ) -> Tuple[np.ndarray, np.ndarray]:
    """Gaussian quadrature of mu on a geometric partition (Bayer-Breneis
    style): level-m Gauss-Jacobi on the singular first cell [0, xi0], level-m
    Gauss-Legendre (against the smooth density) on each geometric cell up to
    xi_n; N = m * number_of_cells total nodes."""
    from scipy.special import roots_jacobi, roots_legendre

    n_cells = max(N // m, 1)
    alpha = H + 0.5
    c = _mu_norm(H)
    xi0 = 1.0 / T
    xi_max = min(MAX_NODE, xi0 * 10.0 ** (n_cells - 1) * 3.0)
    edges = np.concatenate([[0.0], np.geomspace(xi0, xi_max, n_cells)])
    nodes, weights = [], []
    for i in range(n_cells):
        a, b = edges[i], edges[i + 1]
        if a == 0.0:
            # x = b (1+t)/2: weight x^-alpha dx -> Jacobi(0, -alpha) on t
            t, w = roots_jacobi(m, 0.0, -alpha)
            x = b * (1.0 + t) / 2.0
            wq = c * w * (b / 2.0) ** (1.0 - alpha)
        else:
            t, w = roots_legendre(m)
            x = a + (b - a) * (1.0 + t) / 2.0
            wq = c * w * (b - a) / 2.0 * x ** (-alpha)
        nodes.append(x)
        weights.append(wq)
    return np.concatenate(nodes), np.concatenate(weights)


def harms_rule(H: float, N: int, T: float = 1.0, m: int = 1
               ) -> Tuple[np.ndarray, np.ndarray]:
    """Harms (2019) rule (counterpart of RoughKernel.py:1014): level-m Gauss
    quadrature of the kernel measure mu on an n-interval geometric partition
    whose endpoints scale as powers of n chosen from the paper's error
    exponents: with alpha = H + 1/2, beta = m - 1, gamma = 1/2 - H,
    delta = H and r = delta m / (1 - alpha - beta + delta + m), the
    partition spans [n^(-r/gamma), n^(r/delta)].  T does not enter the
    construction (the rule targets the whole half-line) — one reason the
    [0, T]-optimized ``european_rule`` dominates it at matched N on pricing
    horizons.  Total node count is ``m * (N // m)``.
    """
    from scipy.special import roots_legendre

    n = max(N // m, 1)
    alpha, beta_, gamma_, delta_ = H + 0.5, m - 1.0, 0.5 - H, H
    r = delta_ * m / (1.0 - alpha - beta_ + delta_ + m)
    xi_0 = float(n) ** (-r / gamma_)
    xi_n = float(n) ** (r / delta_)
    edges = xi_0 * np.exp(np.log(xi_n / xi_0) * np.linspace(0.0, 1.0, n + 1))
    c = _mu_norm(H)
    t, w = roots_legendre(m)
    nodes, weights = [], []
    for i in range(n):
        a, b = edges[i], edges[i + 1]
        x = a + (b - a) * (1.0 + t) / 2.0
        nodes.append(x)
        weights.append(c * w * (b - a) / 2.0 * x ** (-alpha))
    return np.concatenate(nodes), np.concatenate(weights)


def kernel_l1_relative_error(H: float, nodes: np.ndarray, weights: np.ndarray,
                             T: float, nb_pts: int = 4001) -> float:
    """relative L1 error  int_delta^T |K - K_hat| dt / int_delta^T K dt  by
    log-spaced trapezoid quadrature (no closed form exists; counterpart of
    the reference's numeric error_l1, RoughKernel.py:~700)."""
    t = np.geomspace(DELTA, T, nb_pts)
    k = t ** (H - 0.5) / sp_gamma(H + 0.5)
    k_hat = np.exp(-np.outer(t, nodes)) @ weights
    num = np.trapezoid(np.abs(k - k_hat), t)
    den = np.trapezoid(k, t)
    return float(num / den)


@lru_cache(maxsize=256)
def _l1_rule_cached(H: float, N: int, T: float
                    ) -> Tuple[Tuple[float, ...], Tuple[float, ...]]:
    # start from the L2 optimum and polish nodes AND weights against the
    # numeric L1 functional (2N free parameters; N <= 3 in production)
    nodes0, weights0 = european_rule(H, N, T)
    p0 = np.concatenate([np.log(nodes0), np.log(np.maximum(weights0, 1e-12))])
    log_cap = np.log(MAX_NODE)

    def objective(p: np.ndarray) -> float:
        nodes = np.exp(np.minimum(p[:N], log_cap))
        weights = np.exp(p[N:])
        return (kernel_l1_relative_error(H, nodes, weights, T)
                + np.sum(np.square(np.maximum(p[:N] - log_cap, 0.0))))

    res = minimize(objective, p0, method='Nelder-Mead',
                   options={'maxiter': 4000, 'xatol': 1e-9, 'fatol': 1e-12})
    nodes = np.exp(np.minimum(res.x[:N], log_cap))
    weights = np.exp(res.x[N:])
    order = np.argsort(nodes)
    return (tuple(nodes[order].tolist()), tuple(weights[order].tolist()))


def l1_rule(H: float, N: int, T: float) -> Tuple[np.ndarray, np.ndarray]:
    """L1-optimized rule (counterpart of the reference's optimize_error_l1
    path, RoughKernel.py:746/1060): minimizes the relative L1 kernel error
    on [DELTA, T] over nodes and weights jointly."""
    nodes, weights = _l1_rule_cached(float(H), int(N), float(T))
    return np.asarray(nodes), np.asarray(weights)


def quadrature_rule(H: float, N: int, T: float, mode: str = "european"
                    ) -> Tuple[np.ndarray, np.ndarray]:
    """dispatcher over the available rules (RoughKernel.py:1030)."""
    mode = mode.lower()
    if mode in ("european", "bl2"):
        # bounded L2: nodes capped for simulation stability, weights the
        # closed-form L2 optimum given nodes, clamped positive
        return european_rule(H, N, T)
    if mode in ("optimized l2", "ol2"):
        # unbounded L2 optimum (weights may be negative) — matches the
        # reference's OL2/BL2 distinction (RoughKernel.py:1056-1061)
        return optimized_l2_rule(H, N, T)
    if mode in ("optimized l1", "ol1"):
        return l1_rule(H, N, T)
    if mode in ("abi-jaber", "abi_jaber", "aje", "ae"):
        return abi_jaber_el_euch_rule(H, N, T)
    if mode in ("ak", "ak_improved", "alfonsi-kebaier", "alfonsi"):
        return ak_geometric_rule(H, N, T)
    if mode in ("gaussian", "gauss"):
        return gaussian_rule(H, N, T)
    if mode == "harms":
        return harms_rule(H, N, T)
    raise NotImplementedError(f"mode={mode}")


# ----------------------------------------------------------------------------
# discrete-kernel helper classes for HQE-style simulation schemes
# (counterparts of RoughKernel.py:1080 ``kernel_frac`` and :1121
# ``kernel_rheston``).  The reference's versions are vendored research code
# that is partly non-functional (``kernel_rheston._k`` references an
# undefined ``mittag_leffler``); these are working re-implementations with a
# real Mittag-Leffler evaluator.  Host-side numpy/scipy by design: they feed
# per-step kernel constants into a simulation setup, not the hot path.
# ----------------------------------------------------------------------------

def mittag_leffler(z, alpha: float, beta: float = 1.0):
    """E_{alpha,beta}(z) = sum_k z^k / Gamma(alpha k + beta), vectorized.

    The power series alternates catastrophically for negative z (terms grow
    to ~e^{|z|} before decaying), so it is summed in 50-digit arithmetic via
    mpmath for |z| <= 80; beyond that, for negative real z and
    0 < alpha < 2, the algebraic asymptotic expansion
    E ~ -sum_{k>=1} z^{-k} / Gamma(beta - alpha k) applies.  Host-side
    research code (rHeston kernel setup) — precision over speed.  Validated
    against E_{1,1} = exp and E_{1/2,1}(z) = e^{z^2} erfc(-z).
    """
    import mpmath

    z = np.asarray(z, dtype=float)
    scalar = z.ndim == 0
    z = np.atleast_1d(z)
    out = np.empty_like(z)
    small = np.abs(z) <= 80.0
    if np.any(small):
        # the alternating sum's peak term is ~exp(alpha |z|^(1/alpha)):
        # budget digits for it plus 40 for the answer
        zmax = float(np.max(np.abs(z[small])))
        dps = 40 + int(0.5 * alpha * zmax ** (1.0 / alpha)) if zmax > 0 else 40
        with mpmath.workdps(dps):
            for i in np.nonzero(small)[0]:
                zi = mpmath.mpf(float(z[i]))
                acc = mpmath.mpf(0)
                term_bound = mpmath.mpf(1)
                k = 0
                while True:
                    acc += zi ** k / mpmath.gamma(alpha * k + beta)
                    k += 1
                    term_bound = abs(zi) ** k / mpmath.gamma(alpha * k + beta)
                    if k > 8 and term_bound < mpmath.mpf(10) ** (-40):
                        break
                out[i] = float(acc)
    if np.any(~small):
        zl = z[~small]
        if np.any(zl > 0):
            raise NotImplementedError("mittag_leffler: large positive z")
        if not 0.0 < alpha < 2.0:
            raise NotImplementedError("asymptotic branch needs 0 < alpha < 2")
        acc = np.zeros_like(zl)
        for k in range(1, 30):
            g = sp_gamma(beta - alpha * k)  # inf at non-positive integers -> term 0
            with np.errstate(divide='ignore', over='ignore'):
                acc -= np.where(np.isfinite(g), zl ** (-k) / g, 0.0)
        out[~small] = acc
    return out[0] if scalar else out


class kernel_frac:
    """Riemann-Liouville kernel K(t) = eta_tilde t^{H-1/2} discrete
    convolution constants for HQE-type schemes (ref RoughKernel.py:1080):
    K_0(dt) = int_0^dt K and the diagonal  calK_jj = int_{j dt}^{(j+1) dt} K^2
    — both closed-form for a power kernel."""

    def __init__(self, H: float, eta: float):
        self.H = float(H)
        self.eta = float(eta)
        self.eta_tilde = np.sqrt(2.0 * H) * eta

    def K_0(self, Delta: float) -> float:
        return self.eta_tilde * Delta ** (self.H + 0.5) / (self.H + 0.5)

    def K_diag(self, Delta: float, N: int) -> np.ndarray:
        i = np.arange(N + 1, dtype=float)
        return self.eta ** 2 * Delta ** (2.0 * self.H) * (
            i[1:] ** (2.0 * self.H) - i[:-1] ** (2.0 * self.H))


class kernel_rheston:
    """rough-Heston resolvent kernel k(r) = zeta r^{a-1} E_{a,a}(-lam r^a),
    a = H + 1/2, as a forward-variance-model kernel (ref RoughKernel.py:1121,
    there non-functional).  K_0/K_diag by adaptive quadrature; ``xi`` builds
    the forward-variance curve xi_t = v0 + lam (theta - v0) int_0^t k/zeta."""

    def __init__(self, H: float, lam: float, zeta: float, eps: float = 1e-3):
        self.alpha = float(H) + 0.5
        self.H = float(H)
        self.lam = float(lam)
        self.zeta = float(zeta)
        self.eps = float(eps)

    def _k(self, r):
        r = np.asarray(r, dtype=float)
        return (self.zeta * r ** (self.alpha - 1.0)
                * mittag_leffler(-self.lam * r ** self.alpha,
                                 self.alpha, self.alpha))

    def K_0(self, Delta: float) -> float:
        from scipy.integrate import quad
        return quad(lambda r: float(self._k(r)), 0.0, Delta,
                    epsabs=self.eps, epsrel=self.eps)[0]

    def K_diag(self, Delta: float, N: int) -> np.ndarray:
        from scipy.integrate import quad
        return np.array([quad(lambda r: float(self._k(r + i * Delta)) ** 2,
                              0.0, Delta, epsabs=self.eps, epsrel=self.eps)[0]
                         for i in range(N)])

    def xi(self, t_grid, v0: float, lam: float, theta: float,
           eps: float = 1e-6) -> np.ndarray:
        from scipy.integrate import quad
        t_grid = np.asarray(t_grid, dtype=float)
        if np.isclose(v0, theta, rtol=eps):
            return np.full_like(t_grid, v0)
        t = np.unique(np.append(0.0, t_grid))
        int_k = np.array([quad(lambda r: float(self._k(r)), t[i], t[i + 1],
                               epsabs=eps, epsrel=eps)[0]
                          for i in range(len(t) - 1)])
        cum = np.concatenate([[0.0], np.cumsum(int_k)])  # at every t incl. 0
        xi_at = v0 + self.lam * (theta - v0) * cum / self.zeta
        return np.interp(t_grid, t, xi_at)
