"""
Affine expansion of the MGF for the factor HJM model with a LogSV driver
(Sec. 6, Theorem 6.1 of Sepp & Rakhmonov 2025).

PyTorch counterpart of the float64 half of
``stochvolmodels_tpu/models/factor_hjm/rate_affine_expansion.py``.  The ODE
coefficients are time-dependent (piecewise term structures measured under
Q^A or Q^T), but enter only through seven scalar time series: kappa0/1/2(t),
vartheta^2(t), a.beta(t), a.a(t) and b(t).  Those are interpolated linearly
onto the RK4 stage times, and one fixed-step RK4 advances every transform
point (and, in the batch solver, every slice) together as a complex128
(..., N, n) panel.  The stage times are fixed per slice, so the interpolation
brackets and weights are computed once on the host (:func:`stage_brackets`)
and the interpolation stays linear in the series, so that forward- and
reverse-mode AD go through it.

On a CUDA device the RK4 runs as one captured graph per (slices, batch,
steps, expansion order) (``ops/graphs.py``, name ``"rates_ode"``), with the
stage coefficients, the step sizes and the ODE templates as graph inputs.
The double-float32 solver of the JAX package exists only for the TPU and
has no counterpart here.
"""
from __future__ import annotations

from enum import Enum
from typing import Optional, Sequence, Tuple

import numpy as np
import torch

from stochvolmodels_torch.models.logsv.affine import ExpansionOrder, get_expansion_n
from stochvolmodels_torch.ops import graphs
from stochvolmodels_torch.ops.bsm import _f64

# the sticky divergence freeze: a lane whose |Re A| or |Im A| reaches CLAMP,
# or turns non-finite, is frozen at A = (DEAD_RE, 0, ...), so its integrand
# term is exactly 0
CLAMP = 1.0e3
DEAD_RE = -1.0e4


class UnderlyingType(Enum):
    """swap rate (swaptions) or log-shifted futures rate (rate futures)."""
    SWAP = 1
    FUTURES = 2


def _scalar_series(times: np.ndarray,
                   a0, a1, kappa0, kappa1, kappa2, beta, volvol, b,
                   underlying_type: UnderlyingType,
                   device="cuda") -> torch.Tensor:
    """reduce the vector coefficient series to the seven scalar series
    [kappa0, kappa1, kappa2, vartheta2, a_prod_beta, a_prod_a, b], a
    (..., 7, T) float64 tensor (``times`` is kept for the JAX package's
    signature).

    The inputs are numpy arrays, which go to ``device``, or float64 tensors,
    which keep their tangents (the cube greeks differentiate through the
    reduction) and may carry leading batch axes: a0 and beta (..., T, d),
    the rest (..., T) or scalars.
    """
    a0, a1, beta, volvol = (_f64(x, device) for x in (a0, a1, beta, volvol))
    a0 = a0[:, None] if a0.ndim == 1 else a0                     # (T, d)
    beta = beta[:, None] if beta.ndim == 1 else beta
    vartheta2 = torch.einsum('...td,...td->...t', beta, beta) + volvol ** 2
    a_prod_beta = torch.einsum('...td,...td->...t', a0, beta)
    a_prod_a = torch.einsum('...td,...td->...t', a0, a0)
    if underlying_type == UnderlyingType.FUTURES:
        a_prod_beta = a_prod_beta + a1 * volvol
        a_prod_a = a_prod_a + a1 ** 2
    full = lambda x: torch.broadcast_to(_f64(x, device), vartheta2.shape)
    return torch.stack([full(kappa0), full(kappa1), full(kappa2), vartheta2, a_prod_beta,
                        a_prod_a, full(b)], dim=-2)                # (..., 7, T)


def stage_brackets(t_eval: np.ndarray, times: np.ndarray
                   ) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
    """``jnp.interp(t_eval, times, series)`` as host-made brackets and
    weights (lo, hi, r), for :func:`interp_series`.

    ``f = s[lo] + r (s[hi] - s[lo])``, with ``lo = i - 1``, ``hi = i`` and
    ``r = (x - xp[i-1]) / (xp[i] - xp[i-1])`` for ``i = clip(searchsorted(xp,
    x, 'right'), 1, T - 1)``, as ``jnp.interp`` computes it; below the first
    knot ``lo = hi = 0`` and above the last ``lo = hi = T - 1`` with ``r = 0``
    (the end values exactly), as are knots closer than the f64 spacing of
    eps.  The map is linear in the series.
    """
    x = np.asarray(t_eval, dtype=float).ravel()
    xp = np.asarray(times, dtype=float)
    i = np.clip(np.searchsorted(xp, x, side='right'), 1, xp.size - 1)
    dx = xp[i] - xp[i - 1]
    delta = x - xp[i - 1]
    dx0 = np.abs(dx) <= np.spacing(np.finfo(np.float64).eps)
    r = np.where(dx0, 0.0, delta / np.where(dx0, 1.0, dx))
    lo, hi = i - 1, np.where(dx0, i - 1, i)
    below, above = x < xp[0], x > xp[-1]
    lo = np.where(below, 0, np.where(above, xp.size - 1, lo))
    hi = np.where(below, 0, np.where(above, xp.size - 1, hi))
    return lo, hi, np.where(below | above, 0.0, r)


def interp_series(series: torch.Tensor, lo: torch.Tensor, hi: torch.Tensor,
                  r: torch.Tensor) -> torch.Tensor:
    """the (..., C, T) series at the stage times of (lo, hi, r) (each (..., X)):
    (..., C, X), ``s[lo] + r (s[hi] - s[lo])``."""
    take = lambda idx: torch.gather(
        series, -1, idx.unsqueeze(-2).expand(*series.shape[:-1], idx.shape[-1]))
    s_lo = take(lo)
    return s_lo + r.unsqueeze(-2) * (take(hi) - s_lo)


def stage_times(ttm: float, nb_steps: int) -> Tuple[np.ndarray, float]:
    """(calendar times t = ttm - tau of the RK4 stages (S, 3), dt): stages at
    tau_k, tau_k + dt/2 and tau_k + dt of each of ``nb_steps`` steps."""
    dt = float(ttm) / nb_steps
    tau0 = np.arange(nb_steps) * dt
    stage_taus = np.stack([tau0, tau0 + 0.5 * dt, tau0 + dt], axis=1)
    return float(ttm) - stage_taus, dt


def step_multipliers(dts: Sequence[float]) -> np.ndarray:
    """(P, 3) host float64 [dt/2, dt, dt/6] per slice: the RK4's scalars,
    computed in float64 on the host as the JAX package's Python floats are."""
    return np.array([[0.5 * dt, dt, dt / 6.0] for dt in np.asarray(dts, dtype=float).ravel()])


def _rates_ode_terms(q: float, coeffs: torch.Tensor, phi: torch.Tensor, n: int
                     ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """(M, L, H) panels from the scalar coefficients at one stage time, by
    the JAX package's scatters: M (n,n,n) real, L = L0 + phi L1 (N,n,n) and
    H (N,n) complex128.  coeffs = [kappa0, kappa1, kappa2, vartheta2,
    a_prod_beta, a_prod_a, b]."""
    kappa0, kappa1, kappa2, vartheta2, apb, apa, b = (coeffs[i] for i in range(7))
    q2 = q * q
    qv = q * vartheta2
    qv2 = q2 * vartheta2
    M = coeffs.new_zeros((n, n, n))
    M[0, 1, 1] = 0.5 * qv2
    M[1, 1, 1] = qv
    M[1, 1, 2] = M[1, 2, 1] = qv2
    M[2, 1, 1] = 0.5 * vartheta2
    M[2, 2, 2] = 2.0 * qv2
    M[2, 2, 1] = M[2, 1, 2] = 2.0 * qv
    if n == 5:
        M[2, 1, 3] = M[2, 3, 1] = 1.5 * qv2
        M[3, 2, 2] = 4.0 * qv
        M[3, 1, 2] = M[3, 2, 1] = vartheta2
        M[3, 1, 3] = M[3, 3, 1] = 3.0 * qv
        M[3, 1, 4] = M[3, 4, 1] = 2.0 * qv2
        M[3, 2, 3] = M[3, 3, 2] = 3.0 * qv2
        M[4, 2, 2] = 2.0 * vartheta2
        M[4, 3, 3] = 4.5 * qv2
        M[4, 1, 3] = M[4, 3, 1] = 1.5 * vartheta2
        M[4, 1, 4] = M[4, 4, 1] = 4.0 * qv
        M[4, 2, 3] = M[4, 3, 2] = 6.0 * qv
        M[4, 2, 4] = M[4, 4, 2] = 4.0 * qv2
    L0 = coeffs.new_zeros((n, n))
    L1 = coeffs.new_zeros((n, n))
    L0[0, 1], L0[0, 2] = kappa0, qv2
    L1[0, 1] = -q2 * apb
    L0[1, 1], L0[1, 2] = -kappa1, 2.0 * (kappa0 + qv)
    L1[1, 1], L1[1, 2] = -2.0 * q * apb, -2.0 * q2 * apb
    L0[2, 1], L0[2, 2] = -kappa2, vartheta2 - 2.0 * kappa1
    L1[2, 1], L1[2, 2] = -apb, -4.0 * q * apb
    if n == 5:
        L0[1, 3] = 3.0 * qv2
        L0[2, 3], L0[2, 4] = 3.0 * (kappa0 + 2.0 * qv), 6.0 * qv2
        L1[2, 3] = -3.0 * q2 * apb
        L0[3, 2], L0[3, 3] = -2.0 * kappa2, 3.0 * (vartheta2 - kappa1)
        L0[3, 4] = 4.0 * (3.0 * qv + kappa0)
        L1[3, 2], L1[3, 3] = -2.0 * apb, -6.0 * q * apb
        L1[3, 4] = -4.0 * q2 * apb
        L0[4, 3], L0[4, 4] = -3.0 * kappa2, 2.0 * (3.0 * vartheta2 - 2.0 * kappa1)
        L1[4, 3], L1[4, 4] = -3.0 * apb, -8.0 * q * apb
    L = torch.complex(L0[None] + phi.real[:, None, None] * L1[None],
                      phi.imag[:, None, None] * L1[None])
    # H[k] = h_k(q) * phi * (2 b + a.a phi), h = [q^2/2, q, 1/2, 0, 0]
    h = coeffs.new_zeros(n)
    h[0], h[1], h[2] = 0.5 * q2, q, 0.5
    hphi = phi * (phi * apa + 2.0 * b)
    return M, L, h.to(torch.complex128)[None, :] * hphi[:, None]


def _ode_rhs(A: torch.Tensor, M: torch.Tensor, L: torch.Tensor, H: torch.Tensor
             ) -> torch.Tensor:
    """dA/dtau = A' M A + L A + H over the (N, n) complex panel."""
    quad = torch.einsum('kij,ni,nj->nk', M.to(torch.complex128), A, A)
    return quad + torch.matmul(L, A[:, :, None])[..., 0] + H


def _rates_ode_templates(q: float, n: int) -> Tuple[np.ndarray, ...]:
    """static structure tensors (TM, K0, K1, K2, V, P, h) of the (M, L, H)
    panels: M = vartheta2 TM(q), L0 = kappa0 K0 + kappa1 K1 + kappa2 K2 +
    vartheta2 V(q), L1 = a_prod_beta P(q), H = h(q) phi (phi a.a + 2 b).
    Host float64 arrays."""
    q2 = q * q
    TM = np.zeros((n, n, n))
    TM[0, 1, 1] = 0.5 * q2
    TM[1, 1, 1] = q
    TM[1, 1, 2] = TM[1, 2, 1] = q2
    TM[2, 1, 1] = 0.5
    TM[2, 2, 2] = 2.0 * q2
    TM[2, 2, 1] = TM[2, 1, 2] = 2.0 * q
    K0 = np.zeros((n, n)); K1 = np.zeros((n, n)); K2 = np.zeros((n, n))
    V = np.zeros((n, n)); P = np.zeros((n, n))
    K0[0, 1] = 1.0
    V[0, 2] = q2
    K1[1, 1] = -1.0
    K0[1, 2] = 2.0; V[1, 2] = 2.0 * q
    K2[2, 1] = -1.0
    V[2, 2] = 1.0; K1[2, 2] = -2.0
    P[0, 1] = -q2
    P[1, 1] = -2.0 * q; P[1, 2] = -2.0 * q2
    P[2, 1] = -1.0; P[2, 2] = -4.0 * q
    if n == 5:
        TM[2, 1, 3] = TM[2, 3, 1] = 1.5 * q2
        TM[3, 2, 2] = 4.0 * q
        TM[3, 1, 2] = TM[3, 2, 1] = 1.0
        TM[3, 1, 3] = TM[3, 3, 1] = 3.0 * q
        TM[3, 1, 4] = TM[3, 4, 1] = 2.0 * q2
        TM[3, 2, 3] = TM[3, 3, 2] = 3.0 * q2
        TM[4, 2, 2] = 2.0
        TM[4, 3, 3] = 4.5 * q2
        TM[4, 1, 3] = TM[4, 3, 1] = 1.5
        TM[4, 1, 4] = TM[4, 4, 1] = 4.0 * q
        TM[4, 2, 3] = TM[4, 3, 2] = 6.0 * q
        TM[4, 2, 4] = TM[4, 4, 2] = 4.0 * q2
        V[1, 3] = 3.0 * q2
        K0[2, 3] = 3.0; V[2, 3] = 6.0 * q
        V[2, 4] = 6.0 * q2
        K2[3, 2] = -2.0
        V[3, 3] = 3.0; K1[3, 3] = -3.0
        V[3, 4] = 12.0 * q; K0[3, 4] = 4.0
        K2[4, 3] = -3.0
        V[4, 4] = 6.0; K1[4, 4] = -4.0
        P[2, 3] = -3.0 * q2
        P[3, 2] = -2.0; P[3, 3] = -6.0 * q; P[3, 4] = -4.0 * q2
        P[4, 3] = -3.0; P[4, 4] = -8.0 * q
    h = np.zeros(n)
    h[0] = 0.5 * q2; h[1] = q; h[2] = 0.5
    return TM, K0, K1, K2, V, P, h


def templates_on(q: float, n: int, device) -> Tuple[torch.Tensor, ...]:
    """:func:`_rates_ode_templates` as float64 tensors on ``device``."""
    return tuple(torch.as_tensor(t, device=device) for t in _rates_ode_templates(q, n))


def _stage_terms(phi: torch.Tensor, c: torch.Tensor, templates
                 ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """the RK4 stage operators from the stage scalars ``c`` (..., 7):
    (TMv (..., n*n, n), L (..., N, n, n), H (..., N, n)), complex128, so that
    ``rhs(A) = outer(A) @ TMv + L @ A + H``."""
    TM, K0, K1, K2, V, P, h = templates
    n = h.shape[0]
    s = lambda i: c[..., i, None, None]
    L0 = s(0) * K0 + s(1) * K1 + s(2) * K2 + s(3) * V                # (..., n, n)
    L1 = s(4) * P
    L = torch.complex(L0.unsqueeze(-3) + phi.real[:, None, None] * L1.unsqueeze(-3),
                      phi.imag[:, None, None] * L1.unsqueeze(-3))   # (..., N, n, n)
    TMv = (s(3) * TM.reshape(n, n * n).T).to(torch.complex128)     # (..., n*n, n)
    hphi = phi * (phi * c[..., 5, None] + 2.0 * c[..., 6, None])   # (..., N)
    return TMv, L, h.to(torch.complex128) * hphi[..., None]


def _rhs(A: torch.Tensor, TMv: torch.Tensor, L: torch.Tensor, H: torch.Tensor) -> torch.Tensor:
    outer = (A[..., :, None] * A[..., None, :]).flatten(-2)          # (..., N, n*n)
    # L A as a product and a sum over the last axis: a batched matmul of
    # (n, n) by (n, 1) blocks copies both operands first
    return outer @ TMv + (L * A[..., None, :]).sum(-1) + H


def _ode_rhs_from_templates(A: torch.Tensor, phi: torch.Tensor, c: torch.Tensor,
                            templates) -> torch.Tensor:
    """rhs of one RK4 stage directly from the 7 stage scalars ``c`` and the
    templates — mathematically ``_ode_rhs(A, *_rates_ode_terms(q, c, phi, n))``
    (tested); ``A`` (..., N, n), ``c`` (..., 7)."""
    return _rhs(A, *_stage_terms(phi, c, templates))


def _freeze(A1: torch.Tensor, dead: torch.Tensor, dead_row: torch.Tensor
            ) -> Tuple[torch.Tensor, torch.Tensor]:
    """the JAX package's sticky divergence freeze, in its order: clamp, test
    (|A| at the clamp, or not finite), then replace the dead lanes.  The test
    is ``not (|re| < CLAMP and |im| < CLAMP)``: true at the clamp and beyond,
    at +-inf and at NaN, as JAX's ``|x| >= CLAMP or not isfinite(x)``."""
    re = torch.clamp(A1.real, -CLAMP, CLAMP)
    im = torch.clamp(A1.imag, -CLAMP, CLAMP)
    live = (torch.abs(A1.real) < CLAMP) & (torch.abs(A1.imag) < CLAMP)
    dead = dead | ~torch.all(live, dim=-1)
    re = torch.where(dead[..., None], dead_row, re)
    im = torch.where(dead[..., None], torch.zeros_like(im), im)
    return torch.complex(re, im), dead


def rk4_batch(phi: torch.Tensor, steps: torch.Tensor, stage_coeffs: torch.Tensor,
              a_t0: torch.Tensor, TM: torch.Tensor, K0: torch.Tensor, K1: torch.Tensor,
              K2: torch.Tensor, V: torch.Tensor, P: torch.Tensor, h: torch.Tensor
              ) -> Tuple[torch.Tensor, torch.Tensor]:
    """the batched RK4 with the divergence freeze, eagerly: (A (P, N, n)
    complex128, dead (P, N)).

    ``steps`` (P, 3) holds [dt/2, dt, dt/6] per slice, ``stage_coeffs`` (P,
    S, 7, 3) the seven scalars at each step's three stage times, ``a_t0``
    (P, N, n) the start.  The stage operators of all S steps are assembled
    before the loop (a handful of batched kernels), so a step is matmuls and
    elementwise kernels only.
    """
    templates = (TM, K0, K1, K2, V, P, h)
    n = h.shape[0]
    c = stage_coeffs.permute(1, 3, 0, 2)                            # (S, 3, P, 7)
    TMv, L, H = _stage_terms(phi, c, templates)
    half, full, sixth = (steps[:, i, None, None] for i in range(3))
    dead_row = torch.cat([h.new_full((1,), DEAD_RE), h.new_zeros(n - 1)])
    A = a_t0
    dead = torch.zeros(A.shape[:-1], dtype=torch.bool, device=A.device)
    for s in range(c.shape[0]):
        k1 = _rhs(A, TMv[s, 0], L[s, 0], H[s, 0])
        k2 = _rhs(A + k1 * half, TMv[s, 1], L[s, 1], H[s, 1])
        k3 = _rhs(A + k2 * half, TMv[s, 1], L[s, 1], H[s, 1])
        k4 = _rhs(A + k3 * full, TMv[s, 2], L[s, 2], H[s, 2])
        A1 = A + (k1 + k2 * 2.0 + k3 * 2.0 + k4) * sixth
        A, dead = _freeze(A1, dead, dead_row)
    return A, dead


def _solve_batch(phi: torch.Tensor, steps: torch.Tensor, stage_coeffs: torch.Tensor,
                 q: float, n: int, a_t0: Optional[torch.Tensor] = None
                 ) -> Tuple[torch.Tensor, torch.Tensor]:
    """:func:`rk4_batch` through its captured graph on a CUDA device."""
    device = phi.device
    P, S = stage_coeffs.shape[:2]
    if a_t0 is None:
        a_t0 = torch.zeros((P, phi.shape[0], n), dtype=torch.complex128, device=device)
    inputs = (phi, steps, stage_coeffs, a_t0) + templates_on(q, n, device)
    if not graphs.use_graph(phi):
        return rk4_batch(*inputs)
    key = (P, phi.shape[0], S, n, str(device))
    return graphs.run_captured("rates_ode", key, rk4_batch, inputs)


def solve_a_ode_grid(phi_grid: torch.Tensor,
                     ttm: float,
                     q: float,
                     times: np.ndarray,
                     a0, a1, kappa0, kappa1, kappa2, beta, volvol,
                     b=None,
                     a_t0: Optional[torch.Tensor] = None,
                     expansion_order: ExpansionOrder = ExpansionOrder.FIRST,
                     underlying_type: UnderlyingType = UnderlyingType.SWAP,
                     year_steps: int = 360,
                     engine: str = "f64") -> torch.Tensor:
    """batched RK4 for the time-dependent Riccati system over the phi grid:
    A(ttm), an (N, n) complex128 tensor on ``phi_grid``'s device.

    ``nb_steps = max(ceil(year_steps * ttm), 16)``; the coefficient series
    are interpolated linearly onto the stage times.  ``engine`` is accepted
    for the JAX package's signature: every engine runs float64/complex128.
    Lanes that diverge are frozen (see ``rk4_batch``).
    """
    del engine
    n = get_expansion_n(expansion_order)
    device = phi_grid.device
    if b is None:
        b = np.zeros_like(np.asarray(times, dtype=float))
    series = _scalar_series(times, a0, a1, kappa0, kappa1, kappa2, beta, volvol, b,
                            underlying_type, device=device)          # (7, T)
    nb_steps = max(int(np.ceil(year_steps * float(ttm))), 16)
    t_eval, dt = stage_times(ttm, nb_steps)
    lo, hi, r = (torch.as_tensor(a, device=device) for a in stage_brackets(t_eval, times))
    coeffs = interp_series(series, lo, hi, r)
    coeffs = coeffs.reshape(7, nb_steps, 3).permute(1, 0, 2)         # (S, 7, 3)
    steps = torch.as_tensor(step_multipliers([dt]), device=device)
    a_init = None if a_t0 is None else a_t0.to(torch.complex128)[None]
    A, _ = _solve_batch(phi_grid, steps, coeffs[None], q, n, a_init)
    return A[0]


def contract_log_mgf(a_t: torch.Tensor, y, n: int) -> torch.Tensor:
    """log MGF = A . (1, y, y^2[, y^3, y^4]) over the last axis, y = sigma0 - q."""
    if n == 3:
        ys = torch.stack([torch.ones_like(y), y, y * y])
    else:
        y2 = y * y
        ys = torch.stack([torch.ones_like(y), y, y2, y2 * y, y2 * y2])
    return torch.complex(a_t.real @ ys, a_t.imag @ ys)


def compute_logsv_a_mgf_grid(ttm: float,
                             phi_grid: torch.Tensor,
                             sigma0: float,
                             q: float,
                             times: np.ndarray,
                             a0, a1, kappa0, kappa1, kappa2, beta, volvol,
                             b=None,
                             expansion_order: ExpansionOrder = ExpansionOrder.FIRST,
                             underlying_type: UnderlyingType = UnderlyingType.SWAP,
                             a_t0: Optional[torch.Tensor] = None,
                             engine: str = "f64",
                             **kwargs) -> Tuple[torch.Tensor, torch.Tensor]:
    """(A(ttm) panel (N, n), log MGF (N,)) for the rates model, complex128 on
    ``phi_grid``'s device."""
    if expansion_order not in (ExpansionOrder.FIRST, ExpansionOrder.SECOND):
        raise NotImplementedError
    a_t1 = solve_a_ode_grid(phi_grid=phi_grid, ttm=ttm, q=q, times=times, a0=a0, a1=a1,
                            kappa0=kappa0, kappa1=kappa1, kappa2=kappa2, beta=beta,
                            volvol=volvol, b=b, a_t0=a_t0, expansion_order=expansion_order,
                            underlying_type=underlying_type, engine=engine)
    y = _f64(sigma0, phi_grid.device) - q
    return a_t1, contract_log_mgf(a_t1, y, get_expansion_n(expansion_order))


def solve_a_ode_grid_batch(phi_grid: torch.Tensor,
                           dts,
                           stage_coeffs,
                           q: float,
                           expansion_order: ExpansionOrder = ExpansionOrder.FIRST
                           ) -> torch.Tensor:
    """RK4 Riccati solve over a batch of P slices: A(expiry), (P, N, n)
    complex128.

    ``dts`` is (P,): each slice integrates S shared steps of its own dt
    (S dt_p = expiry_p); ``stage_coeffs`` (P, S, 7, 3) holds the seven
    scalar coefficient series at each slice's RK4 stage times.  The same
    freeze as :func:`solve_a_ode_grid`; one captured graph on a card.
    """
    device = phi_grid.device
    n = get_expansion_n(expansion_order)
    dts = dts.detach().cpu().numpy() if isinstance(dts, torch.Tensor) else dts
    steps = torch.as_tensor(step_multipliers(dts), device=device)
    A, _ = _solve_batch(phi_grid, steps, _f64(stage_coeffs, device), q, n)
    return A
