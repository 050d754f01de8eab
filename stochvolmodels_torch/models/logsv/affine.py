"""
Affine expansion of the LogSV moment generating function (Sec. 4 of Sepp &
Rakhmonov 2024).

PyTorch counterpart of ``stochvolmodels_tpu/models/logsv/affine.py``.  The
coefficient vector A(tau) per transform point solves the quadratic ODE

    dA^(k)/dtau = A' M^(k) A + (L^(k)(p))' A + H^(k)(p),        (Eq. 4.14)

with n = 3 (first order) or 5 (second order) coefficients.  The state is an
(N, n) complex128 panel and a fixed-step RK4 advances all N transform points
together.  Lanes that diverge are frozen at a cap (see ``solve_a_ode_grid``);
the stiff SIGMA and Q_VAR starts take a graded warmup schedule.
The parameters may be 0-dim float64 tensors, so that calibration takes
forward- and reverse-mode derivatives through the solve.  The
exponential-Euler scheme (``solve_analytic_ode_grid``, the reference's
``is_analytic`` path) advances the linear part exactly and the quadratic by
a fixed-point midpoint; the single-point entry points of the reference's
API (``solve_ode_for_a`` and the like) wrap both solvers.
"""
from __future__ import annotations

from enum import Enum
from typing import Optional, Tuple

import numpy as np
import torch

from stochvolmodels_torch.config import VariableType
from stochvolmodels_torch.ops import graphs
from stochvolmodels_torch.ops.mgf import PSI_SPAN, THETA_SPAN


class ExpansionOrder(Enum):
    """truncation order of the affine expansion."""
    ZERO = 0
    FIRST = 1
    SECOND = 2


def get_expansion_n(expansion_order: ExpansionOrder = ExpansionOrder.FIRST) -> int:
    """number of coefficients A^(k): 3 at first order, 5 at second."""
    return 3 if expansion_order == ExpansionOrder.FIRST else 5


def _quadratic_term_entries(theta, kappa1, kappa2, beta, volvol, is_spot_measure: bool,
                            expansion_order: ExpansionOrder, vol_backbone_eta):
    """the nonzero entries of (M, L0, L1, h) as {index: value} dicts.

    The values are products and sums of the parameters, so Python floats and
    0-dim float64 tensors give the same bits.
    """
    theta2 = theta * theta
    vartheta2 = beta * beta + volvol * volvol
    qv = theta * vartheta2
    qv2 = theta2 * vartheta2
    eta = vol_backbone_eta
    eta2 = eta * eta
    bb = beta * eta  # beta * vol_backbone_eta, the phi-coefficient scale
    if is_spot_measure:
        lamda = 0.0 * theta
        kappa2_p = kappa2
        kappa_p = kappa1 + kappa2 * theta
    else:
        lamda = beta * theta2 * eta
        kappa2_p = kappa2 - beta * eta
        kappa_p = kappa1 + kappa2 * theta - 2.0 * beta * theta * eta
    second = expansion_order == ExpansionOrder.SECOND

    M = {(0, 1, 1): 0.5 * qv2, (1, 1, 1): qv, (1, 1, 2): qv2, (1, 2, 1): qv2,
         (2, 1, 1): 0.5 * vartheta2, (2, 2, 2): 2.0 * qv2,
         (2, 2, 1): 2.0 * qv, (2, 1, 2): 2.0 * qv}
    if second:
        M.update({(2, 1, 3): 1.5 * qv2, (2, 3, 1): 1.5 * qv2, (3, 2, 2): 4.0 * qv,
                  (3, 1, 2): vartheta2, (3, 2, 1): vartheta2,
                  (3, 1, 3): 3.0 * qv, (3, 3, 1): 3.0 * qv,
                  (3, 1, 4): 2.0 * qv2, (3, 4, 1): 2.0 * qv2,
                  (3, 2, 3): 3.0 * qv2, (3, 3, 2): 3.0 * qv2,
                  (4, 2, 2): 2.0 * vartheta2, (4, 3, 3): 4.5 * qv2,
                  (4, 1, 3): 1.5 * vartheta2, (4, 3, 1): 1.5 * vartheta2,
                  (4, 1, 4): 4.0 * qv, (4, 4, 1): 4.0 * qv,
                  (4, 2, 3): 6.0 * qv, (4, 3, 2): 6.0 * qv,
                  (4, 2, 4): 4.0 * qv2, (4, 4, 2): 4.0 * qv2})
    L0 = {(0, 1): lamda, (0, 2): qv2, (1, 1): -kappa_p, (1, 2): 2.0 * (lamda + qv),
          (2, 1): -kappa2_p, (2, 2): vartheta2 - 2.0 * kappa_p}
    L1 = {(0, 1): -theta2 * bb, (1, 1): -2.0 * theta * bb, (1, 2): -2.0 * theta2 * bb,
          (2, 1): -bb, (2, 2): -4.0 * theta * bb}
    if second:
        L0.update({(1, 3): 3.0 * qv2, (2, 3): 6.0 * qv, (2, 4): 6.0 * qv2,
                   (3, 2): -2.0 * kappa2_p, (3, 3): 3.0 * (vartheta2 - kappa_p),
                   (3, 4): 12.0 * qv, (4, 3): -3.0 * kappa2_p,
                   (4, 4): 2.0 * (vartheta2 - 2.0 * kappa_p)})
        L1.update({(2, 3): -3.0 * theta2 * bb, (3, 2): -2.0 * bb, (3, 3): -6.0 * theta * bb,
                   (3, 4): -4.0 * theta2 * bb, (4, 3): -3.0 * bb, (4, 4): -8.0 * theta * bb})
    h = {(0,): 0.5 * theta2 * eta2, (1,): theta * eta2, (2,): 0.5 * eta2}
    return M, L0, L1, h


def _tensor_of(value, like: torch.Tensor) -> torch.Tensor:
    """``value`` as a 0-dim float64 tensor on ``like``'s device, made by a fill
    (no host-to-device copy) when it is a Python number."""
    if isinstance(value, torch.Tensor):
        return value.to(torch.float64)
    return like.new_full((), value, dtype=torch.float64)


def f64_scalars(device, *values) -> list:
    """the values as 0-dim float64 tensors on ``device``, made by fills (no
    copy from the host); tensors pass through as float64.  With tensor
    parameters ``kappa1 theta / sigma`` is a true division, as the JAX
    package computes it (a Python number over a tensor is a reciprocal and
    a product)."""
    return [v.to(torch.float64) if isinstance(v, torch.Tensor)
            else torch.full((), float(v), dtype=torch.float64, device=device) for v in values]


def _dense(entries: dict, n: int, ndim: int, like: torch.Tensor) -> torch.Tensor:
    """an (n,) * ndim float64 tensor of the entries, zeros elsewhere, stacked
    from 0-dim tensors, so that forward- and reverse-mode AD and vmap go
    through it (no write into a tensor that carries a tangent)."""
    zero = like.new_zeros((), dtype=torch.float64)
    flat = [_tensor_of(entries[idx], like) if idx in entries else zero
            for idx in np.ndindex(*(n,) * ndim)]
    return torch.stack(flat).reshape((n,) * ndim)


def func_a_ode_quadratic_terms(theta, kappa1, kappa2, beta, volvol,
                               phi=None,
                               psi=None,
                               is_spot_measure: bool = True,
                               expansion_order: ExpansionOrder = ExpansionOrder.SECOND,
                               vol_backbone_eta=1.0):
    """the phi-independent pieces (M, L0, L1, h) of M^(k), L^(k)(p), H^(k)(p).

    L is linear in phi and M does not depend on phi (Remark 4.1), so

        L(phi) = L0 + phi * L1,     H(phi, psi) = h * (phi(phi+p) - 2 psi).

    With Python-float parameters, returns float64 numpy arrays M (n, n, n),
    L0 and L1 (n, n), h (n,).  If any parameter is a tensor (0-dim float64,
    as calibration passes them), returns float64 tensors on its device that
    carry gradients and tangents, with the same bits as the float build.
    With ``phi`` (and ``psi``, default 0) given, the reference's per-point
    form, returns the combined complex (M, L(phi), H(phi, psi)) instead.
    """
    if phi is not None:
        M, L0, L1, h = func_a_ode_quadratic_terms(
            theta, kappa1, kappa2, beta, volvol, is_spot_measure=is_spot_measure,
            expansion_order=expansion_order, vol_backbone_eta=vol_backbone_eta)
        phi, psi = complex(phi), complex(0.0 if psi is None else psi)
        p = 1.0 if is_spot_measure else -1.0
        return M, L0 + phi * L1, h * (phi * (phi + p) - 2.0 * psi)
    n = get_expansion_n(expansion_order)
    entries = _quadratic_term_entries(theta, kappa1, kappa2, beta, volvol, is_spot_measure,
                                      expansion_order, vol_backbone_eta)
    like = next((p for p in (theta, kappa1, kappa2, beta, volvol, vol_backbone_eta)
                 if isinstance(p, torch.Tensor)), None)
    if like is not None:
        return tuple(_dense(e, n, nd, like) for e, nd in zip(entries, (3, 2, 2, 1)))
    out = []
    for e, nd in zip(entries, (3, 2, 2, 1)):
        a = np.zeros((n,) * nd)
        for idx, v in e.items():
            a[idx] = v
        out.append(a)
    return tuple(out)


def build_grid_ode_terms(M, L0, L1, h, phi_grid: torch.Tensor, psi_grid: torch.Tensor,
                         is_spot_measure: bool
                         ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """the ODE terms against the transform grid, complex128 on the grid's device:
    M flattened to (n, n*n), L (N, n, n) and H (N, n).  (M, L0, L1, h) are
    numpy arrays or float64 tensors."""
    device = phi_grid.device
    f64 = lambda a: a if isinstance(a, torch.Tensor) else torch.as_tensor(
        a, dtype=torch.float64, device=device)
    M, L0, L1, h = (f64(a) for a in (M, L0, L1, h))
    n = h.shape[0]
    M_flat = M.reshape(n, n * n).to(torch.complex128)
    L = torch.complex(L0[None, :, :] + phi_grid.real[:, None, None] * L1[None],
                      phi_grid.imag[:, None, None] * L1[None])
    p = 1.0 if is_spot_measure else -1.0
    rhs = phi_grid * (phi_grid + p) - psi_grid * 2.0              # (N,)
    H = h.to(torch.complex128)[None, :] * rhs[:, None]
    return M_flat, L, H


def _ode_rhs(A: torch.Tensor, M_flat: torch.Tensor, L: torch.Tensor,
             H: torch.Tensor) -> torch.Tensor:
    """dA/dtau = A' M A + L A + H for the whole (N, n) complex panel."""
    outer = (A[:, :, None] * A[:, None, :]).flatten(1)              # (N, n*n)
    quad = outer @ M_flat.T                                        # (N, n)
    lin = torch.matmul(L, A[:, :, None])[..., 0]                   # (N, n)
    return quad + lin + H


def solve_a_ode_grid(phi_grid: torch.Tensor,
                     psi_grid: torch.Tensor,
                     ttm: float,
                     theta: float,
                     kappa1: float,
                     kappa2: float,
                     beta: float,
                     volvol: float,
                     is_spot_measure: bool = True,
                     a_t0: Optional[torch.Tensor] = None,
                     is_stiff_solver: bool = False,
                     expansion_order: ExpansionOrder = ExpansionOrder.SECOND,
                     vol_backbone_eta: float = 1.0,
                     nb_steps: Optional[int] = None,
                     year_steps: int = 720,
                     unroll: int = 4,
                     warmup_scale: Optional[float] = None
                     ) -> torch.Tensor:
    """advance A over [0, ttm] for the whole grid by fixed-step RK4.

    ``nb_steps = max(ceil(year_steps * ttm), 16)`` uniform steps, as in the
    JAX package.  Divergence freeze: once a lane's |Re A| or |Im A| passes the
    cap (1e6) or turns NaN, it is frozen for good at re=cap, im=0 — a value
    that ``_nansum_re`` always drops, so a lane once diverged stays dropped,
    as the reference's NaN lanes are.

    ``warmup_scale`` (the stiffness scale of the initial transient, about
    vartheta^2 max|A(0)|): where ``warmup_scale * dt > 0.2`` the uniform grid
    is preceded by a graded warmup whose steps grow from 0.01/warmup_scale
    as 0.05 t (:func:`warmup_dts`).  ``is_stiff_solver`` runs the uniform
    phase 4x finer and, with float parameters, derives the warmup scale from
    the data (vartheta^2 max(1, |A(0)|)).

    The parameters are Python floats or 0-dim float64 tensors on the grid's
    device (calibration differentiates through them); ``ttm`` and so the step
    schedule are host numbers.  ``unroll`` (the JAX scan's unroll factor) is
    accepted for the signature and unused.
    """
    del unroll
    n = get_expansion_n(expansion_order)
    if is_stiff_solver:
        year_steps = 4 * year_steps
        nb_steps = None if nb_steps is None else 4 * nb_steps
        params = (beta, volvol)
        if warmup_scale is None and a_t0 is not None and not any(
                isinstance(p, torch.Tensor) for p in params):
            # tensor parameters keep the 4x refinement only, as traced ones do
            a0_mag = float(torch.max(torch.abs(a_t0)))
            warmup_scale = (float(beta) ** 2 + float(volvol) ** 2) * max(1.0, a0_mag)
    if a_t0 is None:
        a_t0 = torch.zeros((phi_grid.shape[0], n), dtype=torch.complex128,
                           device=phi_grid.device)
    if nb_steps is None:
        nb_steps = max(int(np.ceil(year_steps * float(ttm))), 16)
    dt = float(ttm) / nb_steps
    dts = warmup_dts(float(ttm), dt, warmup_scale)
    if dts is None:
        dts = [dt] * nb_steps
    return _solve_a_ode_grid_dts(dts, theta, kappa1, kappa2, beta, volvol, phi_grid, psi_grid,
                                 a_t0, is_spot_measure, expansion_order, vol_backbone_eta)


def warmup_dts(ttm: float, dt: float, warmup_scale: Optional[float]) -> Optional[list]:
    """the graded step schedule of a stiff start, or None where the uniform
    step ``dt`` is stable (``warmup_scale * dt <= 0.2``).

    Warmup steps start at 0.01/warmup_scale and grow as 0.05 t (the Riccati
    transient's stiffness decays as 1/t) until they reach ``dt`` or cover
    half the horizon; the rest runs at max(ceil(rem/dt), 16) uniform steps.
    """
    if warmup_scale is None or warmup_scale * dt <= 0.2:
        return None
    out, d, t_acc = [], 0.01 / warmup_scale, 0.0
    while d < dt and t_acc + d < 0.5 * ttm:
        out.append(d)
        t_acc += d
        d = max(d, 0.05 * t_acc)
    rem = ttm - t_acc
    nb_uniform = max(int(np.ceil(rem / dt)), 16)
    return out + [rem / nb_uniform] * nb_uniform


def _solve_a_ode_grid_dts(dts, theta, kappa1, kappa2, beta, volvol, phi_grid: torch.Tensor,
                          psi_grid: torch.Tensor, a_t0: torch.Tensor, is_spot_measure: bool,
                          expansion_order: ExpansionOrder, vol_backbone_eta) -> torch.Tensor:
    """RK4 over the host step schedule ``dts`` (floats), with the divergence
    freeze of :func:`solve_a_ode_grid`."""
    M, L0, L1, h = func_a_ode_quadratic_terms(
        theta=theta, kappa1=kappa1, kappa2=kappa2, beta=beta, volvol=volvol,
        is_spot_measure=is_spot_measure, expansion_order=expansion_order,
        vol_backbone_eta=vol_backbone_eta)
    M_flat, L, H = build_grid_ode_terms(M, L0, L1, h, phi_grid, psi_grid, is_spot_measure)

    cap = 1e6
    # made by fills, not copies from the host, so a CUDA graph can capture it
    frozen = torch.complex(torch.full((), cap, dtype=torch.float64, device=a_t0.device),
                           torch.zeros((), dtype=torch.float64, device=a_t0.device))

    def bad_of(a: torch.Tensor) -> torch.Tensor:
        # ~(x < cap) is also True for NaN
        return ~(torch.abs(a.real) < cap) | ~(torch.abs(a.imag) < cap)

    dead = bad_of(a_t0)
    A = torch.where(dead, frozen, a_t0)
    for dt in dts:
        k1 = _ode_rhs(A, M_flat, L, H)
        k2 = _ode_rhs(A + k1 * (0.5 * dt), M_flat, L, H)
        k3 = _ode_rhs(A + k2 * (0.5 * dt), M_flat, L, H)
        k4 = _ode_rhs(A + k3 * dt, M_flat, L, H)
        A1 = A + (k1 + k2 * 2.0 + k3 * 2.0 + k4) * (dt / 6.0)
        dead = dead | bad_of(A1)
        A = torch.where(dead, frozen, A1)
    return A


# ----------------------------------------------------------------------------
# the exponential-Euler solver (the reference's "analytic" path)
# ----------------------------------------------------------------------------

def _expm_phi1(L: torch.Tensor, dt: float, n_squarings: int = 10,
               taylor_terms: int = 10) -> Tuple[torch.Tensor, torch.Tensor]:
    """batched (expm(L dt), dt phi1(L dt)) of a complex128 (N, n, n) panel.

    phi1(z) = (e^z - 1)/z = sum_k z^k/(k+1)! gives the exact integral of
    the linear step, int_0^dt expm(L s) ds = dt phi1(L dt), with no matrix
    inverse and no special case for zero eigenvalues.  Scaling and squaring
    with the joint recurrence E <- E^2, P <- (E + I)/2 P keeps the Taylor
    argument at |L dt| / 2^10, so 10 terms reach ~1e-15 (the JAX package's
    ``_expm_phi1``; ``torch.linalg.matrix_exp`` rounds otherwise and gives
    no phi1).
    """
    A = L * (dt / (2.0 ** n_squarings))
    eye = torch.eye(L.shape[-1], dtype=L.dtype, device=L.device)
    T = E = P = eye.expand(L.shape)
    for k in range(1, taylor_terms + 1):
        T = torch.matmul(T, A / k)
        E = E + T
        P = P + T / (k + 1.0)
    for _ in range(n_squarings):
        P = torch.matmul(0.5 * (E + eye), P)
        E = torch.matmul(E, E)
    return E, P * dt


def analytic_nb_steps(ttm: float, p_max: float, year_days: int = 260) -> int:
    """steps of :func:`solve_analytic_ode_grid` over ``ttm``: daily
    (``year_days`` a year), and at least 25 p_max ttm, so that |phi| dt
    stays inside the fixed point's contraction region."""
    return max(int(np.ceil(year_days * float(ttm))), int(np.ceil(25.0 * p_max * float(ttm))), 1)


def phi_grid_p_max(vol_scaler: float) -> float:
    """max|Im phi| + max|Re phi| of ``mgf.get_phi_grid(vol_scaler=...)``
    from its host constants: the grid ends at exactly 5.6 / vol_scaler and
    its real part is -1/2 or +1/2."""
    return 5.6 / float(vol_scaler) + 0.5


def _analytic_steps(phi_grid, psi_grid, a_t0, pvec, *, nb_steps: int, dt: float, nfp: int,
                    is_spot_measure: bool, expansion_order: ExpansionOrder):
    """the ``nb_steps`` exponential-midpoint steps of
    :func:`solve_analytic_ode_grid` from ``a_t0``; ``pvec`` = (theta,
    kappa1, kappa2, beta, volvol, eta) float64 on the grid's device."""
    theta, kappa1, kappa2, beta, volvol, eta = pvec.unbind()
    M, L0, L1, h = func_a_ode_quadratic_terms(
        theta=theta, kappa1=kappa1, kappa2=kappa2, beta=beta, volvol=volvol,
        is_spot_measure=is_spot_measure, expansion_order=expansion_order,
        vol_backbone_eta=eta)
    M_flat, L, H = build_grid_ode_terms(M, L0, L1, h, phi_grid, psi_grid, is_spot_measure)
    E, P = _expm_phi1(L, dt)
    cap = 1e6

    def bad_of(a: torch.Tensor) -> torch.Tensor:
        # ~(x < cap) is also True for NaN
        return (~(torch.abs(a.real) < cap) | ~(torch.abs(a.imag) < cap)).any(-1)

    frozen = torch.complex(torch.full_like(a_t0.real, cap), torch.zeros_like(a_t0.real))
    dead = bad_of(a_t0)
    a = torch.where(dead[:, None], frozen, a_t0)
    for _ in range(nb_steps):
        ea = torch.matmul(E, a[:, :, None])[..., 0]
        f = a
        for _ in range(nfp):
            m = 0.5 * (a + f)
            q = (m[:, :, None] * m[:, None, :]).flatten(1) @ M_flat.T + H
            f = ea + torch.matmul(P, q[:, :, None])[..., 0]
        dead = dead | bad_of(f)
        a = torch.where(dead[:, None], frozen, f)
    return (a,)


def solve_analytic_ode_grid(phi_grid: torch.Tensor,
                            psi_grid: torch.Tensor,
                            ttm: float,
                            theta,
                            kappa1,
                            kappa2,
                            beta,
                            volvol,
                            is_spot_measure: bool = True,
                            a_t0: Optional[torch.Tensor] = None,
                            expansion_order: ExpansionOrder = ExpansionOrder.SECOND,
                            vol_backbone_eta=1.0,
                            year_days: int = 260,
                            nfp: int = 10,
                            p_max: Optional[float] = None) -> torch.Tensor:
    """the exponential-Euler alternative to :func:`solve_a_ode_grid`.

    The linear part advances exactly through E = expm(L dt) and the
    quadratic A'MA is resolved by ``nfp`` fixed-point iterations of the
    exponential-midpoint update

        A_{t+dt} = E A_t + dt phi1(L dt) (H + quad((A_t + A_fp)/2)).

    Steps: :func:`analytic_nb_steps` from ``p_max`` = max|Im phi| +
    max|Re phi|, a host number: give it (:func:`phi_grid_p_max` of the
    grid's vol scaler) for a grid on a card, where reading it back would
    stall the stream; a CPU grid is read.  Divergence freeze as in
    :func:`solve_a_ode_grid`: a lane whose |Re A| or |Im A| passes 1e6 (or
    turns NaN) is frozen at re=1e6, im=0.  On a card, with parameters that
    carry no gradient, the solve is one CUDA graph per (grid size, ttm,
    steps, expansion order, measure).
    """
    n = get_expansion_n(expansion_order)
    if a_t0 is None:
        a_t0 = torch.zeros((phi_grid.shape[0], n), dtype=torch.complex128,
                           device=phi_grid.device)
    if p_max is None:
        if phi_grid.is_cuda:
            raise ValueError("solve_analytic_ode_grid: pass p_max (phi_grid_p_max(vol_scaler)) "
                             "for a grid on a card")
        p_max = float(torch.max(torch.abs(phi_grid.imag)) + torch.max(torch.abs(phi_grid.real)))
    nb_steps = analytic_nb_steps(ttm, p_max, year_days)
    pvec = torch.stack(f64_scalars(phi_grid.device, theta, kappa1, kappa2, beta, volvol,
                                   vol_backbone_eta))
    static = dict(nb_steps=nb_steps, dt=float(ttm) / nb_steps, nfp=int(nfp),
                  is_spot_measure=bool(is_spot_measure), expansion_order=expansion_order)
    inputs = (phi_grid, psi_grid, a_t0.to(torch.complex128), pvec)
    fn = lambda *a: _analytic_steps(*a, **static)
    if graphs.use_graph(phi_grid) and not pvec.requires_grad:
        key = (phi_grid.shape[0], float(ttm)) + tuple(static.values()) + (str(phi_grid.device),)
        return graphs.run_captured("logsv_analytic_ode", key, fn, inputs)[0]
    return fn(*inputs)[0]


# ----------------------------------------------------------------------------
# single-point entry points of the reference's API (numpy in and out)
# ----------------------------------------------------------------------------

def _terms_np(theta, kappa1, kappa2, beta, volvol, phi, psi,
              is_spot_measure=True,
              expansion_order: ExpansionOrder = ExpansionOrder.FIRST,
              vol_backbone_eta: float = 1.0):
    """assembled numpy-complex (M, L, H) at one transform point."""
    M, L0, L1, h = func_a_ode_quadratic_terms(
        theta, kappa1, kappa2, beta, volvol, is_spot_measure=is_spot_measure,
        expansion_order=expansion_order, vol_backbone_eta=vol_backbone_eta)
    L = L0 + phi * L1
    p = 1.0 if is_spot_measure else -1.0
    H = h * (phi * (phi + p) - 2.0 * psi)
    return M, L, H


def func_rhs(t, A0, M, L, H):
    """right-hand side of the coefficient ODEs at one point, in the
    reference's signature (t, A, M, L, H)."""
    n = A0.shape[0]
    quadratic = np.array([A0.T @ M[k] @ A0 for k in range(n)])
    return quadratic + L @ A0 + H


def func_rhs_jac(t, A0, M, L, H):
    """Jacobian of :func:`func_rhs`."""
    n = A0.shape[0]
    quadratic = np.stack([2.0 * M[k] @ A0 for k in range(n)])
    return quadratic + L


class _OdeResultShim:
    """stand-in for scipy's OdeResult: ``.y`` (n, n_t), ``.t`` (n_t,), and a
    linear interpolant ``.sol(t)`` when built from a dense trajectory."""

    def __init__(self, y: np.ndarray, t: Optional[np.ndarray] = None):
        self.y = y
        self.t = np.array([0.0]) if t is None else t

    def sol(self, t):
        t = np.atleast_1d(np.asarray(t, dtype=float))
        return np.stack([np.interp(t, self.t, self.y[i]) for i in range(self.y.shape[0])])


def _point(z, device) -> torch.Tensor:
    """a complex number as a (1,) complex128 tensor on ``device``."""
    return torch.tensor([complex(z)], dtype=torch.complex128, device=device)


def _start(a_t0, n: int, device) -> torch.Tensor:
    """A(0) of a single-point solve as a (1, n) complex128 tensor."""
    if a_t0 is None:
        return torch.zeros((1, n), dtype=torch.complex128, device=device)
    return torch.as_tensor(np.asarray(a_t0, dtype=complex), device=device).reshape(1, n)


def solve_ode_for_a(ttm, theta, kappa1, kappa2, beta, volvol, phi, psi,
                    is_spot_measure: bool = True, a_t0=None,
                    expansion_order: ExpansionOrder = ExpansionOrder.FIRST,
                    is_stiff_solver: bool = False, dense_output: bool = False,
                    vol_backbone_eta: float = 1.0, device="cuda", **kwargs) -> _OdeResultShim:
    """single-point solve in the reference's signature, by the batched RK4.

    ``dense_output=True`` returns the trajectory on a uniform time grid
    (``.t`` (n_t,), ``.y`` (n, n_t), linear ``.sol``) by chaining equal
    sub-interval solves; ``is_stiff_solver`` selects the 4x finer schedule
    of :func:`solve_a_ode_grid`.
    """
    n = get_expansion_n(expansion_order)
    common = dict(theta=theta, kappa1=kappa1, kappa2=kappa2, beta=beta, volvol=volvol,
                  phi_grid=_point(phi, device), psi_grid=_point(psi, device),
                  is_spot_measure=is_spot_measure, expansion_order=expansion_order,
                  vol_backbone_eta=vol_backbone_eta, is_stiff_solver=is_stiff_solver)
    a0 = _start(a_t0, n, device)
    if dense_output:
        n_seg = max(int(np.ceil(100 * float(ttm))), 16)
        t_grid = np.linspace(0.0, float(ttm), n_seg + 1)
        traj = [a0[0].cpu().numpy()]
        a_cur = a0
        for _ in range(n_seg):
            a_cur = solve_a_ode_grid(ttm=float(ttm) / n_seg, a_t0=a_cur, **common)
            traj.append(a_cur[0].cpu().numpy())
        return _OdeResultShim(np.stack(traj, axis=1), t_grid)
    a1 = solve_a_ode_grid(ttm=float(ttm), a_t0=a0, **common)
    return _OdeResultShim(a1[0].cpu().numpy()[:, None], np.array([float(ttm)]))


def solve_analytic_ode_for_a(ttm, theta, kappa1, kappa2, beta, volvol, phi, psi,
                             is_spot_measure, a_t0=None,
                             expansion_order: ExpansionOrder = ExpansionOrder.FIRST,
                             year_days: int = 260, device="cuda", **kwargs) -> np.ndarray:
    """single-point exponential-Euler solve in the reference's signature
    (:func:`solve_analytic_ode_grid` on one transform point)."""
    n = get_expansion_n(expansion_order)
    a1 = solve_analytic_ode_grid(
        ttm=float(ttm), theta=theta, kappa1=kappa1, kappa2=kappa2, beta=beta, volvol=volvol,
        phi_grid=_point(phi, device), psi_grid=_point(psi, device),
        a_t0=_start(a_t0, n, device), is_spot_measure=is_spot_measure,
        expansion_order=expansion_order, year_days=year_days,
        p_max=abs(complex(phi).imag) + abs(complex(phi).real))
    return a1[0].cpu().numpy()


def solve_analytic_ode_for_a0(t_span, theta, kappa1, kappa2, beta, volvol, phi, psi,
                              expansion_order: ExpansionOrder = ExpansionOrder.FIRST,
                              device="cuda") -> np.ndarray:
    """the reference's superseded entry point: :func:`solve_analytic_ode_for_a`
    over ``t_span`` under the spot measure."""
    return solve_analytic_ode_for_a(ttm=t_span[1] - t_span[0], theta=theta, kappa1=kappa1,
                                    kappa2=kappa2, beta=beta, volvol=volvol, phi=phi, psi=psi,
                                    is_spot_measure=True, expansion_order=expansion_order,
                                    device=device)


def solve_analytic_ode_grid_phi(phi_grid, psi_grid, ttm, theta, kappa1, kappa2, beta, volvol,
                                is_spot_measure: bool = True, a_t0=None,
                                expansion_order: ExpansionOrder = ExpansionOrder.FIRST,
                                use_analytic_scheme: bool = True, device="cuda") -> np.ndarray:
    """grid solve with numpy-complex input and output, by the exponential-
    Euler scheme (``use_analytic_scheme=False``: the RK4)."""
    phi_np = np.asarray(phi_grid, dtype=complex)
    phi_t = torch.as_tensor(phi_np, device=device)
    psi_t = torch.as_tensor(np.asarray(psi_grid, dtype=complex), device=device)
    n = get_expansion_n(expansion_order)
    if a_t0 is None:
        a0 = torch.zeros((phi_t.shape[0], n), dtype=torch.complex128, device=device)
    else:
        a0 = torch.as_tensor(np.asarray(a_t0, dtype=complex), device=device)
    common = dict(ttm=float(ttm), theta=theta, kappa1=kappa1, kappa2=kappa2, beta=beta,
                  volvol=volvol, phi_grid=phi_t, psi_grid=psi_t, a_t0=a0,
                  is_spot_measure=is_spot_measure, expansion_order=expansion_order)
    if use_analytic_scheme:
        a1 = solve_analytic_ode_grid(p_max=float(np.max(np.abs(phi_np.imag))
                                                 + np.max(np.abs(phi_np.real))), **common)
    else:
        a1 = solve_a_ode_grid(**common)
    return a1.cpu().numpy()


def get_init_conditions_a(phi_grid: torch.Tensor, psi_grid: torch.Tensor,
                          theta_grid: torch.Tensor, n_terms: int,
                          variable_type: VariableType = VariableType.LOG_RETURN
                          ) -> torch.Tensor:
    """A(0) over the grid: zeros, except SIGMA seeds A^(1)(0) = -Theta."""
    if variable_type == VariableType.LOG_RETURN:
        n_grid = phi_grid.shape[0]
    elif variable_type == VariableType.Q_VAR:
        n_grid = psi_grid.shape[0]
    elif variable_type == VariableType.SIGMA:
        n_grid = theta_grid.shape[0]
    else:
        raise NotImplementedError
    zeros = torch.zeros((n_grid, n_terms), dtype=torch.complex128, device=phi_grid.device)
    if variable_type != VariableType.SIGMA:
        return zeros
    column = torch.arange(n_terms, device=phi_grid.device) == 1
    return torch.where(column, -theta_grid[:, None], zeros)


def compute_logsv_a_mgf_grid(ttm: float,
                             phi_grid: torch.Tensor,
                             psi_grid: torch.Tensor,
                             theta_grid: torch.Tensor,
                             sigma0,
                             theta,
                             kappa1,
                             kappa2,
                             beta,
                             volvol,
                             variable_type: VariableType = VariableType.LOG_RETURN,
                             expansion_order: ExpansionOrder = ExpansionOrder.SECOND,
                             a_t0: Optional[torch.Tensor] = None,
                             is_stiff_solver: bool = False,
                             is_analytic: bool = False,
                             is_spot_measure: bool = True,
                             vol_backbone_eta=1.0,
                             nb_steps: Optional[int] = None,
                             engine: str = "f64",
                             **kwargs
                             ) -> Tuple[torch.Tensor, torch.Tensor]:
    """solve the coefficient ODEs and contract against the powers of
    Y = sigma0 - theta; returns (A(tau) panel (N, n), log MGF (N,)).

    SIGMA (seeded A^(1)(0) = -Theta, |Theta| to 600) and Q_VAR (forced by
    -2 psi, |psi| to 4000) start stiff on a ~1/(rate * span) timescale, so
    they run the graded warmup of :func:`solve_a_ode_grid` with
    ``warmup_scale = rate * span``: ``span`` is the standard grid's extent
    plus one (601 for Theta, 4001 for Psi, host constants), ``rate`` is
    max(vartheta^2, kappa1 + kappa2) with float parameters and 40 with
    tensor parameters (the JAX package's bound for traced ones).  Q_VAR
    steps at int(720 * 2 sqrt(span / 1000)) = 2880 steps/yr unless
    ``nb_steps`` is given.  ``engine`` 'f64' and 'df32' (the JAX package's
    TPU carrier) both run the float64 RK4.  ``is_analytic=True`` runs
    LOG_RETURN through the exponential-Euler :func:`solve_analytic_ode_grid`
    (SIGMA and Q_VAR keep the graded-warmup RK4, as in the JAX package); on
    a card it needs the grid's ``vol_scaler`` as a keyword.
    """
    if engine not in ("f64", "df32"):
        raise NotImplementedError(f"engine={engine}")
    n_terms = get_expansion_n(expansion_order)
    if a_t0 is None:
        a_t0 = get_init_conditions_a(phi_grid=phi_grid, psi_grid=psi_grid,
                                     theta_grid=theta_grid, n_terms=n_terms,
                                     variable_type=variable_type)
    warmup_scale = None
    if variable_type in (VariableType.SIGMA, VariableType.Q_VAR):
        span = (THETA_SPAN if variable_type == VariableType.SIGMA else PSI_SPAN) + 1.0
        if any(isinstance(p, torch.Tensor) for p in (beta, volvol, kappa1, kappa2)):
            rate = 40.0
        else:
            rate = max(float(beta) ** 2 + float(volvol) ** 2, float(kappa1) + float(kappa2))
        warmup_scale = rate * span
        if variable_type == VariableType.Q_VAR and nb_steps is None:
            year_steps_eff = int(720 * max(1.0, 2.0 * np.sqrt(span / 1000.0)))
            nb_steps = max(int(np.ceil(year_steps_eff * float(ttm))), 16)
    if is_analytic and variable_type == VariableType.LOG_RETURN:
        vol_scaler = kwargs.get("vol_scaler")
        p_max = None if vol_scaler is None else phi_grid_p_max(vol_scaler)
        a_t1 = solve_analytic_ode_grid(
            ttm=ttm, theta=theta, kappa1=kappa1, kappa2=kappa2, beta=beta, volvol=volvol,
            phi_grid=phi_grid, psi_grid=psi_grid, a_t0=a_t0, is_spot_measure=is_spot_measure,
            expansion_order=expansion_order, vol_backbone_eta=vol_backbone_eta, p_max=p_max)
    else:
        a_t1 = solve_a_ode_grid(ttm=ttm, theta=theta, kappa1=kappa1, kappa2=kappa2, beta=beta,
                                volvol=volvol, phi_grid=phi_grid, psi_grid=psi_grid, a_t0=a_t0,
                                is_spot_measure=is_spot_measure, expansion_order=expansion_order,
                                vol_backbone_eta=vol_backbone_eta, nb_steps=nb_steps,
                                warmup_scale=warmup_scale, is_stiff_solver=is_stiff_solver)
    return a_t1, contract_log_mgf(a_t1, sigma0 - theta, expansion_order)


def contract_log_mgf(a_t: torch.Tensor, y, expansion_order: ExpansionOrder) -> torch.Tensor:
    """log MGF = A(tau) . (1, Y, Y^2[, Y^3, Y^4]) with Y = sigma0 - theta a
    Python float or a 0-dim float64 tensor."""
    y2 = y * y
    ys = [1.0, y, y2] if expansion_order == ExpansionOrder.FIRST else [1.0, y, y2, y2 * y, y2 * y2]
    if isinstance(y, torch.Tensor):
        ys = torch.stack([_tensor_of(v, y) for v in ys])
    else:
        ys = torch.tensor(ys, dtype=torch.float64, device=a_t.device)
    return torch.complex(a_t.real @ ys, a_t.imag @ ys)
