"""
Affine expansion of the LogSV moment generating function (Sec. 4 of Sepp &
Rakhmonov 2024).

PyTorch counterpart of ``stochvolmodels_tpu/models/logsv/affine.py``.  The
coefficient vector A(tau) per transform point solves the quadratic ODE

    dA^(k)/dtau = A' M^(k) A + (L^(k)(p))' A + H^(k)(p),        (Eq. 4.14)

with n = 3 (first order) or 5 (second order) coefficients.  The state is an
(N, n) complex128 panel and a fixed-step RK4 advances all N transform points
together.  Lanes that diverge are frozen at a cap (see ``solve_a_ode_grid``).
The parameters may be 0-dim float64 tensors, so that calibration takes
forward- and reverse-mode derivatives through the solve.
"""
from __future__ import annotations

from enum import Enum
from typing import Optional, Tuple

import numpy as np
import torch

from stochvolmodels_torch.config import VariableType


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


def _dense(entries: dict, n: int, ndim: int, like: torch.Tensor) -> torch.Tensor:
    """an (n,) * ndim float64 tensor of the entries, zeros elsewhere, stacked
    from 0-dim tensors, so that forward- and reverse-mode AD and vmap go
    through it (no write into a tensor that carries a tangent)."""
    zero = like.new_zeros((), dtype=torch.float64)
    flat = [_tensor_of(entries[idx], like) if idx in entries else zero
            for idx in np.ndindex(*(n,) * ndim)]
    return torch.stack(flat).reshape((n,) * ndim)


def func_a_ode_quadratic_terms(theta, kappa1, kappa2, beta, volvol,
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
    """
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
                     expansion_order: ExpansionOrder = ExpansionOrder.SECOND,
                     vol_backbone_eta: float = 1.0,
                     nb_steps: Optional[int] = None,
                     year_steps: int = 720,
                     warmup_scale: Optional[float] = None
                     ) -> torch.Tensor:
    """advance A over [0, ttm] for the whole grid by fixed-step RK4.

    ``nb_steps = max(ceil(year_steps * ttm), 16)`` uniform steps, as in the
    JAX package.  Divergence freeze: once a lane's |Re A| or |Im A| passes the
    cap (1e6) or turns NaN, it is frozen for good at re=cap, im=0 — a value
    that ``_nansum_re`` always drops, so a lane once diverged stays dropped,
    as the reference's NaN lanes are.

    The parameters are Python floats or 0-dim float64 tensors on the grid's
    device (calibration differentiates through them); ``ttm`` and so the step
    count are host numbers.  The graded warmup grid that serves the
    SIGMA/QVAR seeds (``warmup_scale``) is not ported.
    """
    if warmup_scale is not None:
        raise NotImplementedError("the graded warmup grid serves SIGMA/QVAR seeds only")
    n = get_expansion_n(expansion_order)
    if a_t0 is None:
        a_t0 = torch.zeros((phi_grid.shape[0], n), dtype=torch.complex128,
                           device=phi_grid.device)
    if nb_steps is None:
        nb_steps = max(int(np.ceil(year_steps * float(ttm))), 16)
    dt = float(ttm) / nb_steps

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
    for _ in range(nb_steps):
        k1 = _ode_rhs(A, M_flat, L, H)
        k2 = _ode_rhs(A + k1 * (0.5 * dt), M_flat, L, H)
        k3 = _ode_rhs(A + k2 * (0.5 * dt), M_flat, L, H)
        k4 = _ode_rhs(A + k3 * dt, M_flat, L, H)
        A1 = A + (k1 + k2 * 2.0 + k3 * 2.0 + k4) * (dt / 6.0)
        dead = dead | bad_of(A1)
        A = torch.where(dead, frozen, A1)
    return A


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
    a0 = torch.zeros((n_grid, n_terms), dtype=torch.complex128, device=phi_grid.device)
    if variable_type == VariableType.SIGMA:
        a0[:, 1] = -theta_grid
    return a0
