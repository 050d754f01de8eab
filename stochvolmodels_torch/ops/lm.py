"""
Levenberg-Marquardt for small calibration problems.

PyTorch counterpart of ``stochvolmodels_tpu/ops/lm.py``: a fixed number of
damped Gauss-Newton iterations, each with the residual Jacobian from one
``torch.func.jacfwd`` pass, a conjugate-gradient solve of the tiny normal
system, and a projection onto the box.  The loop has no host sync and no
Python branch on a tensor (accept and reject are ``torch.where``), so the
whole of it, or one iteration on the state (pars, lam, best_pars,
best_cost), can be captured as one CUDA graph.

Constraints: box bounds by projection; inequality constraints are appended
to the residual vector as one-sided penalty terms by the caller.
"""
from __future__ import annotations

from typing import Callable, Tuple

import torch
from torch.func import jacfwd

# (pars, lam, best_pars, best_cost)
LMState = Tuple[torch.Tensor, torch.Tensor, torch.Tensor, torch.Tensor]


def cg_solve(A: torch.Tensor, b: torch.Tensor, iters: int = 8) -> torch.Tensor:
    """conjugate-gradient solve of a tiny SPD system (exact in dim steps)."""
    x = torch.zeros_like(b)
    r = b
    p = r
    rs = r @ r
    for _ in range(iters):
        Ap = A @ p
        alpha = rs / torch.clamp(p @ Ap, min=1e-30)
        x = x + alpha * p
        r = r - alpha * Ap
        rs_new = r @ r
        beta = rs_new / torch.clamp(rs, min=1e-30)
        p = r + beta * p
        rs = rs_new
    return x


def lm_init(residuals_fn: Callable[[torch.Tensor], torch.Tensor], p0: torch.Tensor,
            lam0: float = 1e-2) -> LMState:
    """the state before the first iteration: (pars, lam, best_pars,
    best_cost) = (p0, lam0, p0, ||residuals_fn(p0)||^2)."""
    lam = torch.full((), lam0, dtype=p0.dtype, device=p0.device)
    return p0, lam, p0, torch.sum(torch.square(residuals_fn(p0)))


def residuals_and_jacobian(residuals_fn: Callable[[torch.Tensor], torch.Tensor],
                           pars: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """(J, r): the residuals at ``pars`` and their Jacobian, from one
    forward-mode pass (``jacfwd`` with the residuals as its aux)."""
    return jacfwd(lambda p: (lambda res: (res, res))(residuals_fn(p)), has_aux=True)(pars)


def lm_propose(state: LMState, J: torch.Tensor, r: torch.Tensor, lower: torch.Tensor,
               upper: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """(cost at ``state``'s pars, the projected candidate) of one damped
    Gauss-Newton iteration, from the residuals ``r`` and their Jacobian
    ``J`` at the state's pars."""
    pars, lam = state[0], state[1]
    n = pars.shape[0]
    eye = torch.eye(n, dtype=pars.dtype, device=pars.device)
    cost = torch.sum(r * r)
    g = J.T @ r
    JTJ = J.T @ J
    # scale-invariant damping (Marquardt): lambda * diag(JTJ)
    D = torch.diag(torch.clamp(torch.diagonal(JTJ), min=1e-10))
    step = cg_solve(JTJ + lam * D + 1e-12 * eye, -g, iters=n + 3)
    return cost, torch.clamp(pars + step, lower, upper)


def lm_accept(state: LMState, cost: torch.Tensor, cand: torch.Tensor,
              new_cost: torch.Tensor) -> LMState:
    """the next state once the candidate's cost ``new_cost`` is known: the
    candidate is taken where it lowers ``cost`` (a NaN cost is rejected:
    ``NaN < cost`` is false), and the damping moves accordingly."""
    pars, lam, best_pars, best_cost = state
    accept = new_cost < cost
    pars = torch.where(accept, cand, pars)
    lam = torch.where(accept, torch.clamp(lam / 3.0, min=1e-8), torch.clamp(lam * 4.0, max=1e6))
    better = new_cost < best_cost
    best_pars = torch.where(better, cand, best_pars)
    best_cost = torch.where(better, new_cost, best_cost)
    return pars, lam, best_pars, best_cost


def lm_step(residuals_fn: Callable[[torch.Tensor], torch.Tensor], state: LMState,
            lower: torch.Tensor, upper: torch.Tensor) -> LMState:
    """one damped Gauss-Newton iteration from ``state`` over the box [lower,
    upper]; returns the next state.  An iteration costs one forward-mode
    pass (:func:`residuals_and_jacobian`) and one more residual evaluation at
    the candidate (:func:`lm_propose`, then :func:`lm_accept`)."""
    J, r = residuals_and_jacobian(residuals_fn, state[0])
    cost, cand = lm_propose(state, J, r, lower, upper)
    return lm_accept(state, cost, cand, torch.sum(torch.square(residuals_fn(cand))))


def lm_minimize(residuals_fn: Callable[[torch.Tensor], torch.Tensor],
                p0: torch.Tensor,
                lower: torch.Tensor,
                upper: torch.Tensor,
                nb_iters: int = 16,
                lam0: float = 1e-2,
                ) -> Tuple[torch.Tensor, torch.Tensor]:
    """minimize ||residuals_fn(p)||^2 over the box [lower, upper] in
    ``nb_iters`` iterations of :func:`lm_step` from :func:`lm_init`.

    Returns (best_params, best_cost) as tensors.  Any custom operation inside
    ``residuals_fn`` needs a forward-mode rule and a vmap rule.  A caller
    whose iteration is too large for one CUDA graph of the whole fit
    captures :func:`lm_step` alone and replays it ``nb_iters`` times.
    """
    state = lm_init(residuals_fn, p0, lam0)
    for _ in range(nb_iters):
        state = lm_step(residuals_fn, state, lower, upper)
    return state[2], state[3]
