"""
Levenberg-Marquardt for small calibration problems.

PyTorch counterpart of ``stochvolmodels_tpu/ops/lm.py``: a fixed number of
damped Gauss-Newton iterations, each with the residual Jacobian from one
``torch.func.jacfwd`` pass, a conjugate-gradient solve of the tiny normal
system, and a projection onto the box.  The loop has no host sync and no
Python branch on a tensor (accept and reject are ``torch.where``), so the
whole of it can be captured as one CUDA graph.

Constraints: box bounds by projection; inequality constraints are appended
to the residual vector as one-sided penalty terms by the caller.
"""
from __future__ import annotations

from typing import Callable, Tuple

import torch
from torch.func import jacfwd


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


def lm_minimize(residuals_fn: Callable[[torch.Tensor], torch.Tensor],
                p0: torch.Tensor,
                lower: torch.Tensor,
                upper: torch.Tensor,
                nb_iters: int = 16,
                lam0: float = 1e-2,
                ) -> Tuple[torch.Tensor, torch.Tensor]:
    """minimize ||residuals_fn(p)||^2 over the box [lower, upper].

    Returns (best_params, best_cost) as tensors.  The residuals and their
    Jacobian come from one forward-mode pass (``jacfwd`` with the residuals
    as its aux), so an iteration costs that pass and one more residual
    evaluation at the candidate.  Any custom operation inside
    ``residuals_fn`` needs a forward-mode rule and a vmap rule.  A candidate
    whose cost is NaN is rejected: ``NaN < cost`` is false.
    """
    n = p0.shape[0]
    eye = torch.eye(n, dtype=p0.dtype, device=p0.device)
    jac_and_res = jacfwd(lambda p: (lambda r: (r, r))(residuals_fn(p)), has_aux=True)

    pars, best_pars = p0, p0
    lam = torch.full((), lam0, dtype=p0.dtype, device=p0.device)
    best_cost = torch.sum(torch.square(residuals_fn(p0)))
    for _ in range(nb_iters):
        J, r = jac_and_res(pars)
        cost = torch.sum(r * r)
        g = J.T @ r
        JTJ = J.T @ J
        # scale-invariant damping (Marquardt): lambda * diag(JTJ)
        D = torch.diag(torch.clamp(torch.diagonal(JTJ), min=1e-10))
        step = cg_solve(JTJ + lam * D + 1e-12 * eye, -g, iters=n + 3)
        cand = torch.clamp(pars + step, lower, upper)
        new_cost = torch.sum(torch.square(residuals_fn(cand)))
        accept = new_cost < cost
        pars = torch.where(accept, cand, pars)
        lam = torch.where(accept, torch.clamp(lam / 3.0, min=1e-8),
                          torch.clamp(lam * 4.0, max=1e6))
        better = new_cost < best_cost
        best_pars = torch.where(better, cand, best_pars)
        best_cost = torch.where(better, new_cost, best_cost)
    return best_pars, best_cost
