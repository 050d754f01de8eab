"""
Plain reference of the Hawkes jump-diffusion with self- and cross-exciting
jump intensities (Liu, Packham & Sepp 2025, arXiv:2510.21297): the Euler
scheme of its Monte Carlo with intensity thinning on (x, lambda+, lambda-).

In each step of dt, from the step's draws of the counter stream (streams 0-5
of ``reference/mc.py``):

* z = sqrt(max(-2 ln u0, 0)) cos(pi u1), the one normal of the step;
* the side +/- fires a jump where lambda+/- > -ln(u2/u3) / dt, taken as
  (-ln u) f32(1/dt);
* a jump's size is shift+ + e4 mean+ (or shift- - e5 (-mean-)), e = -ln u of
  stream 4 (5);
* x takes the diffusion (mu - sigma^2 / 2) dt - comp+ dt lambda+ - comp- dt
  lambda- + sigma z sqrt(dt), comp = e^shift / (1 - mean) - 1 the jump
  compensator, and the jumps that fired;
* each intensity mean-reverts, lambda + kappa (theta - lambda) dt, and takes
  the loads beta1 J+ + beta2 J- (lambda+) and beta1- J+ + beta2- J- (lambda-).

The float32 operations follow the order in which the model's CUDA kernel
rounds them (no fused multiply-add), so that each thinning test decides as
the kernel's does, path by path: a test decided otherwise moves a path by a
whole jump.  Scalars are taken in float64 and rounded once to float32.  The
state's precision is an argument (float32 for the reference, bfloat16 for
the control); the draws stay float32 and meet the state in its precision.
No LM cell of this model exists, so ``fit`` raises.
"""
from __future__ import annotations

from typing import Dict

import numpy as np
import torch

from . import mc


def fit(*args, **kwargs):
    raise NotImplementedError("no LM cell of the Hawkes jump-diffusion exists: its reference "
                              "has the MC chain only")


class Draws(mc.Normals):
    """the float32 uniforms of the counter stream, by step and stream."""

    def uniform(self, step: int, stream: int) -> torch.Tensor:
        bits = mc._hash(self.idx ^ mc._key(self.seeds, step, stream)[self.block])
        return mc._uniform(bits)


def step_scalars(params: Dict[str, float], dt: float) -> Dict[str, float]:
    """the step's float32 scalars (as Python floats): the parameters, dt,
    sqrt(dt), 1/dt and the compensators times dt, each taken in float64 and
    rounded once, and the drift (mu - (0.5 sigma) sigma) dt in float32."""
    f32 = np.float32
    s = {k: f32(params[k]) for k in ("mu", "sigma", "shift_p", "mean_p", "shift_m", "mean_m",
                                     "theta_p", "kappa_p", "beta1_p", "beta2_p", "theta_m",
                                     "kappa_m", "beta1_m", "beta2_m")}
    for side in ("p", "m"):
        comp = np.exp(params[f"shift_{side}"]) / (1.0 - params[f"mean_{side}"]) - 1.0
        s[f"comp_{side}_dt"] = f32(dt * comp)
    s.update(dt=f32(dt), sdt=f32(np.sqrt(dt)), inv_dt=f32(1.0 / dt))
    s["drift_dt"] = (s["mu"] - (f32(0.5) * s["sigma"]) * s["sigma"]) * s["dt"]
    return {k: float(v) for k, v in s.items()}


def euler_step(state, draws, a: Dict[str, float], dtype: torch.dtype):
    """one step from (x, lambda+, lambda-) with the step's float32 uniforms
    ``draws`` (streams 0-5) and scalars ``a``; returns the new state and
    where each side fired."""
    x, lam_p, lam_m = state
    u0, u1, u_up, u_um, u_jp, u_jm = draws
    r = torch.sqrt(torch.clamp(-2.0 * mc._poly_log(u0), min=0.0))
    z = r * mc._poly_cospi(u1)
    fired_p = lam_p > -mc._poly_log(u_up) * a["inv_dt"]
    fired_m = lam_m > -mc._poly_log(u_um) * a["inv_dt"]
    j_p = (a["shift_p"] + -mc._poly_log(u_jp) * a["mean_p"]).to(dtype)
    j_m = (a["shift_m"] - -mc._poly_log(u_jm) * -a["mean_m"]).to(dtype)
    diffusion = (((a["drift_dt"] - a["comp_p_dt"] * lam_p) - a["comp_m_dt"] * lam_m)
                 + a["sigma"] * (z * a["sdt"]).to(dtype))
    jump_p = torch.where(fired_p, j_p, 0.0)
    jump_m = torch.where(fired_m, j_m, 0.0)
    x = ((x + diffusion) + jump_p) + jump_m
    load_p = a["beta1_p"] * jump_p + a["beta2_p"] * jump_m
    load_m = a["beta1_m"] * jump_p + a["beta2_m"] * jump_m
    lam_p = (lam_p + (a["kappa_p"] * (a["theta_p"] - lam_p)) * a["dt"]) + load_p
    lam_m = (lam_m + (a["kappa_m"] * (a["theta_m"] - lam_m)) * a["dt"]) + load_m
    return (x, lam_p, lam_m), (fired_p, fired_m)


def mc_prices(quotes: Dict, params: Dict[str, float], nb_path: int, seed: int, year_steps: int,
              dtype: torch.dtype = torch.float32, payoff_dtype: torch.dtype = torch.float64,
              device="cuda"):
    """MC chain prices and standard errors: the thinning Euler step in
    ``dtype`` on the counter stream, the state (x, lambda+, lambda-) carried
    across maturities from (0, lambda_p, lambda_m)."""

    def advance(seed_i, state, nb_steps, dt):
        a = step_scalars(params, dt)
        draws = Draws(seed_i, state[0].shape[0], state[0].device)
        for step in range(nb_steps):
            uniforms = [draws.uniform(step, stream) for stream in range(6)]
            state, _ = euler_step(state, uniforms, a, dtype)
        return state

    def state0(n):
        f32 = np.float32
        return (torch.zeros(n, dtype=dtype, device=device),
                torch.full((n,), float(f32(params["lambda_p"])), dtype=dtype, device=device),
                torch.full((n,), float(f32(params["lambda_m"])), dtype=dtype, device=device))

    return mc.mc_chain(advance, state0, quotes, nb_path, seed, year_steps, payoff_dtype)
