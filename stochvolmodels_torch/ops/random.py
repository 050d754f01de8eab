"""
Random draws for the eager ('scan') Monte Carlo engine.

The JAX package folds the step index into a threefry key; here each chain
simulation owns an explicit ``torch.Generator`` seeded from the integer seed
(default 24, the reference's global seed) and draws each step's normals from
it in order.  The two packages give different numbers from the same seed.
"""
from __future__ import annotations

from typing import Optional

import torch

DEFAULT_SEED = 24


def generator_from_seed(seed: Optional[int] = None, device="cuda") -> torch.Generator:
    """a generator on ``device`` seeded from ``seed`` (None -> 24)."""
    gen = torch.Generator(device=device)
    gen.manual_seed(DEFAULT_SEED if seed is None else int(seed))
    return gen


def step_normals(gen: torch.Generator, shape, dtype=torch.float64) -> torch.Tensor:
    """standard normals for one time step, drawn from ``gen`` on its device."""
    return torch.randn(shape, generator=gen, dtype=dtype, device=gen.device)


def antithetic_step_normals(gen: torch.Generator, shape, dtype=torch.float64) -> torch.Tensor:
    """one step's normals whose second half of the path axis mirrors the
    first: ``cat([w, -w])`` along the last axis, ``w`` of half width drawn
    from ``gen``, so path i and path i + P/2 see opposite increments."""
    *lead, nb_path = shape
    if nb_path % 2:
        raise ValueError(f"antithetic path count must be even, got {nb_path}")
    w = torch.randn((*lead, nb_path // 2), generator=gen, dtype=dtype, device=gen.device)
    return torch.cat([w, -w], dim=-1)
