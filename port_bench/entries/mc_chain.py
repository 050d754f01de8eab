"""
MC chain pricing: each request prices the whole chain at the
configuration's parameters by the model's MC chain pricer, ``engine='cuda'``,
at the traffic's path count and a seed of its own, and ends with the prices
and standard errors on the host.  Compared with the reference: each
option's price gap in reference standard errors, and its standard error's
relative gap.
"""
from __future__ import annotations

import numpy as np
import torch

from bench_lib import quotes as q
from bench_lib import yardstick

# (path state, payoffs) of the reference, and of each control: one of the
# configuration's precisions (float32 state, float64 payoffs) a step below
REFERENCE_DTYPES = (torch.float32, torch.float64)
CONTROLS = {"bf16_state": (torch.bfloat16, torch.float32),
            "f32_payoffs": (torch.float32, torch.float32)}


def _worst(gap: np.ndarray, scale: np.ndarray) -> float:
    """max gap / scale; where the scale is 0 (an option no path reaches),
    0 if the gap is 0 and inf otherwise."""
    ratio = np.where(scale > 0.0, gap / np.where(scale > 0.0, scale, 1.0),
                     np.where(gap == 0.0, 0.0, np.inf))
    return float(np.max(ratio))


class Entry:
    def __init__(self, cell, seed: int, device, config: dict, traffic: dict):
        self.cell, self.seed, self.device = cell, int(seed), device
        self.config, self.traffic = config, traffic
        self.params = dict(config["params"])
        self.nb_path = int(traffic["nb_path"])
        self.year_steps = int(config["mc"]["year_steps"])
        self.quotes = q.load(cell.bench_dir / config["chain"])
        self.ref = cell.reference()
        self.adapter = None
        self.setup_spans = {}

    def setup(self):
        """the program, the chain, and two warm calls of the cell's shapes."""
        self.adapter = self.cell.model()
        self.program = self.adapter.Program(self.device)
        self.chain = q.option_chain(self.quotes)
        for k in range(2):
            self.call(q.request_seed(self.seed, 1, k))

    def make(self, k: int) -> int:
        return q.request_seed(self.seed, 0, k)

    def call(self, seed_k: int):
        return self.program.mc(self.chain, self.params, self.nb_path, seed_k, self.year_steps)

    def release(self):
        self.program = self.chain = None

    def reference(self, seed_k: int, control: str = None):
        """the reference's answer, or with ``control`` (a name of
        ``CONTROLS``) the control's."""
        dtypes = CONTROLS[control] if control else REFERENCE_DTYPES
        return self.ref.mc_prices(self.quotes, self.params, self.nb_path, seed_k, self.year_steps,
                                  dtype=dtypes[0], payoff_dtype=dtypes[1], device=self.device)

    @staticmethod
    def gaps(out, ref) -> dict:
        """the widest price gap in reference standard errors and the widest
        relative standard-error gap; a NaN anywhere reads inf."""
        p, s = np.concatenate(out[0]), np.concatenate(out[1])
        rp, rs = np.concatenate(ref[0]), np.concatenate(ref[1])
        if p.shape != rp.shape or not (np.all(np.isfinite(p)) and np.all(np.isfinite(s))):
            return dict(price_gap_se=float("inf"), stderr_gap=float("inf"))
        return dict(price_gap_se=_worst(np.abs(p - rp), rs), stderr_gap=_worst(np.abs(s - rs), rs))

    def trace_info(self) -> dict:
        work = yardstick.mc_chain_work(self.adapter.OPS_PER_STEP, self.quotes["ttms"],
                                       [len(k) for k in self.quotes["strikes"]], self.nb_path,
                                       self.year_steps)
        return dict(work, path_kernel=self.adapter.PATH_KERNEL)
