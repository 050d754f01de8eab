"""
Levenberg-Marquardt calibration: each request is a new quote snapshot of
the configuration's chain (bid and ask vols moved by seeded noise) and a
start point jittered from the configuration's, fitted by the model's LM
entry; it ends with the fitted parameters and cost on the host.  Compared
with the reference fit of the same snapshot and start: the widest parameter
gap as a share of its box, and the cost's relative gap.
"""
from __future__ import annotations

import time

import numpy as np
import torch

from bench_lib import quotes as q

CONTROLS = {"float32": torch.float32}   # one step below the configuration's float64


class Entry:
    def __init__(self, cell, seed: int, device, config: dict, traffic: dict):
        self.cell, self.seed, self.device = cell, int(seed), device
        self.config, self.traffic = config, traffic
        self.lm = dict(config["lm"])
        self.quotes = q.load(cell.bench_dir / config["chain"])
        self.ref = cell.reference()
        self.adapter = None
        self.setup_spans = {}

    def _inputs(self, stream: int, k: int):
        g = q.rng(self.seed, stream, k)
        quotes = q.moved(self.quotes, g, float(self.traffic["level_noise_vol"]),
                         float(self.traffic["quote_noise_vol"]))
        return quotes, q.jittered(self.lm["params0"], g, float(self.traffic["start_jitter"]))

    def setup(self):
        """the program, then the first fit (it captures the fit's graph on a
        card; the ``graph_capture_s`` span) and one warm fit."""
        from stochvolmodels_torch.ops import graphs

        self.adapter = self.cell.model()
        self.program = self.adapter.Program(self.device)
        before = graphs.CAPTURES[self.adapter.LM_GRAPH]
        t0 = time.perf_counter()
        self.call(self._inputs(1, 0))
        self.setup_spans["graph_capture_s"] = time.perf_counter() - t0
        self.setup_spans["graph_captures"] = graphs.CAPTURES[self.adapter.LM_GRAPH] - before
        self.call(self._inputs(1, 1))

    def make(self, k: int):
        return self._inputs(0, k)

    def call(self, inputs):
        quotes, params0 = inputs
        return self.program.fit(q.option_chain(quotes), params0, self.lm)

    def release(self):
        self.program = None

    def reference(self, inputs, control: str = None):
        """the reference fit, or with ``control`` (a name of ``CONTROLS``) the
        control's."""
        quotes, params0 = inputs
        return self.ref.fit(quotes, params0, int(self.lm["nb_iters"]),
                            int(self.lm.get("year_steps", 0)),
                            dtype=CONTROLS[control] if control else torch.float64,
                            device=self.device)

    def gaps(self, out, ref) -> dict:
        """the widest fitted-parameter gap over its box width, and the cost's
        relative gap; a NaN reads inf."""
        (p, c), (rp, rc) = out, ref
        if not (np.all(np.isfinite(p)) and np.isfinite(c)):
            return dict(param_gap=float("inf"), cost_gap=float("inf"))
        scale = np.asarray(self.ref.FIT_UPPER) - np.asarray(self.ref.FIT_LOWER)
        return dict(param_gap=float(np.max(np.abs(np.asarray(p) - rp) / scale)),
                    cost_gap=float(abs(c - rc) / rc))

    def trace_info(self) -> dict:
        return {}
