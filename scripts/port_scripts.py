"""Run the repo's example and paper scripts through the PyTorch port and
through the JAX package, and compare what each produced.

The scripts under ``examples/`` and ``papers/`` import
``stochvolmodels_tpu`` (one example imports ``stochvolmodels``).  They are
run unchanged.  Each side runs in a fresh interpreter (``--side``):

* ``port``: a ``sys.meta_path`` finder resolves ``stochvolmodels_tpu`` and
  every ``stochvolmodels_tpu.<path>`` to ``stochvolmodels_torch.<path>``,
  ``stochvolmodels`` goes through ``stochvolmodels_torch.compat.install()``,
  and every ``device`` default of the port that names CUDA is rewritten to
  ``"cpu"`` (through ``__defaults__``/``__kwdefaults__``), so that the run
  asks for the CPU explicitly; a default the walk misses raises on a host
  without CUDA.  At the end, ``sys.modules`` must hold no ``jax`` module
  and no module whose file lies under ``stochvolmodels_tpu/``;
* ``jax``: the scripts as they are, on the JAX package (CPU).

Both sides use matplotlib's Agg backend, a temporary working directory,
``is_save=False`` and the same numpy global seed before every entry.  An
entry is one of a script's own switches: ``run_unit_test(UnitTests.X)`` /
``run_local_test(LocalTests.X)``, ``main()``, or the script run as
``__main__`` (``runpy.run_path``) where its code sits under the guard only.
For each entry a side prints one JSON line: the wall, the numbers of the
return value, the numbers printed, and the data of every open figure (each
line's x/y data, each collection's offsets, each image's array and each
patch's box, in order), after which the figures are closed.

    python scripts/port_scripts.py --all            # every entry, both sides, a table
    python scripts/port_scripts.py --entries NAME ... [--jobs 2]
    python scripts/port_scripts.py --list           # the entries, kinds and tolerances

The card's machine has no matplotlib, seaborn or pandas, so the scripts run
on a CPU host (tests/test_torch_scripts_*.py drive this runner in tier-1).
"""
from __future__ import annotations

import argparse
import ast
import contextlib
import dataclasses
import importlib
import importlib.abc
import importlib.util
import inspect
import io
import json
import math
import os
import pathlib
import re
import signal
import subprocess
import sys
import tempfile
import time
from concurrent.futures import ThreadPoolExecutor
from typing import Dict, List, Optional, Sequence, Tuple

ROOT = pathlib.Path(__file__).resolve().parent.parent
TPU_DIR = ROOT / "stochvolmodels_tpu"
SEED = 11
ENTRY_TIMEOUT_S = 1200
_LQD = "papers/logsv_model_with_quadratic_drift/"

# Tolerances by kind of entry, (rtol, atol) on every number an entry produced:
# |port - jax| <= atol + rtol |jax|, with the same NaN pattern.
TOLERANCES = {
    # float64 analytics on both sides: Fourier prices and ivols, ODE moments,
    # densities, steady-state pdfs
    "analytic": (1e-8, 1e-12),
    # SLSQP fits at scipy's ftol 1e-10 (GMM, Student-t): the parameters are
    # fixed to about sqrt(ftol) of their scale
    "fit": (1e-5, 1e-10),
    # Monte Carlo: the port's counter-hash stream is not threefry.  The MC
    # bands and histograms a script draws are held to 4 combined standard
    # errors (compare's band_z and histograms); the rest as "analytic"
    "mc": (1e-8, 1e-12),
}

# Entries that fail on the JAX package itself (a fault of the script or of
# the reference): the port must fail with the same error.
JAX_FAILS: Dict[str, str] = {
    "papers/sv_for_factor_hjm/calibration_fig_5_6_7.py::PLOT_MKT_MODEL":
        "the script indexes one model vol per tenor into a 9-strike Series (ValueError)",
    **{f"papers/t_distribution/market_data_fit.py::{k}_FIT":
       "the script passes title= twice to plots.vol_slice_fit (TypeError)"
       for k in ("SPY", "GOLD", "BTC")},
}

# Gaps attributed in ROADMAP.md section 3: the artists left out of an entry's
# comparison, and why.
_QVAR_240 = ("the JAX package's Q_VAR transform at its default 240 RK4 steps/yr diverges on the "
             "1m slice (the port defaults to 720; ROADMAP.md section 3)")
_GMM = ("the 12-parameter GMM SLSQP parts from the JAX package's by rounding "
        "(ROADMAP.md section 3): the fits' closeness to the chain is held instead")
_MC_FIT = ("an MC calibration on 5,000 paths: the port's random stream is not threefry, so the "
           "fit moves by its MC noise; the fits' closeness to the chain is held instead")
ATTRIBUTED: Dict[str, Tuple[Tuple, str]] = {
    "examples/run_qvar_analytics.py::run_path": ((("printed", 4, 25),), _QVAR_240),
    _LQD + "article_figures.py::FIGURE10_QVAR": ((18, 19), _QVAR_240),
    "examples/run_gmm_and_tdist_pricers.py::run_path": ((("printed", 0, 36), 0, 6, 12, 18), _GMM),
    "examples/run_lognormal_sv_pricer.py::CALIBRATE_MODEL_TO_BTC_OPTIONS_WITH_MC":
        ((("printed", 0, 6), 0, 6, 12, 18), _MC_FIT),
    # every number these print or draw but the chain's quotes comes from the fit
    "papers/risk_premia_gmm/gmm_slides.py::GMM_SLICE_FITS": (("fit",), _GMM),
    "papers/risk_premia_gmm/run_gmm_fit.py::GMM_FIT": (("fit",), _GMM),
}

# MC histograms of an entry, compared bin by bin: (artists, samples a histogram)
HISTOGRAMS: Dict[str, Tuple[Tuple[int, ...], int]] = {
    _LQD + "article_figures.py::FIGURE6_JOINT_PDF": ((0, 10, 20), 400000)}

# MC entries that print a table of analytic and MC columns: (row width,
# (analytic, MC) column pairs, the print's resolution)
MC_TABLES = {
    "papers/sv_for_factor_hjm/calibration_fig_5_6_7.py::BENCHMARK_ANALYTIC_VS_MC":
        (7, ((1, 2), (3, 4), (5, 6)), 0.1),
    "papers/sv_for_factor_hjm/calibration_fig_8_9.py::BENCHMARK_ANALYTIC_VS_MC_FUT":
        (4, ((2, 3),), 0.1),
}

# entries whose fit parts from the JAX one's (ATTRIBUTED): the fit's closeness
# to the chain (mean |model vol - mid|) and each optimizer call's final
# objective are compared instead, each held to the JAX run's times (1 +
# margin): (fit-error margin, objective margin).  The GMM SLSQP fits are
# deterministic on both sides and part by rounding only: the port's fit
# errors measured 0.958-0.998 of the JAX ones, its 12 GMM objectives
# 0.36-1.056 of theirs (PERF.md section 6).  The MC fit's margins are 4
# combined standard deviations of the two sides over 8 seeds, over the JAX
# mean: 0.990 and 4.844 (scripts/fit_quality_spread.py), rounded up.
FIT_QUALITY: Dict[str, Tuple[float, float]] = {
    "examples/run_gmm_and_tdist_pricers.py::run_path": (0.05, 0.10),
    "examples/run_lognormal_sv_pricer.py::CALIBRATE_MODEL_TO_BTC_OPTIONS_WITH_MC": (1.0, 4.9),
    "papers/risk_premia_gmm/gmm_slides.py::GMM_SLICE_FITS": (0.05, 0.10),
    "papers/risk_premia_gmm/run_gmm_fit.py::GMM_FIT": (0.05, 0.10),
}

# MC entries whose bands are not 1.96 standard errors wide on each side
BAND_Z: Dict[str, float] = {   # plot_qvar_vs_mc draws +/- 2 x 1.96 standard errors
    _LQD + n: 3.92 for n in ("moments_vol_qvar.py::EXPECTED_VOL_VS_MC",
                             "moments_vol_qvar.py::EXPECTED_QVAR_VS_MC",
                             "moments_vol_qvar.py::JOINT_FIGURE",
                             "article_figures.py::FIGURE3_QVAR_EXP")}

# entries whose two sides together take over ~20 s on one CPU core: the
# slow-marked test cases, with their walls (port s, JAX s) from
# `port_scripts.py --all --jobs 4` on an 8-core host (PERF.md §6)
SLOW: Dict[str, Tuple[float, float]] = {
    "examples/run_gmm_and_tdist_pricers.py::run_path": (173.7, 51.3),
    "examples/run_hawkes_pricer.py::BTC_CHAIN_FIT": (5.1, 23.9),
    "examples/run_heston_sv_pricer.py::CALIBRATOR": (10.6, 18.4),
    "examples/run_heston_sv_pricer.py::HESTON_WALKTHROUGH": (8.0, 33.7),
    "examples/run_heston_sv_pricer.py::MC_COMPARISON": (5.9, 20.4),
    "examples/run_lognormal_sv_pricer.py::BENCHM_ROUGH_PRICER": (3.3, 22.2),
    "examples/run_lognormal_sv_pricer.py::CALIBRATE_MODEL_TO_BTC_OPTIONS": (55.1, 51.1),
    "examples/run_lognormal_sv_pricer.py::CALIBRATE_MODEL_TO_BTC_OPTIONS_WITH_MC": (40.6, 34.6),
    "examples/run_lognormal_sv_pricer.py::COMPARE_MODEL_VOLS_TO_MC": (8.4, 21.2),
    "examples/run_pricing_options_on_qvar.py::QVAR_OPTIONS": (21.8, 46.1),
    "examples/run_qvar_analytics.py::run_path": (43.2, 15.7),
    "papers/forward_var/calibrate_forward_var.py::CALIBRATE_4PARAM_MODEL": (83.4, 75.5),
    "papers/forward_var/calibrate_forward_var.py::CALIBRATE_VARSWAP_PARAM_MODEL": (51.4, 68.7),
    "papers/forward_var/calibrate_forward_var.py::COMPARE_MODEL_VOLS_TO_MC": (9.8, 32.4),
    "papers/forward_var/calibrate_forward_var.py::VARSWAP_FIT": (5.6, 25.3),
    "papers/il_hedging/logsv_figures.py::PLOT_SKEWS": (6.3, 18.4),
    "papers/logsv_model_with_quadratic_drift/article_figures.py::FIGURE10_QVAR": (20.3, 30.7),
    "papers/logsv_model_with_quadratic_drift/article_figures.py::FIGURE2_VOL_MOMENTS": (81.2, 81.9),
    "papers/logsv_model_with_quadratic_drift/article_figures.py::FIGURE3_QVAR_EXP": (129.3, 106.2),
    "papers/logsv_model_with_quadratic_drift/article_figures.py::FIGURE4_FIRST_ORDER": (2.7, 70.0),
    "papers/logsv_model_with_quadratic_drift/article_figures.py::FIGURE5_SECOND_ORDER": (4.0, 37.4),
    "papers/logsv_model_with_quadratic_drift/article_figures.py::FIGURE6_JOINT_PDF": (138.0, 94.8),
    "papers/logsv_model_with_quadratic_drift/article_figures.py::FIGURE8_9_FITTED_MODEL": (13.1, 28.3),
    "papers/logsv_model_with_quadratic_drift/calibrations.py::CALIBRATION": (64.6, 60.7),
    "papers/logsv_model_with_quadratic_drift/calibrations.py::MODEL_COMPARISON_WITH_MC": (5.5, 20.5),
    "papers/logsv_model_with_quadratic_drift/model_fit_to_options_timeseries.py::SINGLE_FIT": (52.1, 63.3),
    "papers/logsv_model_with_quadratic_drift/moments_vol_qvar.py::EXPECTED_QVAR_VS_MC": (30.4, 29.6),
    "papers/logsv_model_with_quadratic_drift/moments_vol_qvar.py::EXPECTED_VOL_VS_MC": (23.4, 22.4),
    "papers/logsv_model_with_quadratic_drift/moments_vol_qvar.py::JOINT_FIGURE": (45.4, 35.4),
    "papers/logsv_model_with_quadratic_drift/moments_vol_qvar.py::VOL_MOMENTS_VS_MC": (43.2, 46.0),
    "papers/logsv_model_with_quadratic_drift/ode_sol_in_time.py::FIRST_ORDER": (2.9, 32.4),
    "papers/logsv_model_with_quadratic_drift/ode_sol_in_time.py::SECOND_ORDER": (3.1, 35.1),
    "papers/risk_premia_gmm/gmm_slides.py::GMM_SLICE_FITS": (246.4, 33.7),
    "papers/risk_premia_gmm/run_gmm_fit.py::GMM_FIT": (45.1, 23.5),
    "papers/sv_for_factor_hjm/calibration_fig_5_6_7.py::BENCHMARK_ANALYTIC_VS_MC": (18.7, 73.0),
    "papers/sv_for_factor_hjm/calibration_fig_5_6_7.py::PLOT_MKT_MODEL": (13.4, 71.0),
    "papers/sv_for_factor_hjm/calibration_fig_8_9.py::BENCHMARK_ANALYTIC_VS_MC_FUT": (6.3, 40.1),
    "papers/sv_for_factor_hjm/calibration_fig_8_9.py::CALIBRATE_LOGSV_FUT": (5.9, 51.7),
    "papers/t_distribution/illustrations.py::PLOT_IMPLIED_DRIFT_FORWARD_DEFAULTPROB": (27.6, 9.1),
    "papers/t_distribution/market_data_fit.py::BTC_FIT": (80.8, 23.0),
    "papers/t_distribution/market_data_fit.py::GOLD_FIT": (37.3, 23.2),
    "papers/t_distribution/market_data_fit.py::SPY_FIT": (30.5, 23.9),
    "papers/volatility_models/article_figures.py::AUTOCORRS": (10.3, 13.7),
    "papers/volatility_models/autocorr_fit.py::FIT_AUTOCORR_LOGSV": (38.8, 45.3),
    "papers/volatility_models/autocorr_fit.py::FIT_REPORT": (14.0, 15.9),
}

# Scripts that cannot run on the port unchanged, with the reason.
OUT_OF_REACH = {
    "examples/run_factor_hjm_swaptions.py": "calls jax.numpy in its own code (jnp.asarray)",
    "examples/run_tpu_fast_paths.py": "calls jax in its own code (jax.devices, Pallas paths)",
    "papers/t_distribution/mc_pricer_with_kernel.py": "calls jax and jax.numpy in its own code",
    "papers/sv_for_factor_hjm/cube_calibration.py": "calls jax.numpy in its own code",
    "examples/run_bsm_mgf_pricer.py":
        "uses the TPU-only pair type stochvolmodels_tpu.utils.cplx.Cplx (not ported by design)",
    "papers/il_hedging/run_logsv_for_il_payoff.py":
        "uses the TPU-only pair type stochvolmodels_tpu.utils.cplx.Cplx (not ported by design)",
}

# Entries that need data or an optional package that the repo does not have.
NOT_RUN = {
    "papers/logsv_model_with_quadratic_drift/model_fit_to_options_timeseries.py::TIME_SERIES":
        "needs option-chain-analytics time-series data that the repo does not hold",
}

# Modules that import neither package: imported through the redirect, no entry.
NEITHER = ("papers/local_path.py", "papers/risk_premia_gmm/check_kernel.py",
           "papers/volatility_models/load_data.py", "papers/volatility_models/vol_beta.py")

# Scripts whose code sits under ``if __name__ == "__main__"`` only.
RUN_AS_MAIN = ("examples/quick_run_lognormal_sv_pricer.py",
               "examples/run_gmm_and_tdist_pricers.py", "examples/run_qvar_analytics.py",
               "examples/run_rough_kernel_approx.py", "papers/risk_premia_gmm/plot_gmm.py")

_MC = ("examples/run_heston_sv_pricer.py::MC_COMPARISON",
       "examples/run_lognormal_sv_pricer.py::COMPARE_MODEL_VOLS_TO_MC",
       "examples/run_pricing_options_on_qvar.py::QVAR_OPTIONS",
       "papers/forward_var/calibrate_forward_var.py::COMPARE_MODEL_VOLS_TO_MC",
       _LQD + "article_figures.py::FIGURE2_VOL_MOMENTS", _LQD + "article_figures.py::FIGURE3_QVAR_EXP",
       _LQD + "article_figures.py::FIGURE6_JOINT_PDF",
       _LQD + "article_figures.py::FIGURE8_9_FITTED_MODEL", _LQD + "article_figures.py::FIGURE10_QVAR",
       _LQD + "calibrations.py::MODEL_COMPARISON_WITH_MC",
       _LQD + "model_fit_to_options_timeseries.py::SINGLE_FIT",
       _LQD + "moments_vol_qvar.py::VOL_MOMENTS_VS_MC", _LQD + "moments_vol_qvar.py::EXPECTED_VOL_VS_MC",
       _LQD + "moments_vol_qvar.py::EXPECTED_QVAR_VS_MC", _LQD + "moments_vol_qvar.py::JOINT_FIGURE",
       "papers/sv_for_factor_hjm/calibration_fig_5_6_7.py::BENCHMARK_ANALYTIC_VS_MC",
       "papers/sv_for_factor_hjm/calibration_fig_8_9.py::BENCHMARK_ANALYTIC_VS_MC_FUT",
       "examples/run_lognormal_sv_pricer.py::CALIBRATE_MODEL_TO_BTC_OPTIONS_WITH_MC")
_FIT = ("examples/run_gmm_and_tdist_pricers.py::run_path",
        "papers/risk_premia_gmm/gmm_slides.py::GMM_SLICE_FITS",
        "papers/risk_premia_gmm/gmm_slides.py::RISK_PREMIA_PDFS",
        "papers/risk_premia_gmm/run_gmm_fit.py::GMM_FIT",
        "papers/t_distribution/market_data_fit.py::SPY_FIT",
        "papers/t_distribution/market_data_fit.py::GOLD_FIT",
        "papers/t_distribution/market_data_fit.py::BTC_FIT")
# kind of every entry that is not "analytic", by entry name (file::switch)
KINDS: Dict[str, str] = {**{n: "mc" for n in _MC}, **{n: "fit" for n in _FIT}}


@dataclasses.dataclass(frozen=True)
class Entry:
    """one switch of one script: ``call`` is ``unit:X``, ``local:X``,
    ``main`` or ``run_path``."""
    path: str
    call: str

    @property
    def name(self) -> str:
        return f"{self.path}::{self.call.split(':')[-1]}"

    @property
    def module(self) -> str:
        return self.path[:-3].replace("/", ".")

    @property
    def kind(self) -> str:
        return KINDS.get(self.name, "analytic")


def script_paths() -> List[str]:
    """every example and paper module, relative to the repo root."""
    return sorted(str(p.relative_to(ROOT)) for p in
                  list((ROOT / "examples").glob("*.py")) + list((ROOT / "papers").rglob("*.py")))


def in_reach_modules() -> List[str]:
    return [p for p in script_paths() if p not in OUT_OF_REACH]


def _switches(path: str) -> List[str]:
    """the entries a script offers: the members of its UnitTests/LocalTests
    enum, its main(), or the script as __main__."""
    if path in RUN_AS_MAIN:
        return ["run_path"]
    tree = ast.parse((ROOT / path).read_text())
    calls = []
    for node in tree.body:
        if isinstance(node, ast.ClassDef) and node.name in ("UnitTests", "LocalTests"):
            prefix = "unit" if node.name == "UnitTests" else "local"
            calls += [f"{prefix}:{t.id}" for stmt in node.body if isinstance(stmt, ast.Assign)
                      for t in stmt.targets if isinstance(t, ast.Name)]
        elif isinstance(node, ast.FunctionDef) and node.name == "main":
            calls.append("main")
    return calls


def entries() -> List[Entry]:
    """every in-reach entry, in file order (NOT_RUN ones left out)."""
    out = []
    for path in in_reach_modules():
        if path in NEITHER:
            continue
        out += [Entry(path, c) for c in _switches(path)]
    return [e for e in out if e.name not in NOT_RUN]


# ---------------------------------------------------------------------------
# the port side: redirect and CPU defaults
# ---------------------------------------------------------------------------

class _Alias(importlib.abc.MetaPathFinder, importlib.abc.Loader):
    """resolves ``stochvolmodels_tpu[.path]`` to ``stochvolmodels_torch[.path]``:
    the alias name is bound to the port's module object."""

    SOURCE, TARGET = "stochvolmodels_tpu", "stochvolmodels_torch"

    def find_spec(self, name, path, target=None):
        if name != self.SOURCE and not name.startswith(self.SOURCE + "."):
            return None
        real = self.TARGET + name[len(self.SOURCE):]
        if importlib.util.find_spec(real) is None:
            raise ModuleNotFoundError(f"the port has no module {real} (for {name})", name=name)
        return importlib.util.spec_from_loader(name, self, is_package=True)

    def create_module(self, spec):
        return importlib.import_module(self.TARGET + spec.name[len(self.SOURCE):])

    def exec_module(self, module):
        pass


def _device_default_is_cuda(value) -> bool:
    import torch

    try:
        return value is not None and torch.device(value).type == "cuda"
    except (TypeError, RuntimeError):
        return False


def port_callables() -> Dict[str, object]:
    """every function, class method and ``__init__`` defined in the port's
    modules, private ones included (the walk of
    tests/test_torch_device.py::public_callables without its filter)."""
    import pkgutil

    import stochvolmodels_torch

    found = {}
    for info in pkgutil.walk_packages(stochvolmodels_torch.__path__,
                                      prefix="stochvolmodels_torch."):
        module = importlib.import_module(info.name)
        for name, obj in vars(module).items():
            if getattr(obj, "__module__", None) != module.__name__:
                continue
            if inspect.isfunction(obj):
                found[f"{module.__name__}.{name}"] = obj
            elif inspect.isclass(obj):
                for attr, member in vars(obj).items():
                    member = getattr(member, "__func__", member)
                    if inspect.isfunction(member):
                        found[f"{module.__name__}.{name}.{attr}"] = member
    return found


def cuda_defaults(found: Dict[str, object]) -> List[str]:
    """the callables whose ``device`` default names a CUDA device."""
    out = []
    for name, fn in found.items():
        param = inspect.signature(fn).parameters.get("device")
        if param is not None and _device_default_is_cuda(param.default):
            out.append(name)
    return out


def rewrite_device_defaults_to_cpu() -> int:
    """set every CUDA ``device`` default of the port to ``"cpu"``; returns
    how many were rewritten and asserts that none is left."""
    found = port_callables()
    names = cuda_defaults(found)
    for name in names:
        fn = found[name]
        code = fn.__code__
        pos = code.co_varnames[:code.co_argcount]
        if "device" in pos and fn.__defaults__:
            i = pos.index("device") - (len(pos) - len(fn.__defaults__))
            defaults = list(fn.__defaults__)
            defaults[i] = "cpu"
            fn.__defaults__ = tuple(defaults)
        else:
            fn.__kwdefaults__ = dict(fn.__kwdefaults__, device="cpu")
    left = cuda_defaults(port_callables())
    assert not left, f"CUDA device defaults left: {left}"
    return len(names)


def install_port() -> int:
    """the redirect, the compat module and the CPU defaults (port side)."""
    sys.meta_path.insert(0, _Alias())
    import stochvolmodels_torch.compat as compat

    compat.install()
    return rewrite_device_defaults_to_cpu()


def foreign_modules() -> List[str]:
    """modules that the port side must never load: jax, and any module
    whose file lies under stochvolmodels_tpu/."""
    bad = []
    for name, mod in list(sys.modules.items()):
        if mod is None:
            continue
        if name.split(".")[0] in ("jax", "jaxlib"):
            bad.append(name)
            continue
        file = getattr(mod, "__file__", None)
        if file and pathlib.Path(file).resolve().is_relative_to(TPU_DIR):
            bad.append(name)
    return bad


# ---------------------------------------------------------------------------
# capturing what an entry produced
# ---------------------------------------------------------------------------

_NUMBER = re.compile(r"(?<![\w.])[-+]?(?:\d+\.\d*|\.\d+|\d+)(?:[eE][-+]?\d+)?(?![\w.])|"
                     r"(?<![\w.])[-+]?(?:nan|inf)(?![\w.])", re.IGNORECASE)


# a line that reports a wall clock (the package's timer prints "Finished 'f' in 1.2 secs")
_TIMING = re.compile(r"\bsecs?\b|\bseconds\b|\belapsed\b", re.IGNORECASE)


def printed_numbers(text: str) -> List[float]:
    """the numbers printed, in order, leaving out the lines that report a
    wall clock."""
    return [float(m) for line in text.splitlines() if not _TIMING.search(line)
            for m in _NUMBER.findall(line)]


def numbers_of(obj, depth: int = 0) -> List[float]:
    """the numbers of a return value, flattened in order: arrays, tensors,
    pandas objects, scalars, sequences, dicts and dataclasses."""
    import numpy as np

    if depth > 6 or obj is None or isinstance(obj, (str, bytes)):
        return []
    if isinstance(obj, bool):
        return [float(obj)]
    if isinstance(obj, (int, float, np.number)):
        return [float(obj)]
    if hasattr(obj, "detach") and hasattr(obj, "cpu"):   # a tensor
        obj = obj.detach().cpu().numpy()
    if hasattr(obj, "to_numpy") and hasattr(obj, "index"):   # pandas
        try:
            obj = obj.to_numpy(dtype=float)
        except (TypeError, ValueError):
            obj = obj.to_numpy()
    if isinstance(obj, np.ndarray):
        if obj.dtype.kind in "fiub":
            return [float(x) for x in obj.ravel()]
        if obj.dtype.kind == "c":
            return [float(v) for x in obj.ravel() for v in (x.real, x.imag)]
        if obj.dtype == object:
            return [v for x in obj.ravel() for v in numbers_of(x, depth + 1)]
        return []
    if isinstance(obj, dict):
        return [v for key in obj for v in numbers_of(obj[key], depth + 1)]
    if isinstance(obj, (list, tuple)):
        return [v for x in obj for v in numbers_of(x, depth + 1)]
    if dataclasses.is_dataclass(obj) and not isinstance(obj, type):
        return [v for f in dataclasses.fields(obj)
                for v in numbers_of(getattr(obj, f.name), depth + 1)]
    return []


def figure_data() -> List[List[float]]:
    """the data of every open figure, in order, one list per artist: each
    line's (x, y) pairs, each collection's offsets, each image's array,
    each patch's box."""
    import matplotlib.pyplot as plt
    import numpy as np

    out = []
    for num in plt.get_fignums():
        for ax in plt.figure(num).axes:
            for line in ax.get_lines():   # (x, y) as drawn: dates and periods as numbers
                out.append(numbers_of(np.asarray(line.get_xydata(), dtype=float)))
            for coll in ax.collections:
                offsets = np.asarray(coll.get_offsets(), dtype=float)
                if offsets.size:
                    out.append(numbers_of(offsets))
            for image in ax.images:
                out.append(numbers_of(np.asarray(image.get_array(), dtype=float)))
            for patch in ax.patches:
                if hasattr(patch, "get_height"):
                    out.append([float(patch.get_x()), float(patch.get_y()),
                                float(patch.get_width()), float(patch.get_height())])
    plt.close("all")
    return out


# the objective each scipy.optimize.minimize call of the running entry ended at
OBJECTIVES: List[float] = []


def record_objectives() -> None:
    """wrap ``scipy.optimize.minimize``, before either package imports it,
    so that each call's final objective (``res.fun``) is kept for the entry
    that made it; the call itself is unchanged."""
    import numpy as np
    import scipy.optimize

    plain = scipy.optimize.minimize

    def minimize(*args, **kwargs):
        res = plain(*args, **kwargs)
        OBJECTIVES.append(float(np.asarray(res.fun, dtype=float).ravel()[0]))
        return res

    scipy.optimize.minimize = minimize


class _EntryTimeout(Exception):
    pass


def run_entry(entry: Entry) -> dict:
    """run one entry in this process; the record of what it produced."""
    import matplotlib.pyplot as plt
    import numpy as np

    plt.close("all")
    np.random.seed(SEED)
    OBJECTIVES.clear()
    rec = dict(entry=entry.name)
    out = io.StringIO()

    def on_alarm(signum, frame):
        raise _EntryTimeout(f"entry ran past {ENTRY_TIMEOUT_S} s")

    old = signal.signal(signal.SIGALRM, on_alarm)
    signal.alarm(ENTRY_TIMEOUT_S)
    t0 = time.perf_counter()
    try:
        with contextlib.redirect_stdout(out):
            if entry.call == "run_path":
                import runpy

                runpy.run_path(str(ROOT / entry.path), run_name="__main__")
                ret = None
            else:
                module = importlib.import_module(entry.module)
                if entry.call == "main":
                    ret = module.main()
                else:
                    kind, member = entry.call.split(":")
                    enum = module.UnitTests if kind == "unit" else module.LocalTests
                    runner = module.run_unit_test if kind == "unit" else module.run_local_test
                    ret = runner(getattr(enum, member))
        rec.update(ok=True, returned=numbers_of(ret))
    except Exception as exc:  # noqa: BLE001 - a script's failure is recorded and compared
        rec.update(ok=False, error=f"{type(exc).__name__}: {exc}"[:2000])
    finally:
        signal.alarm(0)
        signal.signal(signal.SIGALRM, old)
    rec["wall_s"] = time.perf_counter() - t0
    rec["printed"] = printed_numbers(out.getvalue())
    rec["text"] = out.getvalue()[-3000:]
    rec["objectives"] = list(OBJECTIVES)
    rec["figures"] = figure_data()
    return rec


def run_side(side: str, names: Sequence[str], imports: Sequence[str] = ()) -> None:
    """the child process of one side: prints a JSON line per import and per
    entry, and a last line with the port side's checks."""
    import matplotlib

    matplotlib.use("Agg")
    sys.path.insert(0, str(ROOT))
    record_objectives()
    if side == "port":
        import torch

        torch.set_num_threads(1)   # as the tests' workers run it; the JAX side: XLA_FLAGS
    rewritten = install_port() if side == "port" else 0
    if side == "jax":
        import jax

        jax.config.update("jax_platforms", "cpu")
    by_name = {e.name: e for e in entries()}
    with tempfile.TemporaryDirectory(prefix=f"scripts_{side}_") as work:
        os.chdir(work)
        for path in imports:
            t0 = time.perf_counter()
            try:
                importlib.import_module(path[:-3].replace("/", "."))
                rec = dict(imported=path, ok=True)
            except Exception as exc:  # noqa: BLE001 - a failed import is recorded and reported
                rec = dict(imported=path, ok=False, error=f"{type(exc).__name__}: {exc}"[:2000])
            rec["wall_s"] = time.perf_counter() - t0
            if side == "port":
                rec["foreign"] = foreign_modules()
            print(json.dumps(rec), flush=True)
        for name in names:
            rec = run_entry(by_name[name])
            if side == "port":
                rec["foreign"] = foreign_modules()
            print(json.dumps(rec), flush=True)
        os.chdir(ROOT)
    print(json.dumps(dict(done=side, rewritten=rewritten,
                          foreign=foreign_modules() if side == "port" else [])), flush=True)


def spawn_side(side: str, names: Sequence[str], imports: Sequence[str] = (),
               timeout: Optional[float] = None) -> Dict[str, dict]:
    """run one side in a fresh interpreter; its records by entry name (and
    by ``import:<path>``), plus ``"__done__"``."""
    env = dict(os.environ, PYTHONPATH=str(ROOT), MPLBACKEND="Agg", OMP_NUM_THREADS="1",
               MKL_NUM_THREADS="1", OPENBLAS_NUM_THREADS="1")
    if side == "jax":
        env.update(JAX_PLATFORMS="cpu", XLA_FLAGS="--xla_cpu_multi_thread_eigen=false "
                                                  "intra_op_parallelism_threads=1")
    cmd = [sys.executable, str(ROOT / "scripts" / "port_scripts.py"), "--side", side,
           "--entries", *names, "--imports", *imports]
    try:
        proc = subprocess.run(cmd, capture_output=True, text=True, env=env, timeout=timeout,
                              cwd=str(ROOT))
        stdout, stderr, rc = proc.stdout, proc.stderr, proc.returncode
    except subprocess.TimeoutExpired as exc:
        stdout = exc.stdout.decode() if isinstance(exc.stdout, bytes) else (exc.stdout or "")
        stderr, rc = f"the {side} side ran past {timeout} s", None
    recs = {}
    for line in stdout.splitlines():
        if not line.startswith("{"):
            continue
        rec = json.loads(line)
        key = rec.get("entry") or (f"import:{rec['imported']}" if "imported" in rec
                                   else "__done__")
        recs[key] = rec
    if "__done__" not in recs:
        recs["__done__"] = dict(done=None, error=stderr[-4000:], rc=rc)
    return recs


def _is_band(figs: List[List[float]], i: int) -> bool:
    """(i, i + 1) are the lower and upper edge of a band: (x, y) pairs at
    the same x, the upper y at or above the lower everywhere and above it
    somewhere (the MC vols at -/+1.96 standard errors that
    ``plot_model_ivols_vs_mc`` draws, the caps of an ``errorbar``, or a
    chain's bid and ask vols)."""
    lo, hi = figs[i], figs[i + 1]
    if len(lo) != len(hi) or len(lo) < 2 or len(lo) % 2 or lo[0::2] != hi[0::2]:
        return False
    pairs = [(a, b) for a, b in zip(lo[1::2], hi[1::2]) if not (math.isnan(a) or math.isnan(b))]
    return bool(pairs) and all(b >= a for a, b in pairs) and any(b > a for a, b in pairs)


def _is_center(figs: List[List[float]], i: int) -> bool:
    """artist i is the midpoint line of the band (i + 1, i + 2) (an
    errorbar's data line)."""
    if i < 0 or len(figs[i]) != len(figs[i + 1]) or figs[i][0::2] != figs[i + 1][0::2]:
        return False
    return all(math.isclose(c, (a + b) / 2.0, rel_tol=1e-9, abs_tol=1e-12)
               for c, a, b in zip(figs[i][1::2], figs[i + 1][1::2], figs[i + 2][1::2])
               if not math.isnan(c))


def _band_pairs(port_figs: List[List[float]], ref_figs: List[List[float]]) -> List[int]:
    """the artists i where (i, i + 1) is a band on both sides."""
    out, i = [], 0
    while i + 1 < min(len(port_figs), len(ref_figs)):
        if _is_band(port_figs, i) and _is_band(ref_figs, i):
            out.append(i)
            i += 2
        else:
            i += 1
    return out


def _band_stderrs(lo: List[float], hi: List[float], z: float) -> List[float]:
    """each x's standard error, the band's half-width over ``z``; where an
    edge is NaN (a price under its bound has no vol), the nearest x's."""
    own = [(b - a) / (2.0 * z) if not (math.isnan(a) or math.isnan(b)) else math.nan
           for a, b in zip(lo[1::2], hi[1::2])]
    full = [k for k, e in enumerate(own) if not math.isnan(e)]
    return [e if not math.isnan(e) else
            (own[min(full, key=lambda j: abs(j - k))] if full else math.nan)
            for k, e in enumerate(own)]


def _band_gaps(port_lo, port_hi, ref_lo, ref_hi, z: float) -> List[float]:
    """per x of one MC band, the gap between the two sides over 4 combined
    standard errors: of the midpoints, or of the one finite edge where the
    other is NaN on both sides; inf where the NaN patterns differ."""
    ratios = []
    sp, sr = _band_stderrs(port_lo, port_hi, z), _band_stderrs(ref_lo, ref_hi, z)
    for k, (pl, ph, rl, rh) in enumerate(zip(port_lo[1::2], port_hi[1::2], ref_lo[1::2],
                                             ref_hi[1::2])):
        nan_p, nan_r = (math.isnan(pl), math.isnan(ph)), (math.isnan(rl), math.isnan(rh))
        if nan_p != nan_r:
            ratios.append(math.inf)
            continue
        if all(nan_p):
            continue
        a, b = ((pl + ph) / 2.0, (rl + rh) / 2.0) if not any(nan_p) else \
            ((ph, rh) if nan_p[0] else (pl, rl))
        stderr = math.hypot(sp[k], sr[k])
        gap = abs(a - b)
        ratios.append(gap / (4.0 * stderr) if stderr > 0 else (0.0 if gap == 0 else math.inf))
    return ratios


def _histogram_gaps(a: List[float], b: List[float], n: int) -> List[float]:
    """per bin of an MC histogram of ``n`` samples drawn as (x, frequency)
    pairs, the gap between the frequencies over 4 combined binomial
    standard errors."""
    out = []
    for fp, fr in zip(a[1::2], b[1::2]):
        stderr = math.sqrt((abs(fp) * (1 - abs(fp)) + abs(fr) * (1 - abs(fr))) / n)
        gap = abs(fp - fr)
        out.append(gap / (4.0 * stderr) if stderr > 0 else (0.0 if gap == 0 else math.inf))
    return out


def _fit_error(figs: List[List[float]], bands: List[int]) -> float:
    """the mean |model vol - mid| over the bands (a chain's bid and ask
    vols) of the figures, the model being the closest artist before each
    band drawn on the band's x values."""
    errs = []
    for i in bands:
        xs = figs[i][0::2]
        model = next((figs[j] for j in range(i - 1, -1, -1) if figs[j][0::2] == xs), None)
        if model is None:
            continue
        errs += [abs(m - (a + b) / 2.0) for m, a, b in zip(model[1::2], figs[i][1::2],
                                                           figs[i + 1][1::2])
                 if not any(math.isnan(v) for v in (m, a, b))]
    return sum(errs) / len(errs) if errs else math.nan


def _table_gaps(port: List[float], ref: List[float], width: int,
                pairs: Sequence[Tuple[int, int]], resolution: float) -> List[float]:
    """a printed table of rows of ``width`` numbers whose ``pairs`` are
    (analytic column, MC column): per MC number, the port's |MC - analytic|
    over the JAX run's largest |MC - analytic| in that column plus the
    print's ``resolution`` (the script's own band)."""
    rows_p = [port[k:k + width] for k in range(0, len(port), width)]
    rows_r = [ref[k:k + width] for k in range(0, len(ref), width)]
    out = []
    for de, mc in pairs:
        band = max(abs(r[mc] - r[de]) for r in rows_r) + resolution
        out += [abs(r[mc] - r[de]) / band for r in rows_p]
    return out


def compare(port: dict, ref: dict, tol: Tuple[float, float],
            band_z: Optional[float] = None, skip: Sequence = (),
            histograms: Tuple[Sequence[int], int] = ((), 0), table=None) -> dict:
    """the port's record against the JAX one's under ``tol``: the same
    number of figures, artists and numbers, the same NaN pattern, and every
    gap within atol + rtol |jax|.

    With ``band_z``, each band of the figures (:func:`_band_pairs`, its
    half-width ``band_z`` standard errors: an MC band), its midpoint line
    and the point drawn right after it (an ``(x, y)`` ATM point, the MC
    mid at the forward) are held instead to 4 combined standard errors
    between the two sides.  The artists ``histograms[0]`` are MC histograms
    of ``histograms[1]`` samples, held to 4 combined binomial standard
    errors.  ``skip`` leaves out artists (ints) and ``("printed", start,
    stop)`` ranges of the printed numbers; ``"fit"`` in ``skip`` leaves out
    everything but the chain's quotes (the bands).  ``table`` (width, pairs,
    resolution) reads the printed numbers as a table of analytic and MC
    columns (:func:`_table_gaps`); its MC columns are held to the script's
    own band, the rest as above.  Returns ok (both runs ended
    without error), the worst ratio of gap to tolerance, the worst relative
    gap, and the first mismatches."""
    rtol, atol = tol
    worst, worst_rel, problems = 0.0, 0.0, []
    printed_p, printed_r = list(port.get("printed", [])), list(ref.get("printed", []))
    for item in skip:
        if isinstance(item, tuple) and item[0] == "printed":
            printed_p[item[1]:item[2]] = printed_r[item[1]:item[2]] = []
    fit_only = "fit" in skip
    if fit_only:
        printed_p, printed_r = [], []
    if table and len(printed_p) == len(printed_r) and len(printed_r) % table[0] == 0:
        worst = max([worst] + _table_gaps(printed_p, printed_r, *table))
        mc_cols = {mc for _, mc in table[1]}
        keep = [k for k in range(len(printed_r)) if k % table[0] not in mc_cols]
        printed_p, printed_r = [printed_p[k] for k in keep], [printed_r[k] for k in keep]
    parts = [("returned", port.get("returned", []), ref.get("returned", [])),
             ("printed", printed_p, printed_r)]
    pf, rf = port.get("figures", []), ref.get("figures", [])
    if len(pf) != len(rf):
        problems.append(f"figures: {len(pf)} artists against {len(rf)}")
    bands = _band_pairs(pf, rf) if band_z else []
    handled = set()
    for i in bands:
        for r in _band_gaps(pf[i], pf[i + 1], rf[i], rf[i + 1], band_z):
            worst = max(worst, r)
        parts.append((f"band {i} x", pf[i][0::2], rf[i][0::2]))
        handled |= {i, i + 1}
        if _is_center(pf, i - 1) and _is_center(rf, i - 1):
            handled.add(i - 1)
        atm = i + 2
        if atm < min(len(pf), len(rf)) and len(pf[atm]) == len(rf[atm]) == 2:
            stderr = max(math.hypot(a, b) for a, b in zip(
                _band_stderrs(pf[i], pf[i + 1], band_z), _band_stderrs(rf[i], rf[i + 1], band_z))
                if not (math.isnan(a) or math.isnan(b)))
            gap = abs(pf[atm][1] - rf[atm][1])
            worst = max(worst, gap / (4.0 * stderr) if stderr > 0 else (0.0 if gap == 0 else math.inf))
            parts.append((f"atm {atm} x", pf[atm][:1], rf[atm][:1]))
            handled.add(atm)
    for i in histograms[0]:
        if i < min(len(pf), len(rf)) and len(pf[i]) == len(rf[i]):
            worst = max([worst] + _histogram_gaps(pf[i], rf[i], histograms[1]))
            parts.append((f"histogram {i} x", pf[i][0::2], rf[i][0::2]))
            handled.add(i)
    if fit_only:   # only the chain's quotes (the bands) are compared
        quotes = {j for i in _band_pairs(pf, rf) for j in (i, i + 1)}
        handled |= set(range(len(rf))) - quotes
    parts += [(f"artist {i}", a, b) for i, (a, b) in enumerate(zip(pf, rf))
              if i not in handled and i not in skip]
    for label, a, b in parts:
        if len(a) != len(b):
            problems.append(f"{label}: {len(a)} numbers against {len(b)}")
            continue
        for x, y in zip(a, b):
            if math.isnan(y) or math.isnan(x):
                if not (math.isnan(x) and math.isnan(y)):
                    problems.append(f"{label}: NaN pattern differs ({x} against {y})")
                continue
            if math.isinf(y) or math.isinf(x):
                if x != y:
                    problems.append(f"{label}: {x} against {y}")
                continue
            gap = abs(x - y)
            ratio = gap / (atol + rtol * abs(y))
            if ratio > 1.0 and len(problems) < 5:
                problems.append(f"{label}: {x} against {y}")
            worst = max(worst, ratio)
            worst_rel = max(worst_rel, gap / max(abs(y), 1e-300) if gap else 0.0)
    ok = port.get("ok", False) and ref.get("ok", False) and not problems and worst <= 1.0
    return dict(ok=ok, worst_ratio=worst, worst_rel=worst_rel, mc_bands=len(bands),
                problems=problems[:5], counts=sum(len(a) for _, a, _ in parts))


def _same_error(port: dict, ref: dict) -> bool:
    """both runs failed with the same exception and message (the port's
    package name read as the JAX package's)."""
    normal = lambda e: (e or "").replace("stochvolmodels_torch", "stochvolmodels_tpu")
    return (not port.get("ok") and not ref.get("ok") and bool(ref.get("error"))
            and normal(port.get("error")) == normal(ref.get("error")))


def judge(name: str, port: dict, ref: dict) -> dict:
    """:func:`compare` under the tolerance of the entry's kind, leaving out
    the artists of an attributed gap (ATTRIBUTED).  Where a fit parts
    (FIT_QUALITY), the port's fit must be as close to the chain as the JAX
    one's: its mean |model vol - mid| and the final objective of each of its
    optimizer calls within the JAX run's times (1 + the entry's margins).
    An entry that fails on the JAX package (JAX_FAILS)
    must fail on the port with the same error, and what it produced up to
    the failure is compared."""
    kind = KINDS.get(name, "analytic")
    verdict = compare(port, ref, TOLERANCES[kind],
                      band_z=BAND_Z.get(name, 1.96) if kind == "mc" else None,
                      skip=ATTRIBUTED.get(name, ((), ""))[0],
                      histograms=HISTOGRAMS.get(name, ((), 0)), table=MC_TABLES.get(name))
    if name in FIT_QUALITY:
        pf, rf = port.get("figures", []), ref.get("figures", [])
        bands = _band_pairs(pf, rf)
        fit_margin, objective_margin = FIT_QUALITY[name]
        ours, theirs = _fit_error(pf, bands), _fit_error(rf, bands)
        objs, jax_objs = port.get("objectives", []), ref.get("objectives", [])
        verdict.update(fit_error=ours, jax_fit_error=theirs, objectives=objs,
                       jax_objectives=jax_objs)
        verdict["ok"] = (verdict["ok"] and ours <= theirs + fit_margin * abs(theirs)
                         and len(objs) == len(jax_objs)
                         and all(a <= b + objective_margin * abs(b)
                                 for a, b in zip(objs, jax_objs)))
    if name in JAX_FAILS:
        clean = not verdict["problems"] and verdict["worst_ratio"] <= 1.0
        verdict.update(ok=clean and _same_error(port, ref), same_error=_same_error(port, ref))
    return verdict


def main() -> int:
    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument("--side", choices=("port", "jax"))
    parser.add_argument("--entries", nargs="*", default=[])
    parser.add_argument("--imports", nargs="*", default=[])
    parser.add_argument("--all", action="store_true")
    parser.add_argument("--list", action="store_true")
    parser.add_argument("--jobs", type=int, default=2,
                        help="entries run at once per side (--all/--entries)")
    parser.add_argument("--out", type=pathlib.Path)
    args = parser.parse_args()
    if args.side:
        run_side(args.side, args.entries, args.imports)
        return 0
    all_entries = entries()
    if args.list:
        for e in all_entries:
            print(f"{e.name}  kind={e.kind}  tol={TOLERANCES[e.kind]}")
        for path, why in {**OUT_OF_REACH, **NOT_RUN}.items():
            print(f"{path}  not run: {why}")
        return 0
    names = [e.name for e in all_entries] if args.all else args.entries
    kinds = {e.name: e.kind for e in all_entries}

    def both(name):
        with ThreadPoolExecutor(2) as pool:
            port, ref = pool.map(lambda side: spawn_side(side, [name]), ("port", "jax"))
        return name, port, ref

    rows, failed = [], 0
    with ThreadPoolExecutor(max(1, args.jobs)) as pool:
        for name, port, ref in pool.map(both, names):
            p, r = port.get(name, {}), ref.get(name, {})
            cmp = judge(name, p, r)
            foreign = port["__done__"].get("foreign")
            row = dict(entry=name, kind=kinds[name], port_s=p.get("wall_s"),
                       jax_s=r.get("wall_s"), **cmp, foreign=foreign,
                       port_error=p.get("error") or port["__done__"].get("error"),
                       jax_error=r.get("error"))
            failed += not (cmp["ok"] and not foreign)
            rows.append(row)
            print(json.dumps(row), flush=True)
    print("| entry | kind | port s | jax s | worst gap / tol | worst rel gap | ok |")
    print("|---|---|---|---|---|---|---|")
    for row in rows:
        fmt = lambda v: "-" if v is None else f"{v:.1f}"
        print(f"| {row['entry']} | {row['kind']} | {fmt(row['port_s'])} | {fmt(row['jax_s'])} "
              f"| {row['worst_ratio']:.2e} | {row['worst_rel']:.2e} | {row['ok']} |")
    if args.out:
        args.out.write_text(json.dumps(rows, indent=1))
    return 1 if failed else 0


if __name__ == "__main__":
    sys.exit(main())
