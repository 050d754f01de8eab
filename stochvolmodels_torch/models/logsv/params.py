"""
Parameters of the log-normal beta SV model with quadratic drift
(Sepp & Rakhmonov, IJTAF 2024):

    dsigma_t = (kappa1 + kappa2 sigma_t)(theta - sigma_t) dt
               + beta sigma_t dW0_t + volvol sigma_t dW1_t.

PyTorch-package counterpart of ``stochvolmodels_tpu/models/logsv/params.py``.
The vol backbone is held as a pair of numpy arrays ``(ttms, etas)``; it may
be given as that pair or, as the JAX package takes it, as a series of etas
indexed by ttm (a pandas Series, read through ``.index`` and ``.to_numpy()``
so that this package does not import pandas).
"""
from __future__ import annotations

from dataclasses import asdict, dataclass
from typing import Any, Dict, Optional, Tuple

import numpy as np

from stochvolmodels_torch.config import VariableType
from stochvolmodels_torch.models.model_pricer import ModelParams
from stochvolmodels_torch.utils.funcs import find_nearest


def _backbone_pair(backbone) -> Optional[Tuple[np.ndarray, np.ndarray]]:
    """(ttms, etas) of a vol backbone given as a Series-like object (etas
    indexed by ttm) or as a (ttms, etas) pair; None stays None."""
    if backbone is None:
        return None
    if hasattr(backbone, "index") and hasattr(backbone, "to_numpy"):
        ttms, etas = backbone.index, backbone.to_numpy()
    else:
        ttms, etas = backbone
    return np.asarray(ttms, dtype=float), np.asarray(etas, dtype=float)


@dataclass
class LogSvParams(ModelParams):
    """six model parameters, an optional vol backbone and the rough-kernel fields."""
    sigma0: float = 0.2
    theta: float = 0.2
    kappa1: float = 1.0
    kappa2: Optional[float] = 2.5  # None maps to kappa1 / theta
    beta: float = -1.0
    volvol: float = 1.0
    vol_backbone: Optional[Tuple[np.ndarray, np.ndarray]] = None  # (ttms, etas), or a Series
    H: float = 0.5
    weights: Optional[np.ndarray] = None
    nodes: Optional[np.ndarray] = None

    def __post_init__(self):
        self.vol_backbone = _backbone_pair(self.vol_backbone)
        if self.kappa2 is None:
            self.kappa2 = self.kappa1 / self.theta
        if not 1e-4 < self.H <= 0.5:
            raise ValueError(f"H must lie in (1e-4, 0.5], got {self.H}")

    def approximate_kernel(self, T: float) -> None:
        """set the Markovian rough-kernel nodes and weights: 1 node (the
        degenerate lift of the standard dynamics) for H in (0.49, 0.5], 2 for
        H in (0.4, 0.49], 3 below, by the European quadrature rule on [0, T]."""
        if 0.49 < self.H <= 0.5:
            self.weights = np.array([1.0])
            self.nodes = np.array([1e-3])
            return
        n = 2 if 0.4 < self.H <= 0.49 else 3
        from stochvolmodels_torch.models.rough.kernel import european_rule
        self.nodes, self.weights = european_rule(self.H, n, T)

    def to_dict(self) -> Dict[str, Any]:
        return asdict(self)

    def to_str(self) -> str:
        return (f"sigma0={self.sigma0:0.2f}, theta={self.theta:0.2f}, "
                f"kappa1={self.kappa1:0.2f}, kappa2={self.kappa2:0.2f}, "
                f"beta={self.beta:0.2f}, volvol={self.volvol:0.2f}")

    def set_vol_backbone(self, vol_backbone, etas: Optional[np.ndarray] = None) -> None:
        """set the backbone from one Series-like ``vol_backbone`` (as the JAX
        package's setter takes it), or from ttms ``vol_backbone`` and ``etas``."""
        self.vol_backbone = _backbone_pair(vol_backbone if etas is None else (vol_backbone, etas))

    def get_vol_backbone_eta(self, tau: float) -> float:
        """backbone scaling at the nearest quoted maturity at or beyond tau."""
        if self.vol_backbone is None:
            return 1.0
        ttms, etas = self.vol_backbone
        nearest_tau = find_nearest(a=ttms, value=tau, is_equal_or_largest=True)
        return float(etas[int(np.flatnonzero(ttms == nearest_tau)[0])])

    def get_vol_backbone_etas(self, ttms: np.ndarray) -> np.ndarray:
        return np.array([self.get_vol_backbone_eta(tau) for tau in ttms])

    @property
    def kappa(self) -> float:
        """effective mean-reversion kappa1 + kappa2 theta (Eq. 3.32)."""
        return self.kappa1 + self.kappa2 * self.theta

    @property
    def theta2(self) -> float:
        return self.theta * self.theta

    @property
    def vartheta2(self) -> float:
        """total vol-of-vol variance beta^2 + volvol^2 (Eq. 3.13)."""
        return self.beta * self.beta + self.volvol * self.volvol

    @property
    def gamma(self) -> float:
        return self.kappa1 / self.theta

    @property
    def eta(self) -> float:
        """GIG steady-state exponent (Eq. 3.38)."""
        return 2.0 * (self.kappa2 * self.theta - self.kappa1) / self.vartheta2 - 1.0

    # space grids of the density inversion
    def get_x_grid(self, ttm: float = 1.0, n_stdevs: float = 3.0, n: int = 200) -> np.ndarray:
        sigma_t = np.sqrt(ttm * 0.5 * (np.square(self.sigma0) + np.square(self.theta)))
        drift = -0.5 * sigma_t * sigma_t
        stdev = (n_stdevs + 1) * sigma_t
        return np.linspace(-stdev + drift, stdev + drift, n)

    def get_sigma_grid(self, ttm: float = 1.0, n_stdevs: float = 3.0, n: int = 200) -> np.ndarray:
        sigma_t = np.sqrt(0.5 * (np.square(self.sigma0) + np.square(self.theta)))
        vvol = 0.5 * np.sqrt(self.vartheta2 * ttm)
        return np.linspace(0.0, sigma_t + n_stdevs * vvol, n)

    def get_qvar_grid(self, ttm: float = 1.0, n_stdevs: float = 3.0, n: int = 200) -> np.ndarray:
        sigma_t = np.sqrt(ttm * (np.square(self.sigma0) + np.square(self.theta)))
        vvol = np.sqrt(self.vartheta2) * ttm
        return np.linspace(0.0, sigma_t + n_stdevs * vvol, n)

    def get_variable_space_grid(self, variable_type: VariableType = VariableType.LOG_RETURN,
                                ttm: float = 1.0, n_stdevs: float = 3, n: int = 200
                                ) -> np.ndarray:
        if variable_type == VariableType.LOG_RETURN:
            return self.get_x_grid(ttm=ttm, n_stdevs=n_stdevs, n=n)
        if variable_type == VariableType.SIGMA:
            return self.get_sigma_grid(ttm=ttm, n_stdevs=n_stdevs, n=n)
        if variable_type == VariableType.Q_VAR:
            return self.get_qvar_grid(ttm=ttm, n_stdevs=n_stdevs, n=n)
        raise NotImplementedError(f"variable_type={variable_type}")

    # the vol-moment generator Lambda^(1, k*) (Eq. 3.48)
    def get_vol_moments_lambda(self, n_terms: int = 4) -> np.ndarray:
        """lower-Hessenberg truncated moment generator."""
        kappa2, kappa = self.kappa2, self.kappa
        vartheta2, theta, theta2 = self.vartheta2, self.theta, self.theta2

        def c(n: int) -> float:
            return 0.5 * vartheta2 * n * (n - 1.0)

        lambda_m = np.zeros((n_terms, n_terms))
        lambda_m[0, 0] = -kappa
        lambda_m[0, 1] = -kappa2
        lambda_m[1, 0] = 2.0 * c(2) * theta
        lambda_m[1, 1] = c(2) - 2.0 * kappa
        lambda_m[1, 2] = -2.0 * kappa2
        for n_ in np.arange(2, n_terms):
            n = n_ + 1
            c_n = c(n)
            lambda_m[n_, n_ - 2] = c_n * theta2
            lambda_m[n_, n_ - 1] = 2.0 * c_n * theta
            lambda_m[n_, n_] = c_n - n * kappa
            if n_ + 1 < n_terms:
                lambda_m[n_, n_ + 1] = -n * kappa2
        return lambda_m

    def assert_vol_moments_stability(self, n_terms: int = 4):
        w, _ = np.linalg.eig(self.get_vol_moments_lambda(n_terms=n_terms))
        print(f"vol moments stable = {np.all(np.real(w) < 0.0)}")

    def print_vol_moments_stability(self, n_terms: int = 4) -> None:
        def c(n: int) -> float:
            return 0.5 * self.vartheta2 * n * (n - 1.0)
        for n in (2, 3, 4):
            print(f"cond{n}:\n{c(n) - n * self.kappa}")
        lambda_m = self.get_vol_moments_lambda(n_terms=n_terms)
        print(f"lambda_m:\n{lambda_m}")
        w, _ = np.linalg.eig(lambda_m)
        print(f"eigenvalues w:\n{w}")
        print(f"vol moments stable = {np.all(np.real(w) < 0.0)}")
