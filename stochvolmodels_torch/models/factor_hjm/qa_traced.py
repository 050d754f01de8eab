"""
Traced annuity-measure structural panels for the factor-HJM LogSV model.

PyTorch counterpart of ``stochvolmodels_tpu/models/factor_hjm/qa_traced.py``.
The frozen cube (``rate_logsv_pricer.make_swaption_cube_fn``) integrates the
mean-state ODE with scipy ``solve_ivp`` on the host and freezes the swap-rate
gradient, the annuity log-derivative and the factor vols C into constants,
so the factor-vol levels ``A``, the mean-reversion pair ``(kappa1, kappa2)``
and ``sigma0`` are structural.  Here the whole panel pipeline is torch on
the device:

* what depends only on the static geometry (the swap schedules, the bond
  bases at the RK4 stage times and the panel grid, the stub discount-curve
  ratios, the generating matrices, the linear Omega operator) is computed
  on the host once per slice stack into a :class:`QAGeometry`, with the
  JAX package's arithmetic order;
* what depends on the calibratable parameters (C(A), M = C C', Omega(M),
  the mean-state ODE for (X, Y, sigma), the swap-gradient and annuity
  log-derivative panels, the Riccati coefficient panels) is torch, so
  forward- and reverse-mode derivatives go through the structure.

The mean-state ODE is a fixed-step RK4 over S = (T - 1) n_sub steps, all P
slices together: a Python loop over host-indexed geometry slabs, with every
segment gather (``C_seg[seg]``, ``beta_xs[seg]``, ``M_seg[seg]``) done for
all steps before the loop by ``index_select`` on device tensors, so a
captured graph holds no host work.  The 31 per-grid-time panel assemblies
of the JAX package are one batched computation over the T axis here (the
same arithmetic per element, reductions in another order: within 1e-13
relative of the JAX panels).
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import NamedTuple, Optional, Sequence, Tuple, Union

import numpy as np
import torch

from stochvolmodels_torch.ops.bsm import _f64
from stochvolmodels_torch.utils.rate_core import (
    bracket,
    df_fast,
    generate_ttms_grid,
    get_default_swap_term_structure,
)


def omega_linear_operator(basis) -> np.ndarray:
    """static (n_aux, d, d) tensor W with ``calc_Omega(M) == einsum('aij,ij->a', W, M)``.

    ``calc_Omega`` is linear in the covariance M for every basis, so probing
    it with unit matrices once on the host gives an exact replacement.
    """
    d = basis.nb_factors
    W = np.zeros((basis.nb_aux_factors, d, d))
    for i in range(d):
        for j in range(d):
            E = np.zeros((d, d))
            E[i, j] = 1.0
            W[:, i, j] = basis.calc_Omega(E)
    return W


@dataclass
class QAGeometry:
    """static geometry stack for P (expiry, tenor) swaption slices.

    Shapes: P slices, T grid points per slice (shared ``nb_grid_pts``),
    S = (T-1) * n_sub mean-ODE steps, 3 RK4 stage times per step,
    n_sw padded swap schedule dates, d factors, n_aux aux factors.
    Padded schedule dates carry dcf = 0 so they drop out of every sum.
    """
    t_grids: np.ndarray        # (P, T) panel grid times
    dts_mean: np.ndarray       # (P,) mean-ODE step size
    idx_t: np.ndarray          # (P, T) term-structure segment at grid times
    seg_stage: np.ndarray      # (S, 3, P) segment at mean-ODE stage times
    BX_st: np.ndarray          # (S, 3, P, n_sw, d)
    BY_st: np.ndarray          # (S, 3, P, n_sw, n_aux)
    P0r_st: np.ndarray         # (S, 3, P, n_sw)
    dcf: np.ndarray            # (P, n_sw)
    BX_g: np.ndarray           # (P, T, n_sw, d)
    BY_g: np.ndarray           # (P, T, n_sw, n_aux)
    P0r_g: np.ndarray          # (P, T, n_sw)
    BX_first: np.ndarray       # (P, T, d)   bond basis at ts_sw[0]
    BY_first: np.ndarray       # (P, T, n_aux)
    P0r_first: np.ndarray      # (P, T)
    BX_last: np.ndarray        # (P, T, d)   bond basis at ts_sw[-1]
    BY_last: np.ndarray        # (P, T, n_aux)
    P0r_last: np.ndarray       # (P, T)
    D_X: np.ndarray            # (d, d)
    D_Y: np.ndarray            # (n_aux, n_aux)
    W_omega: np.ndarray        # (n_aux, d, d)
    inv_B: np.ndarray          # (d, d)
    R_chol: np.ndarray         # (d, d)
    n_sub: int

    def on(self, device) -> "QAGeometryTensors":
        """the arrays as tensors on ``device`` (the segment indices int64)."""
        device = torch.device(device)
        out = {}
        for f in QAGeometryTensors._fields:
            a = np.asarray(getattr(self, f))
            dtype = torch.int64 if a.dtype.kind in "iu" else torch.float64
            out[f] = torch.as_tensor(a.astype(np.int64) if dtype == torch.int64 else a,
                                     dtype=dtype, device=device)
        return QAGeometryTensors(**out)


class QAGeometryTensors(NamedTuple):
    """the device copy of a :class:`QAGeometry` (its arrays but ``t_grids``);
    a tuple of tensors, so that it goes into a captured graph as inputs."""
    dts_mean: torch.Tensor
    idx_t: torch.Tensor
    seg_stage: torch.Tensor
    BX_st: torch.Tensor
    BY_st: torch.Tensor
    P0r_st: torch.Tensor
    dcf: torch.Tensor
    BX_g: torch.Tensor
    BY_g: torch.Tensor
    P0r_g: torch.Tensor
    BX_first: torch.Tensor
    BY_first: torch.Tensor
    P0r_first: torch.Tensor
    BX_last: torch.Tensor
    BY_last: torch.Tensor
    P0r_last: torch.Tensor
    D_X: torch.Tensor
    D_Y: torch.Tensor
    W_omega: torch.Tensor
    inv_B: torch.Tensor
    R_chol: torch.Tensor


Geometry = Union[QAGeometry, QAGeometryTensors]


def build_qa_geometry(params,
                      slices: Sequence[Tuple[float, float]],
                      nb_grid_pts: int = 31,
                      n_sub: int = 2) -> QAGeometry:
    """precompute the static geometry stack for ``slices`` (host, once).

    ``params`` supplies the basis, currency and term-structure knots; none
    of its calibratable values enter the output.  ``n_sub`` RK4 substeps
    per panel-grid interval integrate the mean-state ODE (RK4 at n_sub = 2
    on a 31-point grid is ~1e-9 from a tight-tolerance solution).
    """
    basis, ccy = params.basis, params.ccy
    d = basis.nb_factors
    n_aux = basis.nb_aux_factors
    P = len(slices)
    T = nb_grid_pts
    S = (T - 1) * n_sub
    n_sw_max = max(get_default_swap_term_structure(e, tn).size for e, tn in slices)

    t_grids = np.zeros((P, T))
    dts_mean = np.zeros(P)
    idx_t = np.zeros((P, T), dtype=np.int32)
    seg_stage = np.zeros((S, 3, P), dtype=np.int32)
    BX_st = np.zeros((S, 3, P, n_sw_max, d))
    BY_st = np.zeros((S, 3, P, n_sw_max, n_aux))
    P0r_st = np.ones((S, 3, P, n_sw_max))
    dcf = np.zeros((P, n_sw_max))
    BX_g = np.zeros((P, T, n_sw_max, d))
    BY_g = np.zeros((P, T, n_sw_max, n_aux))
    P0r_g = np.ones((P, T, n_sw_max))
    BX_first = np.zeros((P, T, d))
    BY_first = np.zeros((P, T, n_aux))
    P0r_first = np.ones((P, T))
    BX_last = np.zeros((P, T, d))
    BY_last = np.zeros((P, T, n_aux))
    P0r_last = np.ones((P, T))

    ts_knots = np.asarray(params.ts)

    def _geom(t: float, T_date: float):
        bx, by = basis.bond_coeffs(max(T_date - t, 0.0))
        return bx, by, float(df_fast(T_date, ccy) / df_fast(t, ccy))

    for p, (expiry, tenor) in enumerate(slices):
        expiry = float(expiry)
        ts_sw = get_default_swap_term_structure(expiry, float(tenor))
        n_sw = ts_sw.size
        t_grid = generate_ttms_grid(np.array([expiry]), nb_pts=T)
        assert t_grid.size == T, (t_grid.size, T)
        t_grids[p] = t_grid
        dts_mean[p] = (t_grid[1] - t_grid[0]) / n_sub  # uniform grid
        idx_t[p] = [bracket(ts_knots[1:], float(t), throw_if_not_found=True) for t in t_grid]
        dcf[p, 1:n_sw] = np.diff(ts_sw)

        # stage times of the mean ODE: substep RK4 inside each grid interval
        for s in range(S):
            i_grid, i_sub = divmod(s, n_sub)
            t0 = t_grid[i_grid] + i_sub * dts_mean[p]
            # piecewise-constant coefficients: the whole step lives in the
            # segment of its midpoint (a step that starts on a knot belongs
            # to the left segment under the bracket convention, but the ODE
            # on (t0, t0 + h] uses the right one)
            seg_mid = bracket(ts_knots[1:], min(t0 + 0.5 * dts_mean[p], expiry),
                              throw_if_not_found=True)
            for j, toff in enumerate((0.0, 0.5 * dts_mean[p], dts_mean[p])):
                t = t0 + toff
                seg_stage[s, j, p] = seg_mid
                for i in range(n_sw):
                    bx, by, pr = _geom(t, ts_sw[i])
                    BX_st[s, j, p, i] = bx
                    BY_st[s, j, p, i] = by
                    P0r_st[s, j, p, i] = pr

        for k, t in enumerate(t_grid):
            for i in range(n_sw):
                bx, by, pr = _geom(float(t), ts_sw[i])
                BX_g[p, k, i] = bx
                BY_g[p, k, i] = by
                P0r_g[p, k, i] = pr
            BX_first[p, k], BY_first[p, k] = BX_g[p, k, 0], BY_g[p, k, 0]
            P0r_first[p, k] = P0r_g[p, k, 0]
            BX_last[p, k], BY_last[p, k] = BX_g[p, k, n_sw - 1], BY_g[p, k, n_sw - 1]
            P0r_last[p, k] = P0r_g[p, k, n_sw - 1]

    B = basis.get_matrix_B()
    return QAGeometry(
        t_grids=t_grids, dts_mean=dts_mean, idx_t=idx_t, seg_stage=seg_stage,
        BX_st=BX_st, BY_st=BY_st, P0r_st=P0r_st, dcf=dcf,
        BX_g=BX_g, BY_g=BY_g, P0r_g=P0r_g,
        BX_first=BX_first, BY_first=BY_first, P0r_first=P0r_first,
        BX_last=BX_last, BY_last=BY_last, P0r_last=P0r_last,
        D_X=basis.get_generating_matrix(),
        D_Y=basis.get_aux_generating_matrix(),
        W_omega=omega_linear_operator(basis),
        inv_B=np.linalg.inv(B),
        R_chol=np.linalg.cholesky(params.R),
        n_sub=n_sub)


def _tensors(geom: Geometry, device) -> QAGeometryTensors:
    return geom.on(device) if isinstance(geom, QAGeometry) else geom


def factor_vols_traced(geom: Geometry, A_xs: torch.Tensor) -> torch.Tensor:
    """C(t) = B^-1 diag(A) chol(R) per term-structure segment: ``A_xs``
    (n_seg, d) -> (n_seg, d, d), with the static B^-1 and chol(R) of the
    geometry."""
    g = _tensors(geom, A_xs.device)
    return torch.einsum('ij,sj,jk->sik', g.inv_B, A_xs, g.R_chol)


def _annuity_terms(x, y, BX, BY, P0r, dcf) -> Tuple[torch.Tensor, torch.Tensor]:
    """(ann0 (...,), d log(ann)/dx (..., d)) over leading batch axes: x
    (..., d), y (..., n_aux), BX (..., n_sw, d), BY (..., n_sw, n_aux), P0r
    and dcf (..., n_sw); bond_i = P0r_i exp(-BX_i.x - BY_i.y), padded dates
    have dcf = 0."""
    expo = -(torch.einsum('...id,...d->...i', BX, x) + torch.einsum('...ia,...a->...i', BY, y))
    bonds = P0r * torch.exp(expo)
    w = dcf * bonds
    ann0 = torch.sum(w, dim=-1)
    ann1 = -torch.einsum('...i,...id->...d', w, BX)
    return ann0, ann1 / ann0[..., None]


def qa_mean_states_traced(geom: Geometry,
                          A_xs: torch.Tensor,
                          kappa1, kappa2, theta, sigma0,
                          beta_xs: torch.Tensor,
                          x0: Optional[torch.Tensor] = None,
                          y0: Optional[torch.Tensor] = None,
                          ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """annuity-measure mean states at the panel grid times: (mx (P, T, d),
    my (P, T, n_aux), msig (P, T)).

    RK4 over the static stage geometry, all P slices together; the
    counterpart of the host ``calc_QA_mean_states`` ``solve_ivp``.  The
    scalars may be floats or 0-d float64 tensors; everything lands on
    ``A_xs``'s device.
    """
    device = A_xs.device
    g = _tensors(geom, device)
    kappa1, kappa2, theta, sigma0 = (_f64(v, device) for v in (kappa1, kappa2, theta, sigma0))
    P, T = g.idx_t.shape
    S = g.seg_stage.shape[0]
    n_sub = S // (T - 1)
    d = g.D_X.shape[0]
    n_aux = g.D_Y.shape[0]
    C_seg = factor_vols_traced(g, A_xs)                             # (n_seg, d, d)
    M_seg = torch.einsum('sik,sjk->sij', C_seg, C_seg)
    Om_seg = torch.einsum('aij,sij->sa', g.W_omega, M_seg)
    # the segment gathers of every stage, before the loop
    seg = g.seg_stage.reshape(-1)
    M_st = M_seg.index_select(0, seg).reshape(S, 3, P, d, d)
    Om_st = Om_seg.index_select(0, seg).reshape(S, 3, P, n_aux)
    C_st = C_seg.index_select(0, seg).reshape(S, 3, P, d, d)
    beta_st = beta_xs.index_select(0, seg).reshape(S, 3, P, d)
    D_XT, D_YT = g.D_X.T, g.D_Y.T
    dcf = g.dcf
    h = g.dts_mean                                                  # (P,)
    h_col = h[:, None]

    def rhs(x, y, sig, s, j):
        loga = _annuity_terms(x, y, g.BX_st[s, j], g.BY_st[s, j], g.P0r_st[s, j], dcf)[1]
        sig2 = sig * sig
        dx = (x @ D_XT) + sig2[:, None] * torch.einsum('pij,pj->pi', M_st[s, j], loga)
        dy = (y @ D_YT) + sig2[:, None] * Om_st[s, j]
        vol_adj = torch.einsum('pd,ped,pe->p', beta_st[s, j], C_st[s, j], loga)
        dsig = (kappa1 + kappa2 * sig) * (theta - sig) + sig2 * vol_adj
        return dx, dy, dsig

    x = (A_xs.new_zeros((P, d)) if x0 is None
         else torch.broadcast_to(_f64(x0, device), (P, d)))
    y = (A_xs.new_zeros((P, n_aux)) if y0 is None
         else torch.broadcast_to(_f64(y0, device), (P, n_aux)))
    sig = torch.broadcast_to(sigma0, (P,))
    xs, ys, sigs = [x], [y], [sig]
    for s in range(S):
        k1 = rhs(x, y, sig, s, 0)
        k2 = rhs(x + 0.5 * h_col * k1[0], y + 0.5 * h_col * k1[1], sig + 0.5 * h * k1[2], s, 1)
        k3 = rhs(x + 0.5 * h_col * k2[0], y + 0.5 * h_col * k2[1], sig + 0.5 * h * k2[2], s, 1)
        k4 = rhs(x + h_col * k3[0], y + h_col * k3[1], sig + h * k3[2], s, 2)
        x = x + (h_col / 6.0) * (k1[0] + 2.0 * (k2[0] + k3[0]) + k4[0])
        y = y + (h_col / 6.0) * (k1[1] + 2.0 * (k2[1] + k3[1]) + k4[1])
        sig = sig + (h / 6.0) * (k1[2] + 2.0 * (k2[2] + k3[2]) + k4[2])
        if (s + 1) % n_sub == 0:                 # a panel grid time
            xs.append(x)
            ys.append(y)
            sigs.append(sig)
    return torch.stack(xs, dim=1), torch.stack(ys, dim=1), torch.stack(sigs, dim=1)


def qa_panels_traced(geom: Geometry,
                     A_xs: torch.Tensor,
                     kappa1, kappa2, theta, sigma0,
                     beta_xs: torch.Tensor,
                     volvol_xs: torch.Tensor,
                     x0: Optional[torch.Tensor] = None,
                     y0: Optional[torch.Tensor] = None):
    """annuity-measure Riccati coefficient panels of the cube: ``(a (P,T,d),
    kappa0 (P,T), kappa1 (P,T), kappa2 (P,T), beta (P,T,d), volvol (P,T))``,
    the traced counterparts of ``MultiFactRateLogSvParams.transform_QA_params``
    with every dependency on (A, kappa1, kappa2, theta, sigma0, beta, volvol)
    inside the computation."""
    device = A_xs.device
    g = _tensors(geom, device)
    kappa1, kappa2, theta = (_f64(v, device) for v in (kappa1, kappa2, theta))
    mx, my, _ = qa_mean_states_traced(g, A_xs, kappa1, kappa2, theta, sigma0, beta_xs,
                                      x0=x0, y0=y0)
    dcf = g.dcf[:, None, :]                                         # (P, 1, n_sw)
    ann0, loga_der = _annuity_terms(mx, my, g.BX_g, g.BY_g, g.P0r_g, dcf)

    def bond_pair(BX, BY, P0r):
        expo = -(torch.einsum('ptd,ptd->pt', BX, mx) + torch.einsum('pta,pta->pt', BY, my))
        b = P0r * torch.exp(expo)
        return b, -b[..., None] * BX

    # swap-rate gradient by the quotient rule (rate_core.swap_grad)
    bf0, bf1 = bond_pair(g.BX_first, g.BY_first, g.P0r_first)
    bl0, bl1 = bond_pair(g.BX_last, g.BY_last, g.P0r_last)
    numer0, numer1 = bf0 - bl0, bf1 - bl1
    expo = -(torch.einsum('ptid,ptd->pti', g.BX_g, mx)
             + torch.einsum('ptia,pta->pti', g.BY_g, my))
    den1 = -torch.einsum('pti,ptid->ptd', dcf * g.P0r_g * torch.exp(expo), g.BX_g)
    swap_gr = numer1 / ann0[..., None] - (numer0[..., None] * den1) / (ann0 * ann0)[..., None]

    C_seg = factor_vols_traced(g, A_xs)
    C_panel = C_seg[g.idx_t]                                        # (P, T, d, d)
    beta_interp = beta_xs[g.idx_t]                                  # (P, T, d)
    volvol_interp = volvol_xs[g.idx_t]                              # (P, T)
    a_interp = torch.einsum('ptd,ptde->pte', swap_gr, C_panel)
    CT_loga = torch.einsum('ptde,ptd->pte', C_panel, loga_der)
    beta2 = torch.einsum('ptd,ptd->pt', beta_interp, CT_loga)
    kappa0_s = beta2 * theta * theta
    kappa1_s = kappa1 - kappa2 * theta + 2.0 * (kappa2 - beta2) * theta
    kappa2_s = kappa2 - beta2
    return a_interp, kappa0_s, kappa1_s, kappa2_s, beta_interp, volvol_interp

