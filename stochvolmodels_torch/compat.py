"""
The reference's ``stochvolmodels`` import surface on the PyTorch port.

Counterpart of the JAX package's compat shim (``stochvolmodels/__init__.py``):
this module exports the same public names, each taken from
``stochvolmodels_torch``, so that scripts written against the reference's
``stochvolmodels`` run on the card.  Importing it changes nothing else:

    import stochvolmodels_torch.compat as svm

uses the names directly, and

    stochvolmodels_torch.compat.install()
    import stochvolmodels as sv

makes ``stochvolmodels`` and its submodule paths (``stochvolmodels.pricers.
logsv_pricer``, ``stochvolmodels.utils.plots``, ``stochvolmodels.pricers.
factor_hjm.rate_logsv_pricer``, ...) resolve to this module and the port's
modules.  ``install`` refuses to run where another ``stochvolmodels`` (the
JAX package's shim) is already imported, so the two never mix in one
process.  The plotting names need matplotlib, seaborn and pandas when they
are called, not when they are imported.
"""
import importlib as _importlib
import sys as _sys
import types as _types

__version__ = "1.2.2+torch"

from stochvolmodels_torch.config import OptionType, VariableType  # noqa: F401

from stochvolmodels_torch.ops.payoffs import compute_mc_vars_payoff  # noqa: F401

from stochvolmodels_torch.ops.mgf import (  # noqa: F401
    get_phi_grid,
    get_psi_grid,
    get_theta_grid,
    get_transform_var_grid,
    compute_integration_weights,
    vanilla_slice_pricer_with_mgf_grid,
    digital_slice_pricer_with_mgf_grid,
    slice_pricer_with_mgf_grid_with_gamma,
    slice_qvar_pricer_with_a_grid,
    pdf_with_mgf_grid,
)

from stochvolmodels_torch.utils.funcs import (  # noqa: F401
    set_seed,
    compute_histogram_data,
    timer,
    to_flat_np_array,
    update_kwargs,
    find_nearest,
)
from stochvolmodels_torch.ops.gauss import ncdf, npdf  # noqa: F401

from stochvolmodels_torch.ops.bsm import (  # noqa: F401
    compute_bsm_vanilla_price,
    compute_bsm_vanilla_slice_deltas,
    compute_bsm_vanilla_slice_prices,
    compute_bsm_forward_grid_prices,
    compute_bsm_vanilla_delta,
    compute_bsm_vanilla_grid_deltas,
    compute_bsm_strike_from_delta,
    compute_bsm_vanilla_deltas_ttms,
    compute_bsm_slice_vegas,
    compute_bsm_vegas_ttms,
    infer_bsm_implied_vol,
    infer_bsm_ivols_from_model_chain_prices,
    infer_bsm_ivols_from_model_slice_prices,
    infer_bsm_ivols_from_slice_prices,
)

from stochvolmodels_torch.ops.bachelier import (  # noqa: F401
    compute_normal_delta,
    compute_normal_delta_from_lognormal_vol,
    compute_normal_delta_to_strike,
    compute_normal_deltas_ttms,
    compute_normal_price,
    compute_normal_slice_deltas,
    compute_normal_slice_prices,
    compute_normal_slice_vegas,
    compute_normal_vegas_ttms,
    infer_normal_implied_vol,
    infer_normal_ivols_from_chain_prices,
    infer_normal_ivols_from_model_slice_prices,
    infer_normal_ivols_from_slice_prices,
)

from stochvolmodels_torch.ops.tdist import (  # noqa: F401
    pdf_tdist,
    cdf_tdist,
    cum_mean_tdist,
    imply_drift_tdist,
    compute_default_prob_tdist,
    compute_forward_tdist,
    compute_vanilla_price_tdist,
    infer_implied_vol_tdist,
    infer_tdist_implied_vols_from_model_slice_prices,
)

from stochvolmodels_torch.models.logsv.affine import (  # noqa: F401
    ExpansionOrder,
    compute_logsv_a_mgf_grid,
    func_a_ode_quadratic_terms,
    func_rhs,
    func_rhs_jac,
    get_expansion_n,
    get_init_conditions_a,
    solve_a_ode_grid,
    solve_analytic_ode_for_a,
    solve_analytic_ode_for_a0,
    solve_analytic_ode_grid_phi,
    solve_ode_for_a,
)

from stochvolmodels_torch.models.hawkes_jd import HawkesJDParams, HawkesJDPricer  # noqa: F401
from stochvolmodels_torch.models.heston import (  # noqa: F401
    BTC_HESTON_PARAMS,
    HestonParams,
    HestonPricer,
)
from stochvolmodels_torch.models.logsv.params import LogSvParams  # noqa: F401
from stochvolmodels_torch.models.logsv.pricer import (  # noqa: F401
    LOGSV_BTC_PARAMS,
    CalibrationEngine,
    ConstraintsType,
    LogsvModelCalibrationType,
    LogSVPricer,
    get_randoms_for_chain_valuation,
    get_randoms_for_rough_vol_chain_valuation,
    logsv_mc_chain_pricer_fixed_randoms,
    rough_logsv_mc_chain_pricer_fixed_randoms,
)
from stochvolmodels_torch.models.gmm import GmmParams, GmmPricer  # noqa: F401
from stochvolmodels_torch.models.tdist import TdistParams, TdistPricer  # noqa: F401

from stochvolmodels_torch.data.option_chain import OptionChain, OptionSlice  # noqa: F401
from stochvolmodels_torch.data.sample_chains import (  # noqa: F401
    get_btc_test_chain_data,
    get_gld_test_chain_data,
    get_gld_test_chain_data_6m,
    get_qv_options_test_chain_data,
    get_spy_test_chain_data,
    get_sqqq_test_chain_data,
    get_vix_test_chain_data,
)

from stochvolmodels_torch.plotting.plots import (  # noqa: F401
    align_x_limits_axs,
    align_y_limits_axs,
    create_dummy_line,
    fig_list_to_pdf,
    fig_to_pdf,
    set_legend_colors,
    get_n_sns_colors,
    map_deltas_to_str,
    model_param_ts,
    model_vols_ts,
    plot_model_risk_var,
    save_fig,
    save_figs,
    set_fig_props,
    set_subplot_border,
    set_y_limits,
    vol_slice_fit,
)

from stochvolmodels_torch.models.logsv.vol_moments import compute_analytic_qvar  # noqa: F401

# the reference's module paths, under ``stochvolmodels.``, and the port's modules behind them
# (None: a package with no module of its own)
_ALIASES = {
    "utils": None,
    "utils.config": "config",
    "utils.funcs": "utils.funcs",
    "utils.mgf_pricer": "ops.mgf",
    "utils.mc_payoffs": "ops.payoffs",
    "utils.var_swap_pricer": "utils.var_swap",
    "utils.rate_core": "utils.rate_core",
    "utils.plots": "plotting.plots",
    "pricers": None,
    "pricers.model_pricer": "models.model_pricer",
    "pricers.analytic": None,
    "pricers.analytic.bsm": "ops.bsm",
    "pricers.analytic.bachelier": "ops.bachelier",
    "pricers.analytic.tdist": "ops.tdist",
    "pricers.logsv": None,
    "pricers.logsv.logsv_params": "models.logsv.params",
    "pricers.logsv.affine_expansion": "models.logsv.affine",
    "pricers.logsv.vol_moments_ode": "models.logsv.vol_moments",
    "pricers.logsv_pricer": "models.logsv.pricer",
    "pricers.heston_pricer": "models.heston",
    "pricers.hawkes_jd_pricer": "models.hawkes_jd",
    "pricers.gmm_pricer": "models.gmm",
    "pricers.tdist_pricer": "models.tdist",
    "pricers.rough_logsv": None,
    "pricers.rough_logsv.RoughKernel": "models.rough.kernel",
    "pricers.rough_logsv.split_simulation": "models.rough.simulation",
    "pricers.factor_hjm": "models.factor_hjm",
    "data": None,
    "data.option_chain": "data.option_chain",
    "data.sample_option_chains": "data.sample_chains",
    # the factor-HJM deep submodules
    "pricers.factor_hjm.double_exp_pricer": "models.factor_hjm.double_exp_pricer",
    "pricers.factor_hjm.factor_hjm_pricer": "models.factor_hjm.factor_hjm_pricer",
    "pricers.factor_hjm.rate_affine_expansion": "models.factor_hjm.rate_affine_expansion",
    "pricers.factor_hjm.rate_evaluate": "models.factor_hjm.rate_evaluate",
    "pricers.factor_hjm.rate_factor_basis": "models.factor_hjm.rate_factor_basis",
    "pricers.factor_hjm.rate_logsv_ivols": "models.factor_hjm.rate_logsv_ivols",
    "pricers.factor_hjm.rate_logsv_params": "models.factor_hjm.rate_logsv_params",
    "pricers.factor_hjm.rate_logsv_pricer": "models.factor_hjm.rate_logsv_pricer",
}


def install() -> _types.ModuleType:
    """register ``stochvolmodels`` in ``sys.modules`` as this module, and
    every reference submodule path as the port's module behind it, each
    bound as an attribute of its parent; returns this module.  Installing
    twice is a no-op; installing where another ``stochvolmodels`` is already
    imported raises ``RuntimeError``."""
    this = _sys.modules[__name__]
    present = _sys.modules.get("stochvolmodels")
    if present is this:
        return this
    if present is not None:
        raise RuntimeError(f"another stochvolmodels is already imported ({present!r}); the "
                           "port's compat surface cannot be installed beside it")
    _sys.modules["stochvolmodels"] = this
    for path, target in _ALIASES.items():
        name = f"stochvolmodels.{path}"
        _sys.modules[name] = (_types.ModuleType(name) if target is None else
                              _importlib.import_module(f"stochvolmodels_torch.{target}"))
    # bind each path as an attribute of its parent, as a package import does
    for path in _ALIASES:
        parent_name, _, child = f"stochvolmodels.{path}".rpartition(".")
        parent = _sys.modules[parent_name]
        if not hasattr(parent, child):
            setattr(parent, child, _sys.modules[f"stochvolmodels.{path}"])
    return this
