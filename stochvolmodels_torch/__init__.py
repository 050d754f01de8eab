"""
stochvolmodels_torch: the PyTorch and CUDA port of stochvolmodels_tpu.

It imports torch, numpy and scipy only — never jax and nothing of the JAX
package, which stays beside it as the reference the port is tested against.
It serves pricing requests for the flagship LogSV model (analytic chain
prices through the affine-expansion Fourier engine, options on quadratic
variance, the densities of the log-return, the quadratic variance and the
vol, vol moments and the varswap backbone fit, BSM implied vols and greeks,
Monte Carlo (plain, antithetic, randomized QMC, on fixed randoms), the rough
lift's Monte Carlo, and calibration to a chain by SLSQP on the analytic, MC
or rough-MC engine, Levenberg-Marquardt as one CUDA graph, or Adam), for Heston (closed-form Fourier
prices and options on quadratic variance, Monte Carlo (plain, antithetic,
randomized QMC), and calibration by SLSQP with the Feller constraint or by
Levenberg-Marquardt) and for the Hawkes jump-diffusion model (Riccati Fourier
prices as one CUDA graph a reprice, the risk-premia pricer, thinning Monte
Carlo, and calibration by SLSQP, by Levenberg-Marquardt, and of the risk
premia); the chain greeks of LogSV (analytic and pathwise MC) and Heston by
forward-mode AD, in price or implied-vol space; the Bachelier (normal) and
Student-t analytics, the Gaussian-mixture and Student-t terminal pricers with
their per-slice SLSQP fits, and batched Levenberg-Marquardt sweeps of many
chains at once (``stochvolmodels_torch.parallel.sweep``).  Every Monte-Carlo path loop runs in a hand-written
CUDA kernel on NVIDIA Hopper.  Every entry point runs on the card unless the
caller asks for the CPU (``LogSVPricer(device="cpu")``); without a card, a call
on the default device raises.
"""
from stochvolmodels_torch.config import (  # noqa: F401
    OPTION_CODES,
    OptionType,
    VariableType,
    decode_optiontypes,
    encode_optiontypes,
)
from stochvolmodels_torch.data.option_chain import (  # noqa: F401
    ChainGrid,
    FutOptionChain,
    OptionChain,
    OptionSlice,
    SwOptionChain,
)
from stochvolmodels_torch.data.sample_chains import (  # noqa: F401
    get_btc_test_chain_data,
    get_gld_test_chain_data,
    get_gld_test_chain_data_6m,
    get_qv_options_test_chain_data,
    get_spy_test_chain_data,
    get_sqqq_test_chain_data,
    get_vix_test_chain_data,
)
from stochvolmodels_torch.interop import (  # noqa: F401
    chain_from_numpy,
    gmm_params_from_numpy,
    hawkes_params_from_numpy,
    qmc_panels_from_numpy,
    heston_params_from_numpy,
    params_from_numpy,
    rate_params_from_numpy,
    tdist_params_from_numpy,
)
from stochvolmodels_torch.models.gmm import GmmParams, GmmPricer  # noqa: F401
from stochvolmodels_torch.models.hawkes_jd import (  # noqa: F401
    HawkesJDParams,
    HawkesJDPricer,
    calibrate_hawkesjd_lm_on_device,
)
from stochvolmodels_torch.models.heston import (  # noqa: F401
    BTC_HESTON_PARAMS,
    HestonParams,
    HestonPricer,
    calibrate_heston_lm,
    compute_heston_mgf_grid,
    heston_chain_price_grid,
    heston_mc_chain_pricer,
    simulate_heston_terminal,
    simulate_heston_terminal_qmc,
    v0_implied,
)
from stochvolmodels_torch.models.greeks import (  # noqa: F401
    heston_chain_greeks,
    logsv_chain_greeks,
    logsv_mc_chain_greeks,
    swaption_cube_greeks,
)
from stochvolmodels_torch.models.factor_hjm import (  # noqa: F401
    Cheyette1D,
    CheyettePEND,
    FutSettleType,
    Measure,
    MultiFactRateLogSvParams,
    NelsonSiegel,
    RateFutLogSVPricer,
    RateLogSVPricer,
    RateLogSvParams,
    TermStructure,
    UnderlyingType,
)
from stochvolmodels_torch.models.logsv.affine import (  # noqa: F401
    ExpansionOrder,
    compute_logsv_a_mgf_grid,
    func_a_ode_quadratic_terms,
    get_expansion_n,
    get_init_conditions_a,
    phi_grid_p_max,
    solve_a_ode_grid,
    solve_analytic_ode_for_a,
    solve_analytic_ode_grid,
    solve_analytic_ode_grid_phi,
    solve_ode_for_a,
)
from stochvolmodels_torch.models.logsv.fast_calibration import (  # noqa: F401
    calibrate_logsv_lm_on_device,
    calibrate_logsv_on_device,
)
from stochvolmodels_torch.models.logsv.params import LogSvParams  # noqa: F401
from stochvolmodels_torch.models.logsv.pricer import (  # noqa: F401
    LOGSV_BTC_PARAMS,
    CalibrationEngine,
    ConstraintsType,
    LogsvModelCalibrationType,
    LogSVPricer,
    get_qmc_randoms_for_chain_valuation,
    get_randoms_for_chain_valuation,
    get_randoms_for_rough_vol_chain_valuation,
    logsv_chain_price_grid,
    logsv_chain_pricer,
    logsv_mc_chain_pricer,
    logsv_mc_chain_pricer_fixed_randoms,
    logsv_pdfs,
    rough_logsv_mc_chain_pricer_fixed_randoms,
    set_vol_scaler,
    simulate_logsv_terminal,
    simulate_logsv_terminal_fixed,
    simulate_logsv_terminal_qmc,
    simulate_vol_paths,
)
from stochvolmodels_torch.models.logsv.vol_moments import (  # noqa: F401
    compute_analytic_qvar,
    compute_analytic_qvar_torch,
    compute_analytic_vol_moments,
    compute_expected_vol_t,
    compute_sqrt_qvar_t,
    compute_vol_moments_t,
    fit_model_vol_backbone_to_varswaps,
)
from stochvolmodels_torch.models.model_pricer import ModelParams, ModelPricer  # noqa: F401
from stochvolmodels_torch.models.tdist import TdistParams, TdistPricer  # noqa: F401
from stochvolmodels_torch.models.rough.kernel import (  # noqa: F401
    abi_jaber_el_euch_rule,
    ak_geometric_rule,
    european_rule,
    gaussian_rule,
    harms_rule,
    kernel_frac,
    kernel_l1_relative_error,
    kernel_l2_relative_error,
    kernel_rheston,
    l1_rule,
    mittag_leffler,
    optimized_l2_rule,
    quadrature_rule,
)
from stochvolmodels_torch.models.rough.simulation import (  # noqa: F401
    drift_ode_expm,
    drift_ode_rk4,
    log_spot_full_combined,
    log_spot_full_combined_fixed,
    rough_logsv_mc_chain_pricer,
    strang_step,
)
from stochvolmodels_torch.ops.bachelier import (  # noqa: F401
    compute_normal_delta,
    compute_normal_delta_from_lognormal_vol,
    compute_normal_delta_to_strike,
    compute_normal_price,
    compute_normal_slice_deltas,
    compute_normal_slice_prices,
    compute_normal_slice_vegas,
    compute_normal_vegas_ttms,
    infer_normal_implied_vol,
    infer_normal_implied_vol_fast,
    infer_normal_ivols_from_chain_prices,
    infer_normal_ivols_from_model_slice_prices,
    infer_normal_ivols_from_slice_prices,
    strikes_to_delta,
)
from stochvolmodels_torch.ops.bsm import (  # noqa: F401
    compute_bsm_digital_delta,
    compute_bsm_digital_price,
    compute_bsm_forward_grid_prices,
    compute_bsm_slice_vegas,
    compute_bsm_strike_from_delta,
    compute_bsm_vanilla_delta,
    compute_bsm_vanilla_delta_vector,
    compute_bsm_vanilla_gamma,
    compute_bsm_vanilla_grid_deltas,
    compute_bsm_vanilla_price,
    compute_bsm_vanilla_price_vector,
    compute_bsm_vanilla_slice_deltas,
    compute_bsm_vanilla_slice_prices,
    compute_bsm_vanilla_slice_vegas,
    compute_bsm_vanilla_theta,
    compute_bsm_vanilla_vega,
    infer_bsm_implied_vol,
    infer_bsm_implied_vol_fast,
    infer_bsm_ivols_from_model_chain_prices,
    infer_bsm_ivols_from_model_slice_prices,
    infer_bsm_ivols_from_slice_prices,
)
from stochvolmodels_torch.ops.cuda_mc import (  # noqa: F401
    engine_setup,
    simulate_hawkesjd_terminal_cuda,
    simulate_hawkesjd_terminal_kernel,
    simulate_hawkesjd_terminal_torch,
    simulate_heston_terminal_cuda,
    simulate_heston_terminal_kernel,
    simulate_heston_terminal_torch,
    simulate_logsv_terminal_cuda,
    simulate_logsv_terminal_kernel,
    simulate_logsv_terminal_torch,
    simulate_rough_terminal_cuda,
    simulate_rough_terminal_kernel,
    simulate_rough_terminal_torch,
)
from stochvolmodels_torch.ops.gauss import erfcc, ncdf, npdf  # noqa: F401
from stochvolmodels_torch.ops.mgf import (  # noqa: F401
    compute_integration_weights,
    digital_prices_with_mgf_grid,
    digital_slice_pricer_with_mgf_grid,
    get_phi_grid,
    get_psi_grid,
    get_theta_grid,
    get_transform_var_grid,
    pdf_with_mgf_grid,
    qvar_prices_with_mgf_grid,
    slice_qvar_pricer_with_a_grid,
    slice_pricer_with_mgf_grid_with_gamma,
    vanilla_prices_with_mgf_grid,
    vanilla_slice_pricer_with_mgf_grid,
)
from stochvolmodels_torch.ops.lm import lm_init, lm_minimize, lm_step  # noqa: F401
from stochvolmodels_torch.ops.payoffs import compute_mc_vars_payoff, mc_vars_payoff  # noqa: F401
from stochvolmodels_torch.ops.random import antithetic_step_normals, generator_from_seed  # noqa: F401
from stochvolmodels_torch.ops.tdist import (  # noqa: F401
    cdf_tdist,
    compute_default_prob_tdist,
    compute_forward_tdist,
    compute_upsilon,
    compute_vanilla_price_tdist,
    cum_mean_tdist,
    imply_drift_tdist,
    infer_implied_vol_tdist,
    infer_tdist_implied_vols_from_model_slice_prices,
    pdf_tdist,
)
from stochvolmodels_torch.utils.funcs import (  # noqa: F401
    SeriesLike,
    compute_histogram_data,
    find_nearest,
    npad,
    set_seed,
    set_time_grid,
    timer,
    to_flat_np_array,
    unpad,
    update_kwargs,
)
from stochvolmodels_torch.utils.var_swap import compute_var_swap_strike  # noqa: F401

__version__ = "0.1.0"
