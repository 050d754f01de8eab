"""
stochvolmodels_torch: the PyTorch and CUDA port of stochvolmodels_tpu.

It imports torch, numpy and scipy only — never jax and nothing of the JAX
package, which stays beside it as the reference the port is tested against.
It serves pricing requests for the flagship LogSV model (analytic chain
prices through the affine-expansion Fourier engine, BSM implied vols, Monte
Carlo, the rough lift's Monte Carlo, and calibration to a chain by SLSQP,
Levenberg-Marquardt as one CUDA graph, or Adam), for Heston (closed-form Fourier
prices, Monte Carlo, and calibration by SLSQP with the Feller constraint or by
Levenberg-Marquardt) and for the Hawkes jump-diffusion model (Riccati Fourier
prices as one CUDA graph a reprice, the risk-premia pricer, thinning Monte
Carlo, and calibration by SLSQP, by Levenberg-Marquardt, and of the risk
premia).  Every Monte-Carlo path loop runs in a hand-written
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
from stochvolmodels_torch.data.option_chain import ChainGrid, OptionChain, OptionSlice  # noqa: F401
from stochvolmodels_torch.data.sample_chains import get_btc_test_chain_data  # noqa: F401
from stochvolmodels_torch.interop import (  # noqa: F401
    chain_from_numpy,
    hawkes_params_from_numpy,
    heston_params_from_numpy,
    params_from_numpy,
)
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
    v0_implied,
)
from stochvolmodels_torch.models.logsv.affine import (  # noqa: F401
    ExpansionOrder,
    func_a_ode_quadratic_terms,
    get_expansion_n,
    get_init_conditions_a,
    solve_a_ode_grid,
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
    logsv_chain_price_grid,
    logsv_mc_chain_pricer,
    set_vol_scaler,
    simulate_logsv_terminal,
)
from stochvolmodels_torch.models.model_pricer import ModelParams, ModelPricer  # noqa: F401
from stochvolmodels_torch.models.rough.kernel import european_rule  # noqa: F401
from stochvolmodels_torch.models.rough.simulation import (  # noqa: F401
    log_spot_full_combined,
    rough_logsv_mc_chain_pricer,
    strang_step,
)
from stochvolmodels_torch.ops.bsm import (  # noqa: F401
    compute_bsm_vanilla_price,
    compute_bsm_vanilla_vega,
    infer_bsm_implied_vol,
    infer_bsm_implied_vol_fast,
    infer_bsm_ivols_from_model_chain_prices,
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
    get_phi_grid,
    get_transform_var_grid,
    slice_pricer_with_mgf_grid_with_gamma,
    vanilla_prices_with_mgf_grid,
    vanilla_slice_pricer_with_mgf_grid,
)
from stochvolmodels_torch.ops.lm import lm_init, lm_minimize, lm_step  # noqa: F401
from stochvolmodels_torch.ops.payoffs import compute_mc_vars_payoff  # noqa: F401
from stochvolmodels_torch.utils.funcs import (  # noqa: F401
    find_nearest,
    npad,
    set_time_grid,
    timer,
    to_flat_np_array,
    unpad,
)
