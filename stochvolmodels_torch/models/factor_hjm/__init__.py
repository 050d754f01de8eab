from stochvolmodels_torch.models.factor_hjm.double_exp_pricer import de_pricer  # noqa: F401
from stochvolmodels_torch.models.factor_hjm.fast_calibration import (  # noqa: F401
    calibrate_rate_logsv_cube_lm_on_device,
    calibrate_rate_logsv_full,
    calibrate_rate_logsv_lm_on_device,
    calibrate_rate_logsv_term_structure,
    prefit_A_to_atm,
    swaption_chain_to_cube,
)
from stochvolmodels_torch.models.factor_hjm.factor_hjm_pricer import (  # noqa: F401
    calc_mc_vols,
    do_mc_simulation,
)
from stochvolmodels_torch.models.factor_hjm.rate_affine_expansion import (  # noqa: F401
    UnderlyingType,
    compute_logsv_a_mgf_grid,
)
from stochvolmodels_torch.models.factor_hjm.rate_factor_basis import (  # noqa: F401
    BasisHJM,
    Cheyette1D,
    CheyettePEND,
    NelsonSiegel,
)
from stochvolmodels_torch.models.factor_hjm.rate_logsv_params import (  # noqa: F401
    MultiFactRateLogSvParams,
    RateLogSvParams,
    TermStructure,
)
from stochvolmodels_torch.models.factor_hjm.rate_logsv_pricer import (  # noqa: F401
    FutSettleType,
    Measure,
    RateFutLogSVPricer,
    RateLogSVPricer,
    calc_futures_rate,
    futures_conv_adj,
    logsv_chain_de_pricer,
    make_swaption_cube_fn,
    make_swaption_cube_fn_traced,
    make_swaption_slice_fn,
    simulate_logsv_MF,
)
