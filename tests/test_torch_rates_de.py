"""The adaptive tanh-sinh swaption pricer of the PyTorch port against the JAX
package, on the CPU: the 1y row of the USD swaption cube (3 tenors x 9
strikes, ``papers/sv_for_factor_hjm/calibration_fig_5_6_7.py``) with the
paper's fitted parameters, through ``logsv_chain_de_pricer``.

Both packages run the same host refinement loop (``de_pricer``), so they
make the same ``ff`` calls (66 for this row) on the same node batches:
prices 1e-12 absolute, normal ivols 1e-9.  On a card each padded batch is
one captured graph of the RK4; the padding bounds the graphs to one per
power of two.
"""
import jax
import numpy as np
import pytest
from test_torch_rates_core import usd_cube_pair

from stochvolmodels_tpu.models.factor_hjm import rate_logsv_pricer as jrp
from stochvolmodels_tpu.utils.rate_core import generate_ttms_grid
from stochvolmodels_torch.models.factor_hjm import double_exp_pricer as tde
from stochvolmodels_torch.models.factor_hjm import rate_logsv_pricer as trp


@pytest.fixture(scope="module")
def row():
    cj, pj, _, pt = usd_cube_pair()
    t_grid = generate_ttms_grid(cj.ttms[:4])
    kw = dict(t_grid=t_grid, ttms=np.array([cj.ttms[0]]),
              forwards=[cj.forwards[i][[0]] for i in range(3)],
              strikes_ttms=[[cj.strikes_ttms[i][0]] for i in range(3)],
              optiontypes_ttms=[cj.optiontypes_ttms[0]])
    batches = []
    padded = tde._call_padded

    def counting(ff, x_k):
        batches.append(x_k.shape[0])
        return padded(ff, x_k)
    tde._call_padded = counting
    try:
        ours = trp.logsv_chain_de_pricer(pt, device="cpu", **kw)
    finally:
        tde._call_padded = padded
    ref = jrp.logsv_chain_de_pricer(pj, **kw)
    yield ref, ours, batches
    import gc
    jax.clear_caches()
    gc.collect()


@pytest.mark.parametrize("tenor", [0, 1, 2])
def test_de_prices_match(row, tenor):
    (ref_p, _), (ours_p, _), *_ = row
    assert ours_p[tenor][0].shape == (1, 9)
    np.testing.assert_allclose(ours_p[tenor][0], np.asarray(ref_p[tenor][0]), rtol=0, atol=1e-12)


@pytest.mark.parametrize("tenor", [0, 1, 2])
def test_de_normal_ivols_match(row, tenor):
    (_, ref_iv), (_, ours_iv), _ = row
    assert np.all(np.isfinite(ours_iv[tenor][0]))
    np.testing.assert_allclose(ours_iv[tenor][0], np.asarray(ref_iv[tenor][0]), rtol=0, atol=1e-9)


def test_de_ff_calls_and_padded_batches(row):
    *_, batches = row
    assert len(batches) == 66
    padded = {1 << max(n - 1, 0).bit_length() for n in batches}
    assert padded <= {1, 2, 4, 8, 16, 32, 64}
