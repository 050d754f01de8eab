"""The ``OptionChain`` analytics and ``utils/funcs.py`` helpers of the PyTorch
port against the JAX package on the bundled chains: deltas, skews, the
uniform chains, ``get_slice``, ``print``, ``set_seed``, ``update_kwargs`` and
``compute_histogram_data``, to 1e-14 (exact where the code is the same
numpy), and the ``ChainGrid`` helpers.
"""
import numpy as np
import pytest
import torch

import stochvolmodels_torch as svt
import stochvolmodels_tpu as svj
from stochvolmodels_torch.utils import funcs as tf
from stochvolmodels_tpu.utils import funcs as jf

LOADERS = ("get_btc_test_chain_data", "get_spy_test_chain_data", "get_gld_test_chain_data",
           "get_vix_test_chain_data")


@pytest.mark.parametrize("loader", LOADERS)
def test_deltas_and_skews_match(loader):
    ct, cj = getattr(svt, loader)(), getattr(svj, loader)()
    for a, b in zip(ct.get_chain_deltas(), cj.get_chain_deltas()):
        np.testing.assert_allclose(a, np.asarray(b), rtol=1e-14, atol=1e-14)
    np.testing.assert_allclose(ct.get_chain_skews(), cj.get_chain_skews(), rtol=1e-14,
                               atol=1e-14)
    np.testing.assert_allclose(ct.get_chain_skews(delta=0.1), cj.get_chain_skews(delta=0.1),
                               rtol=1e-14, atol=1e-14)


def test_uniform_chains_and_slices_match(capsys):
    ct, cj = svt.OptionChain.get_uniform_chain(), svj.OptionChain.get_uniform_chain()
    for field in ("ttms", "forwards", "ids"):
        np.testing.assert_array_equal(getattr(ct, field), getattr(cj, field))
    for a, b in zip(ct.strikes_ttms + ct.bid_ivs + ct.optiontypes_ttms,
                    cj.strikes_ttms + cj.bid_ivs + cj.optiontypes_ttms):
        np.testing.assert_array_equal(a, b)
    bt, bj = svt.get_btc_test_chain_data(), svj.get_btc_test_chain_data()
    ut = svt.OptionChain.to_uniform_strikes(bt, num_strikes=11)
    uj = svj.OptionChain.to_uniform_strikes(bj, num_strikes=11)
    for a, b in zip(ut.strikes_ttms + ut.optiontypes_ttms, uj.strikes_ttms + uj.optiontypes_ttms):
        np.testing.assert_array_equal(a, b)
    assert ut.bid_ivs is None and ut.ids.tolist() == uj.ids.tolist()
    st, sj = bt.get_slice(bt.ids[2]), bj.get_slice(bj.ids[2])
    for field in ("ttm", "forward", "discfactor", "discount_rate", "id"):
        assert getattr(st, field) == getattr(sj, field)
    for field in ("strikes", "optiontypes", "bid_ivs", "ask_ivs"):
        np.testing.assert_array_equal(getattr(st, field), getattr(sj, field))
    bt.print()
    ours = capsys.readouterr().out
    bj.print()
    assert ours == capsys.readouterr().out


def test_funcs_helpers_match():
    tf.set_seed(17)
    a = np.random.normal(size=5)
    jf.set_seed(17)
    np.testing.assert_array_equal(a, np.random.normal(size=5))
    base = {"a": 1, "b": 2}
    assert tf.update_kwargs(base, {"b": 3}) == jf.update_kwargs(base, {"b": 3}) == {"a": 1, "b": 3}
    assert tf.update_kwargs(base, None) == base and base == {"a": 1, "b": 2}
    data, grid = np.random.default_rng(2).normal(size=5000), np.linspace(-3.0, 3.0, 41)
    ht, hj = tf.compute_histogram_data(data, grid, name="x"), jf.compute_histogram_data(data, grid,
                                                                                         name="x")
    np.testing.assert_allclose(ht.to_numpy(), hj.to_numpy(), rtol=1e-14, atol=0)
    np.testing.assert_array_equal(ht.index, np.asarray(hj.index))
    assert ht.name == hj.name == "x"


def test_chain_grid_helpers():
    chain = svt.get_btc_test_chain_data()
    grid = chain.to_grid(device="cpu")
    assert grid.n_ttms == len(chain.ttms)
    assert grid.max_strikes == max(len(s) for s in chain.strikes_ttms)
    panel = torch.ones(grid.strikes.shape, dtype=torch.float64)
    masked = grid.masked(panel).numpy()
    assert np.array_equal(np.isnan(masked), ~grid.mask.numpy())
    assert np.all(grid.masked(panel, fill=0.0).numpy().sum(axis=1)
                  == [len(s) for s in chain.strikes_ttms])
