"""Chain construction from in-memory option frames in the PyTorch port
(``stochvolmodels_torch/data/fetch_option_chain.py``).

The same frames go through the JAX package's module and the port's, and
every field of the two ``OptionChain`` results is held equal bit for bit
(same values, same dtypes): host numpy and pandas with the same arithmetic
in the same order.  The frames are ``tests/test_chain_data.py``'s synthetic
expiries (both days-maps, overlapping horizons, no delta filter,
``is_filtered`` both ways) and one chain drawn from
``np.random.default_rng(7)``.  The optional ``option_chain_analytics``
package (OCA) behaves the same in both: absent, the live fetch raises;
a mocked module in ``sys.modules`` runs the full adapter.  The port's
module imports with pandas hidden.
"""
import dataclasses
import os
import subprocess
import sys
import types
from pathlib import Path

import numpy as np
import pandas as pd
import pytest

from stochvolmodels_tpu.data import fetch_option_chain as jfc
from stochvolmodels_torch.data import fetch_option_chain as tfc

REPO = Path(__file__).resolve().parents[1]
VALUE_TIME = pd.Timestamp('2021-11-01 08:00:00+00:00')
DAYS_MAPS = [None, {'1w': 7, '1m': 21}, {'1m': 21, '3m': 90, '6m': 180}]


def synthetic_slice(fc, expiry_id, ttm, forward):
    """one expiry of tests/test_chain_data.py: both sides quoted on seven
    strikes, far wings with tiny |delta|, the 130 call without a bid vol."""
    put_deltas = {50.0: -0.02, 70.0: -0.10, 90.0: -0.25, 100.0: -0.45,
                  110.0: -0.65, 130.0: -0.85, 160.0: -0.95}
    rows = []
    for k, put_delta in put_deltas.items():
        for ot, delta in (('P', put_delta), ('C', 1.0 + put_delta)):
            iv = 0.5 + 0.3 * abs(np.log(k / forward))
            rows.append(dict(strike=k, optiontype=ot, delta=delta, bid_iv=iv - 0.02,
                             ask_iv=iv + 0.02, bid_price=1.0, ask_price=1.2))
    df = pd.DataFrame(rows)
    df.loc[(df.strike == 130.0) & (df.optiontype == 'C'), 'bid_iv'] = np.nan
    return fc.ExpirySlice(expiry_id=expiry_id, ttm=ttm, future_price=forward, df=df)


def synthetic_chain(fc):
    return fc.SlicesChain(expiry_slices={
        VALUE_TIME + pd.DateOffset(days=9): synthetic_slice(fc, '09NOV', 9 / 365, 100.0),
        VALUE_TIME + pd.DateOffset(days=23): synthetic_slice(fc, '23NOV', 23 / 365, 101.0),
    })


def random_chain(fc, seed=7):
    """five expiries of 5-40 days, 21 strikes around a forward near 100,
    both option types, random deltas and vols, some dead markets (NaN or
    zero vols); the keys inserted out of order."""
    rng = np.random.default_rng(seed)
    slices = {}
    for day in rng.permutation([5, 12, 19, 26, 40]):
        forward = float(100.0 * np.exp(rng.normal(0.0, 0.05)))
        strikes = np.round(np.sort(forward * np.exp(rng.normal(0.0, 0.25, 21))), 1)
        call_delta = np.clip(0.5 - 1.5 * np.log(strikes / forward) + rng.normal(0, 0.02, 21),
                             0.001, 0.999)
        rows = []
        for k, cd in zip(strikes, call_delta):
            for ot, delta in (('C', cd), ('P', cd - 1.0)):
                iv = 0.6 + 0.4 * abs(np.log(k / forward)) + rng.normal(0.0, 0.01)
                bid = iv - abs(rng.normal(0.01, 0.005))
                rows.append(dict(strike=k, optiontype=ot, delta=delta,
                                 bid_iv=[bid, np.nan, 0.0][rng.choice(3, p=[0.85, 0.1, 0.05])],
                                 ask_iv=iv + abs(rng.normal(0.01, 0.005)),
                                 bid_price=rng.uniform(0.5, 2.0), ask_price=rng.uniform(2.0, 3.0)))
        slices[VALUE_TIME + pd.DateOffset(days=int(day))] = fc.ExpirySlice(
            expiry_id=f"D{day}", ttm=day / 365.0, future_price=forward, df=pd.DataFrame(rows))
    return fc.SlicesChain(expiry_slices=slices)


def assert_same_chain(ours, ref):
    """every field of the port's OptionChain equals the JAX one's: the
    same arrays, dtypes and ragged lengths, bit for bit."""
    names = [f.name for f in dataclasses.fields(ref)]
    assert [f.name for f in dataclasses.fields(ours)] == names
    for name in names:
        a, b = getattr(ours, name), getattr(ref, name)
        if b is None or isinstance(b, str):
            assert a == b, name
        elif isinstance(b, np.ndarray):
            assert a.dtype == b.dtype and np.array_equal(a, b, equal_nan=a.dtype.kind == "f"), name
        else:
            assert len(a) == len(b), name
            for x, y in zip(a, b):
                assert x.dtype == y.dtype and np.array_equal(
                    x, y, equal_nan=x.dtype.kind == "f"), name


@pytest.mark.parametrize("days_map", DAYS_MAPS, ids=["default", "1w-1m", "overlapping"])
@pytest.mark.parametrize("delta_bounds", [(-0.1, 0.1), None, (None, 0.25)],
                         ids=["deltas", "no-deltas", "call-floor"])
@pytest.mark.parametrize("is_filtered", [True, False], ids=["filtered", "unfiltered"])
def test_synthetic_frames_give_the_jax_chain_bit_for_bit(days_map, delta_bounds, is_filtered):
    kw = dict(days_map=days_map, delta_bounds=delta_bounds, is_filtered=is_filtered)
    ours = tfc.generate_vol_chain_np(synthetic_chain(tfc), VALUE_TIME, **kw)
    ref = jfc.generate_vol_chain_np(synthetic_chain(jfc), VALUE_TIME, **kw)
    assert_same_chain(ours, ref)
    assert len(ours.ttms) == (1 if days_map and '3m' in days_map else 2)


@pytest.mark.parametrize("is_filtered", [True, False], ids=["filtered", "unfiltered"])
def test_a_random_chain_gives_the_jax_chain_bit_for_bit(is_filtered):
    days_map = {'1w': 7, '2w': 14, '1m': 30, '2m': 60}
    ours = tfc.generate_vol_chain_np(random_chain(tfc), VALUE_TIME, days_map=days_map,
                                     is_filtered=is_filtered)
    ref = jfc.generate_vol_chain_np(random_chain(jfc), VALUE_TIME, days_map=days_map,
                                    is_filtered=is_filtered)
    assert_same_chain(ours, ref)
    assert list(ours.ids) == ['1w: D12', '2w: D19', '1m: D40']
    assert all(len(s) > 3 for s in ours.strikes_ttms)
    grid = ours.to_grid(device="cpu")
    assert int(grid.mask.sum()) == sum(len(s) for s in ours.strikes_ttms)


@pytest.mark.parametrize("delta_bounds", [(-0.1, 0.1), None], ids=["deltas", "no-deltas"])
def test_joint_slice_frames_equal_the_jax_frames(delta_bounds):
    ours = tfc.make_joint_slice_df(synthetic_slice(tfc, 'X', 0.1, 100.0).df, forward=100.0,
                                   delta_bounds=delta_bounds, is_filtered=False)
    ref = jfc.make_joint_slice_df(synthetic_slice(jfc, 'X', 0.1, 100.0).df, forward=100.0,
                                  delta_bounds=delta_bounds, is_filtered=False)
    pd.testing.assert_frame_equal(ours, ref, check_exact=True)
    assert len(ours) == (7 if delta_bounds is None else 5)
    slices = random_chain(tfc).expiry_slices
    for ours_slice, ref_slice in zip(slices.values(), random_chain(jfc).expiry_slices.values()):
        pd.testing.assert_frame_equal(ours_slice.get_joint_slice(delta_bounds=delta_bounds),
                                      ref_slice.get_joint_slice(delta_bounds=delta_bounds),
                                      check_exact=True)
    assert list(slices) == sorted(slices)


def test_next_slice_after_date_and_an_empty_chain():
    ours, ref = synthetic_chain(tfc), synthetic_chain(jfc)
    for day in (0, 9, 10, 23, 24, 400):
        date = VALUE_TIME + pd.DateOffset(days=day)
        assert ours.get_next_slice_after_date(date) == ref.get_next_slice_after_date(date)
    for fc in (tfc, jfc):
        with pytest.raises(ValueError, match="no expiry slices"):
            fc.SlicesChain().get_next_slice_after_date(VALUE_TIME)


def test_without_oca_both_packages_raise_the_same_error():
    assert tfc.HAS_OCA == jfc.HAS_OCA is False
    messages = []
    for fc in (tfc, jfc):
        for call in (lambda: fc.load_option_chain(options_data_dfs=object()),
                     lambda: fc.sample_option_chain_at_times(object(), (VALUE_TIME, VALUE_TIME))):
            with pytest.raises(ImportError, match="option-chain-analytics") as info:
                call()
            messages.append(str(info.value))
    assert messages[0] == messages[1] and messages[2] == messages[3]
    assert messages[0] == messages[2].replace("stochvolmodels_tpu", "stochvolmodels_torch")
    assert "stochvolmodels_torch.data.sample_chains" in messages[0]


def test_mocked_oca_runs_the_full_adapter_in_both_packages(monkeypatch):
    """the OCA constructor is resolved at call time: a fake
    ``option_chain_analytics`` in ``sys.modules`` receives the inputs
    verbatim and its chain goes through the real construction, equal in
    both packages; a None chain is passed on as None; the schedule of
    ``sample_option_chain_at_times`` gives the same chains."""
    calls = []
    fake = types.ModuleType('option_chain_analytics')
    fake.OptionsDataDFs = object
    fake.create_chain_from_from_options_dfs = lambda options_data_dfs, value_time: (
        calls.append((options_data_dfs, value_time)) or synthetic_chain(current[0]))
    monkeypatch.setitem(sys.modules, 'option_chain_analytics', fake)
    sentinel = object()
    current = [tfc]
    ours = tfc.load_option_chain(options_data_dfs=sentinel, value_time=VALUE_TIME)
    current[0] = jfc
    ref = jfc.load_option_chain(options_data_dfs=sentinel, value_time=VALUE_TIME)
    assert calls == [(sentinel, VALUE_TIME)] * 2
    assert_same_chain(ours, ref)
    assert list(ours.ids) == ['1w: 09NOV', '1m: 23NOV']

    current[0] = tfc
    default = tfc.load_option_chain(options_data_dfs=sentinel)
    current[0] = jfc
    jdefault = jfc.load_option_chain(options_data_dfs=sentinel)
    assert calls[-1] == calls[-2] == (sentinel, pd.Timestamp('2023-02-06 08:00:00+00:00'))
    assert_same_chain(default, jdefault)

    period = (pd.Timestamp('2021-11-01', tz='UTC'), pd.Timestamp('2021-11-20', tz='UTC'))
    current[0] = tfc
    ours_series = tfc.sample_option_chain_at_times(sentinel, period)
    current[0] = jfc
    ref_series = jfc.sample_option_chain_at_times(sentinel, period)
    assert list(ours_series) == list(ref_series) and len(ours_series) == 3
    for vt in ref_series:
        assert_same_chain(ours_series[vt], ref_series[vt])

    fake.create_chain_from_from_options_dfs = lambda options_data_dfs, value_time: None
    assert tfc.load_option_chain(sentinel, VALUE_TIME) is None
    assert jfc.load_option_chain(sentinel, VALUE_TIME) is None


def test_load_price_data_equals_the_jax_series():
    rng = np.random.default_rng(11)
    index = pd.date_range('2021-10-01', periods=24 * 40, freq='h', tz='UTC')
    spot = pd.DataFrame({'close': 100.0 * np.exp(np.cumsum(rng.normal(0, 0.01, len(index))))},
                        index=index)
    dfs = types.SimpleNamespace(get_spot_data=lambda: spot)
    period = (pd.Timestamp('2021-10-05', tz='UTC'), pd.Timestamp('2021-10-25', tz='UTC'))
    for kw in (dict(), dict(time_period=period), dict(freq=None, time_period=period),
               dict(freq='W-FRI', data='close')):
        pd.testing.assert_series_equal(tfc.load_price_data(dfs, **kw),
                                       jfc.load_price_data(dfs, **kw), check_exact=True)


_NO_PANDAS = r'''
import importlib.abc
import sys

BLOCKED = {"pandas", "jax", "jaxlib", "stochvolmodels_tpu"}


class _Block(importlib.abc.MetaPathFinder):
    def find_spec(self, name, path, target=None):
        if name.split(".")[0] in BLOCKED:
            raise ModuleNotFoundError(f"blocked import: {name}")
        return None


sys.meta_path.insert(0, _Block())
for name in BLOCKED:
    sys.modules[name] = None
from stochvolmodels_torch.data import fetch_option_chain as fc

assert fc.HAS_OCA is False and fc.SliceColumn is None
try:
    fc.load_option_chain(options_data_dfs=object())
except ImportError as exc:
    assert "option-chain-analytics" in str(exc), exc
else:
    raise AssertionError("load_option_chain ran without OCA")
loaded = sorted(m for m, mod in sys.modules.items() if m.split(".")[0] in BLOCKED and mod is not None)
assert not loaded, loaded
print("ok")
'''


def test_the_module_imports_with_pandas_hidden():
    out = subprocess.run([sys.executable, "-c", _NO_PANDAS], cwd=REPO, capture_output=True,
                         text=True, timeout=120, env=dict(os.environ, PYTHONPATH=str(REPO)))
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip().splitlines()[-1] == "ok"
