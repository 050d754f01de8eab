"""The port's plotting modules and ``ModelPricer.plot_*``, on the CPU (Agg).

* Every case of ``tests/test_plotting.py`` renders on the port (Heston on
  BTC, as there).
* The analytic plots (``plot_model_ivols``, ``plot_model_ivols_vs_bid_ask``,
  ``plot_model_slices_in_params``) draw every ``Line2D`` and every marker
  collection with the x and y data of the JAX package's figure to 1e-9,
  under the same titles, axis labels and legend texts.
* ``plot_model_ivols_vs_mc``: the model lines equal the JAX package's to
  1e-9; the MC bands come from different random streams, so each slice's
  band on the port overlaps the JAX package's wherever both are finite.
* ``vol_slice_fit``, ``model_vols_ts``, ``model_param_ts`` and
  ``plot_model_risk_var`` on the same pandas input draw the same data.
* ``fig_to_pdf``, ``fig_list_to_pdf`` and ``save_fig`` write their files.
"""
import matplotlib

matplotlib.use("Agg")

import matplotlib.pyplot as plt  # noqa: E402
import numpy as np  # noqa: E402
import pandas as pd  # noqa: E402
import pytest  # noqa: E402
from _torch_port import svj, svt  # noqa: E402,F401

from stochvolmodels_tpu.plotting import plots as jplots  # noqa: E402
from stochvolmodels_torch.plotting import plots as tplots  # noqa: E402

HIGH_KAPPA = dict(v0=0.8, theta=1.0, kappa=8.0, rho=0.0, volvol=2.0)


@pytest.fixture(scope="module")
def chains():
    return svj.get_btc_test_chain_data(), svt.get_btc_test_chain_data()


@pytest.fixture(autouse=True)
def _close_figures():
    yield
    plt.close("all")


def texts(fig):
    """(title, x label, y label, legend texts) of each axis."""
    out = []
    for ax in fig.axes:
        legend = ax.get_legend()
        out.append((ax.get_title(), ax.get_xlabel(), ax.get_ylabel(),
                    [t.get_text() for t in legend.get_texts()] if legend else None))
    return out


def assert_same_drawing(fig_t, fig_j, rtol=1e-9):
    """every line's and every marker collection's data equal, axis by axis."""
    assert len(fig_t.axes) == len(fig_j.axes)
    assert texts(fig_t) == texts(fig_j)
    for ax_t, ax_j in zip(fig_t.axes, fig_j.axes):
        lines_t, lines_j = ax_t.get_lines(), ax_j.get_lines()
        assert len(lines_t) == len(lines_j) and len(lines_t) >= 1
        for lt, lj in zip(lines_t, lines_j):
            for a, b in ((lt.get_xdata(), lj.get_xdata()), (lt.get_ydata(), lj.get_ydata())):
                np.testing.assert_allclose(np.asarray(a, float), np.asarray(b, float), rtol=rtol)
        assert len(ax_t.collections) == len(ax_j.collections)
        for ct, cj in zip(ax_t.collections, ax_j.collections):
            np.testing.assert_allclose(ct.get_offsets(), cj.get_offsets(), rtol=rtol)


# ---------------------------------------------------------------- tests/test_plotting.py's cases

def test_vol_slice_fit_renders():
    strikes = np.linspace(90.0, 110.0, 5)
    fig = tplots.vol_slice_fit(
        bid_vol=pd.Series(np.full(5, 0.19), index=strikes),
        ask_vol=pd.Series(np.full(5, 0.21), index=strikes),
        model_vols=pd.Series(np.full(5, 0.2), index=strikes, name='model'),
        title='test', atm_points={'ATM': (100.0, 0.2)})
    assert fig is not None and len(fig.axes) == 1


def test_model_vols_ts_renders():
    strikes = np.linspace(90.0, 110.0, 5)
    df = pd.DataFrame({'1m': np.full(5, 0.2), '3m': np.full(5, 0.22)}, index=strikes)
    assert tplots.model_vols_ts(model_vols=df, title='vols') is not None


def test_param_ts_and_risk_var_render():
    ts = pd.DataFrame({'sigma0': [0.8, 0.9], 'theta': [1.0, 1.1]}, index=[0, 1])
    assert tplots.model_param_ts(param_ts=ts, title='params') is not None
    x = np.linspace(-1, 1, 50)
    assert tplots.plot_model_risk_var(pd.Series(np.exp(-x * x), index=x)) is not None


def test_pricer_plot_ivols_vs_bid_ask(chains):
    fig = svt.HestonPricer(device="cpu").plot_model_ivols_vs_bid_ask(
        option_chain=chains[1], params=svt.BTC_HESTON_PARAMS)
    assert len(fig.axes) == 4  # 2x2 layout for 4 slices
    for ax in fig.axes:
        assert len(ax.lines) >= 1 and len(ax.collections) >= 2


def test_pricer_plot_model_ivols(chains):
    assert svt.HestonPricer(device="cpu").plot_model_ivols(
        option_chain=chains[1], params=svt.BTC_HESTON_PARAMS) is not None


def test_pricer_plot_slices_in_params(chains):
    chain = chains[1]
    fig = svt.HestonPricer(device="cpu").plot_model_slices_in_params(
        option_slice=chain.get_slice(chain.ids[1]),
        params_dict={'base': svt.BTC_HESTON_PARAMS, 'high kappa': svt.HestonParams(**HIGH_KAPPA)})
    assert fig is not None


def test_pricer_plot_ivols_vs_mc(chains):
    fig = svt.HestonPricer(device="cpu").plot_model_ivols_vs_mc(
        option_chain=chains[1], params=svt.BTC_HESTON_PARAMS, nb_path=20000)
    assert len(fig.axes) == 4


def test_fig_export(tmp_path):
    fig, ax = plt.subplots()
    ax.plot([0, 1], [0, 1])
    assert tplots.save_fig(fig, 'test_fig', local_path=str(tmp_path)) == str(tmp_path / 'test_fig.PNG')
    assert (tmp_path / 'test_fig.PNG').stat().st_size > 0
    tplots.fig_to_pdf(fig, 'test_fig', local_path=str(tmp_path))
    assert (tmp_path / 'test_fig.pdf').stat().st_size > 0
    tplots.fig_list_to_pdf([fig, fig], 'two_figs', local_path=str(tmp_path))
    assert (tmp_path / 'two_figs.pdf').stat().st_size > 0


# ---------------------------------------------------------------- against the JAX package's figures

def test_plot_model_ivols_draws_the_jax_figure(chains):
    cj, ct = chains
    fig_j = svj.HestonPricer().plot_model_ivols(option_chain=cj, params=svj.BTC_HESTON_PARAMS)
    fig_t = svt.HestonPricer(device="cpu").plot_model_ivols(option_chain=ct,
                                                            params=svt.BTC_HESTON_PARAMS)
    assert_same_drawing(fig_t, fig_j)


def test_plot_model_ivols_vs_bid_ask_draws_the_jax_figure(chains):
    cj, ct = chains
    fig_j = svj.HestonPricer().plot_model_ivols_vs_bid_ask(option_chain=cj,
                                                           params=svj.BTC_HESTON_PARAMS,
                                                           is_log_strike_xaxis=True)
    fig_t = svt.HestonPricer(device="cpu").plot_model_ivols_vs_bid_ask(
        option_chain=ct, params=svt.BTC_HESTON_PARAMS, is_log_strike_xaxis=True)
    assert_same_drawing(fig_t, fig_j)


def test_plot_model_slices_in_params_draws_the_jax_figure(chains):
    cj, ct = chains
    fig_j = svj.HestonPricer().plot_model_slices_in_params(
        option_slice=cj.get_slice(cj.ids[1]),
        params_dict={'base': svj.BTC_HESTON_PARAMS, 'high kappa': svj.HestonParams(**HIGH_KAPPA)})
    fig_t = svt.HestonPricer(device="cpu").plot_model_slices_in_params(
        option_slice=ct.get_slice(ct.ids[1]),
        params_dict={'base': svt.BTC_HESTON_PARAMS, 'high kappa': svt.HestonParams(**HIGH_KAPPA)})
    assert_same_drawing(fig_t, fig_j)


def test_plot_model_ivols_vs_mc_within_the_mc_band(chains):
    cj, ct = chains
    fig_j = svj.HestonPricer().plot_model_ivols_vs_mc(option_chain=cj,
                                                      params=svj.BTC_HESTON_PARAMS, nb_path=20000)
    fig_t = svt.HestonPricer(device="cpu").plot_model_ivols_vs_mc(
        option_chain=ct, params=svt.BTC_HESTON_PARAMS, nb_path=20000)
    assert len(fig_t.axes) == len(fig_j.axes) == 4
    for ax_t, ax_j in zip(fig_t.axes, fig_j.axes):
        assert ax_t.get_title() == ax_j.get_title()
        np.testing.assert_allclose(ax_t.get_lines()[0].get_ydata(),
                                   ax_j.get_lines()[0].get_ydata(), rtol=1e-9)
        (lo_t, hi_t), (lo_j, hi_j) = ([c.get_offsets()[:, 1] for c in ax.collections[:2]]
                                      for ax in (ax_t, ax_j))
        ok = np.isfinite(lo_t) & np.isfinite(hi_t) & np.isfinite(lo_j) & np.isfinite(hi_j)
        assert ok.mean() > 0.8
        # the two bands overlap: |mid_t - mid_j| <= half width_t + half width_j
        gap = np.abs(0.5 * (lo_t + hi_t) - 0.5 * (lo_j + hi_j))[ok]
        assert np.all(gap <= 0.5 * (hi_t - lo_t + hi_j - lo_j)[ok]), gap


PANDAS_CASES = {
    "vol_slice_fit": lambda m: m.vol_slice_fit(
        bid_vol=pd.Series([0.19, 0.18, 0.2], index=[90.0, 100.0, 110.0]),
        ask_vol=pd.Series([0.21, 0.2, 0.23], index=[90.0, 100.0, 110.0]),
        model_vols=pd.DataFrame({'a': [0.2, 0.19, 0.21], 'b': [0.22, 0.2, 0.2]},
                                index=[90.0, 100.0, 110.0]),
        is_add_mids=True, title='fit', atm_points={'ATM': (100.0, 0.2)}),
    "model_vols_ts": lambda m: m.model_vols_ts(
        model_vols=pd.DataFrame({'1m': [0.3, 0.2, 0.25], '3m': [0.28, 0.22, 0.24]},
                                index=[0.25, 0.5, 0.75]), is_delta_space=True, title='delta'),
    "model_param_ts": lambda m: m.model_param_ts(
        param_ts=pd.DataFrame({'sigma0': [0.8, 0.9, 0.85], 'theta': [1.0, 1.1, 1.05]},
                              index=[0, 1, 2]), title='params'),
    "plot_model_risk_var": lambda m: m.plot_model_risk_var(
        pd.DataFrame({'p': np.exp(-np.linspace(-1, 1, 21) ** 2),
                      'q': np.exp(-2 * np.linspace(-1, 1, 21) ** 2)},
                     index=np.linspace(-1, 1, 21)), title='density'),
}


@pytest.mark.parametrize("case", list(PANDAS_CASES))
def test_plots_draw_the_jax_packages_data(case):
    fig_t, fig_j = PANDAS_CASES[case](tplots), PANDAS_CASES[case](jplots)
    assert_same_drawing(fig_t, fig_j, rtol=0.0)
    assert [[t.get_text() for t in ax.get_xticklabels()] for ax in fig_t.axes] == \
        [[t.get_text() for t in ax.get_xticklabels()] for ax in fig_j.axes]


def test_helpers_match_the_jax_packages():
    deltas = np.array([-0.25, -0.251, 0.5, 0.5004, 0.75])
    assert tplots.map_deltas_to_str(deltas) == jplots.map_deltas_to_str(deltas)
    assert tplots.to_flat_list([[1, [2, 3]], 4]) == jplots.to_flat_list([[1, [2, 3]], 4])
    assert tplots.get_n_sns_colors(3) == jplots.get_n_sns_colors(3)
    fig, axs = plt.subplots(1, 2)
    axs[0].plot([0, 1], [0, 1])
    axs[1].plot([0, 2], [1, 3])
    tplots.align_x_limits_axs(axs)
    tplots.align_y_limits_axs(axs)
    tplots.set_y_limits(axs[0], (None, 5.0))
    tplots.set_subplot_border(fig, n_ax_col=2)
    assert axs[0].get_xlim() == axs[1].get_xlim() and axs[0].get_ylim()[1] == 5.0
    assert len(fig.patches) == 3
