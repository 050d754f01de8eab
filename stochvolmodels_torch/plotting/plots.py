"""
Plotting utilities: smile-fit panels, vol term plots, figure export helpers.

PyTorch port's copy of ``stochvolmodels_tpu/plotting/plots.py``, with the
same figure vocabulary: ``vol_slice_fit`` (bid/ask markers + model curve +
ATM star), ``model_vols_ts`` (one line per maturity), ``model_param_ts``,
``plot_model_risk_var`` (densities), and PDF/PNG savers.  matplotlib,
seaborn and pandas are imported inside the functions that use them: the
port imports, and prices, on a host that has none of them (the GPU
machine); plotting needs them.
"""
from __future__ import annotations

import datetime as dt
from os.path import join
from typing import TYPE_CHECKING, Any, Dict, Iterable, List, Literal, Optional, Tuple, Union

import numpy as np

if TYPE_CHECKING:
    import matplotlib.pyplot as plt
    import pandas as pd
    from matplotlib.lines import Line2D

DATE_TIME_FORMAT = '%Y%m%d_%H%M'
FIGSIZE = (18, 10)


def set_fig_props(size: int = 14) -> None:
    """set global font sizes for the package figures."""
    import seaborn as sns
    sns.set_context("talk", rc={'font.size': size, 'axes.titlesize': size,
                                'axes.labelsize': size, 'legend.fontsize': size})


def get_n_sns_colors(n: int) -> List[str]:
    import seaborn as sns
    return sns.color_palette(None, n)


def create_dummy_line(**kwargs) -> Line2D:
    from matplotlib.lines import Line2D
    return Line2D([], [], **kwargs)


def _fmt_axis(ax, xvar_format: Optional[str], yvar_format: Optional[str],
              x_rotation: int = 0) -> None:
    import matplotlib.ticker as mticker
    if xvar_format is not None:
        ax.xaxis.set_major_formatter(
            mticker.FuncFormatter(lambda z, _: xvar_format.format(z)))
    if yvar_format is not None:
        ax.yaxis.set_major_formatter(
            mticker.FuncFormatter(lambda z, _: yvar_format.format(z)))
    if x_rotation:
        for tick in ax.get_xticklabels():
            tick.set_rotation(x_rotation)


def set_legend_colors(ax, text_weight: Optional[str] = None,
                      colors: Optional[List[str]] = None,
                      fontsize: int = 12, **kwargs) -> None:
    """recolour legend text to match line colours (plots.py reference
    signature: optional explicit colors and font weight)."""
    leg = ax.get_legend()
    if leg is None:
        return
    if colors is None:
        colors = [line.get_color() for line in leg.get_lines()]
    for text, color in zip(leg.get_texts(), colors):
        text.set_color(color)
        text.set_size(fontsize)
        if text_weight is not None:
            text.set_weight(text_weight)


def vol_slice_fit(bid_vol: pd.Series,
                  ask_vol: pd.Series,
                  model_vols: Union[pd.Series, pd.DataFrame],
                  title: Optional[str] = None,
                  strike_name: str = 'strike',
                  bid_name: str = 'bid',
                  ask_name: str = 'ask',
                  mid_name: str = 'mid',
                  model_color: str = 'black',
                  bid_color: str = 'red',
                  ask_color: str = 'green',
                  mid_color: str = 'slateblue',
                  is_add_mids: bool = False,
                  atm_points: Optional[Dict[str, Tuple[float, float]]] = None,
                  yvar_format: str = '{:.0%}',
                  xvar_format: Optional[str] = '{:0,.0f}',
                  fontsize: int = 12,
                  ylabel: str = 'Implied vols',
                  x_rotation: int = 0,
                  ax=None,
                  **kwargs) -> Optional[plt.Figure]:
    """one-slice smile panel: model curve(s) vs bid/ask markers + ATM star."""
    import matplotlib.pyplot as plt
    import pandas as pd
    import seaborn as sns
    fig = None
    if ax is None:
        fig, ax = plt.subplots(1, 1, figsize=(8, 8))
    if isinstance(model_vols, pd.Series):
        model_vols = model_vols.to_frame()

    legend_entries = []
    palette = ([model_color] if len(model_vols.columns) == 1
               else sns.husl_palette(len(model_vols.columns), h=.5))
    sns.lineplot(data=model_vols, palette=palette, dashes=False, ax=ax)
    for name, color in zip(model_vols.columns, palette):
        legend_entries.append((name, {'color': color}))

    markers = [(bid_vol, bid_name, bid_color), (ask_vol, ask_name, ask_color)]
    if is_add_mids:
        markers.append((0.5 * (bid_vol + ask_vol), mid_name, mid_color))
    for vol, name, color in markers:
        ax.scatter(vol.index.to_numpy(), vol.to_numpy(), color=color, s=40,
                   linewidth=3, marker='_')
        legend_entries.append((name, {'color': color, 'linestyle': '', 'marker': '_'}))

    if atm_points is not None:
        for _, (x, y) in atm_points.items():
            ax.scatter(x, y, marker='*', color='navy', s=40, linewidth=5)
        legend_entries.append(('ATM', {'color': 'navy', 'linestyle': '', 'marker': '*'}))

    ax.legend([create_dummy_line(**props) for _, props in legend_entries],
              [name for name, _ in legend_entries],
              loc='upper center', framealpha=0, fontsize=fontsize)
    set_legend_colors(ax, fontsize=fontsize)
    _fmt_axis(ax, xvar_format, yvar_format, x_rotation)
    ax.set_xlabel(strike_name, fontsize=fontsize)
    ax.set_ylabel(ylabel, fontsize=fontsize)
    if title is not None:
        ax.set_title(title, fontsize=fontsize, color='darkblue')
    return fig


def model_vols_ts(model_vols: Union[pd.Series, pd.DataFrame],
                  is_delta_space: bool = False,
                  xvar_format: str = '{:0,.0f}',
                  yvar_format: str = '{:.0%}',
                  x_rotation: int = 0,
                  xlabel: str = 'strike',
                  n_tickwindow: Optional[int] = None,
                  marker: Optional[str] = None,
                  title: Optional[str] = None,
                  fontsize: int = 10,
                  legend_loc: str = 'upper center',
                  ax=None,
                  **kwargs) -> Optional[plt.Figure]:
    """implied vols across strikes, one line per maturity slice.

    ``is_delta_space`` labels the x axis in BSM deltas (plots.py:272-326);
    ``n_tickwindow`` thins the x ticks to every n-th."""
    import matplotlib.pyplot as plt
    import seaborn as sns
    fig = None
    if ax is None:
        fig, ax = plt.subplots(1, 1, figsize=(8, 8))
    sns.lineplot(data=model_vols, dashes=False, marker=marker, ax=ax)
    ax.legend(loc=legend_loc, fontsize=fontsize, framealpha=0)
    set_legend_colors(ax, fontsize=fontsize)
    if is_delta_space:
        xvar_format = None
        ax.set_xticks(range(len(model_vols.index)))
        ax.set_xticklabels(map_deltas_to_str(np.asarray(model_vols.index)))
        xlabel = 'delta'
    _fmt_axis(ax, xvar_format, yvar_format, x_rotation)
    if n_tickwindow is not None:
        for idx, tick in enumerate(ax.xaxis.get_ticklabels()):
            if idx % n_tickwindow != 0:
                tick.set_visible(False)
    ax.set_xlabel(xlabel)
    if title is not None:
        ax.set_title(title, fontsize=fontsize)
    return fig


def model_param_ts(param_ts: Union[pd.Series, pd.DataFrame],
                   yvar_format: str = '{:.2f}',
                   x_rotation: int = 0,
                   title: Optional[str] = None,
                   markers: bool = True,
                   legend_loc: str = 'upper center',
                   ax=None) -> Optional[plt.Figure]:
    """time series of calibrated model parameters."""
    import matplotlib.pyplot as plt
    import pandas as pd
    import seaborn as sns
    fig = None
    if ax is None:
        fig, ax = plt.subplots(1, 1, figsize=(8, 8))
    sns.lineplot(data=param_ts, dashes=True, markers=markers, ax=ax)
    _fmt_axis(ax, None, yvar_format, x_rotation)
    ax.legend(loc=legend_loc, framealpha=0)
    set_legend_colors(ax)
    if isinstance(param_ts, pd.Series):
        ax.set_title(param_ts.name, color='blue')
    elif title is not None:
        ax.set_title(title, color='blue')
    return fig


def plot_model_risk_var(risk_var: Union[pd.Series, pd.DataFrame],
                        xvar_format: str = '{:.2f}',
                        yvar_format: str = '{:.2f}',
                        x_rotation: int = 0,
                        xlabel: str = 'log-return',
                        ylabel: str = 'probability',
                        title: Optional[str] = None,
                        ax=None) -> Optional[plt.Figure]:
    """model density / risk profile over the state-variable grid."""
    import matplotlib.pyplot as plt
    import pandas as pd
    import seaborn as sns
    fig = None
    if ax is None:
        fig, ax = plt.subplots(1, 1, figsize=(8, 8))
    if isinstance(risk_var, pd.Series):
        risk_var = risk_var.to_frame()
    palette = ['black'] if len(risk_var.columns) == 1 else None
    sns.lineplot(data=risk_var, palette=palette, dashes=False, ax=ax)
    if len(risk_var.columns) == 1:
        leg = ax.get_legend()
        if leg is not None:
            leg.set_visible(False)
    else:
        ax.legend(loc='upper left', framealpha=0)
        set_legend_colors(ax)
    _fmt_axis(ax, xvar_format, yvar_format, x_rotation)
    ax.set_xlabel(xlabel)
    ax.set_ylabel(ylabel)
    if title is not None:
        ax.set_title(title)
    return fig


# ----------------------------------------------------------------------------
# figure export
# ----------------------------------------------------------------------------

def fig_to_pdf(fig: plt.Figure, file_name: str, local_path: str,
               orientation: Literal['portrait', 'landscape'] = 'portrait') -> str:
    from matplotlib.backends.backend_pdf import PdfPages
    file_path = join(local_path, f"{file_name}.pdf")
    with PdfPages(file_path) as pdf:
        pdf.savefig(fig, orientation=orientation)
    print(f"created PDF: {file_path}")
    return file_path


def fig_list_to_pdf(figs: List[plt.Figure], file_name: str, local_path: str,
                    is_add_current_date: bool = False,
                    orientation: Literal['portrait', 'landscape'] = 'portrait') -> str:
    from matplotlib.backends.backend_pdf import PdfPages
    if is_add_current_date:
        file_name = f"{file_name}_{dt.datetime.now().strftime(DATE_TIME_FORMAT)}"
    file_path = join(local_path, f"{file_name}.pdf")
    with PdfPages(file_path) as pdf:
        for fig in figs:
            pdf.savefig(fig, orientation=orientation)
    print(f"created PDF doc: {file_path}")
    return file_path


def save_fig(fig: plt.Figure, file_name: str, local_path: Optional[str] = None,
             dpi: int = 300, extension: str = 'PNG', **kwargs) -> str:
    file_path = join(local_path or '.', f"{file_name}.{extension}")
    fig.savefig(file_path, dpi=dpi)
    return file_path


def save_figs(figs: Dict[str, plt.Figure], local_path: Optional[str] = None,
              dpi: int = 300, extension: str = 'PNG', **kwargs) -> None:
    for key, fig in figs.items():
        print(save_fig(fig=fig, file_name=key, local_path=local_path, dpi=dpi,
                       extension=extension, **kwargs))


# ----------------------------------------------------------------------------
# axis helpers
# ----------------------------------------------------------------------------

def set_y_limits(ax, y_limits: Tuple[Optional[float], Optional[float]]) -> None:
    ymin, ymax = ax.get_ylim()
    ax.set_ylim([y_limits[0] if y_limits[0] is not None else ymin,
                 y_limits[1] if y_limits[1] is not None else ymax])


def align_x_limits_axs(axs, is_invisible_xs: bool = False) -> None:
    lims = [ax.get_xlim() for ax in axs]
    lo, hi = min(l[0] for l in lims), max(l[1] for l in lims)
    for idx, ax in enumerate(axs):
        ax.set_xlim([lo, hi])
        if is_invisible_xs and idx > 0:
            ax.axes.get_xaxis().set_visible(False)


def align_y_limits_axs(axs, is_invisible_ys: bool = False) -> None:
    lims = [ax.get_ylim() for ax in axs]
    lo, hi = min(l[0] for l in lims), max(l[1] for l in lims)
    for idx, ax in enumerate(axs):
        ax.set_ylim([lo, hi])
        if is_invisible_ys and idx > 0:
            ax.axes.get_yaxis().set_visible(False)


def set_subplot_border(fig: plt.Figure, n_ax_col: int = 1, n_ax_rows: int = 1) -> None:
    """draw a border grid around the subplots of a figure."""
    import matplotlib.pyplot as plt
    rects = []
    height = 1.0 / n_ax_rows
    for r in range(n_ax_rows):
        rects.append(plt.Rectangle((0.0, r * height), 1.0, height, fill=False,
                                   color='#00284A', lw=1, zorder=1000,
                                   transform=fig.transFigure, figure=fig))
    width = 1.0 / n_ax_col
    for r in range(n_ax_col):
        rects.append(plt.Rectangle((r * width, 0), width, 1.0, fill=False,
                                   color='#00284A', lw=1, zorder=1000,
                                   transform=fig.transFigure, figure=fig))
    fig.patches.extend(rects)


def flatten(items: Iterable) -> Any:
    for x in items:
        if isinstance(x, Iterable) and not isinstance(x, (str, bytes)):
            yield from flatten(x)
        else:
            yield x


def to_flat_list(items: Iterable) -> List[Any]:
    if isinstance(items, Iterable):
        return list(flatten(items))
    return [items]


def map_deltas_to_str(bsm_deltas: np.ndarray) -> List[str]:
    """format BSM deltas as axis labels, disambiguating duplicates."""
    out: List[str] = []
    labels = [f"{x:0.2f}" for x in bsm_deltas]
    for idx, x in enumerate(bsm_deltas):
        label = labels[idx]
        if idx > 0 and label == labels[idx - 1]:
            if x < 0.0:
                out[idx - 1] = f"{bsm_deltas[idx - 1]:0.3f}"
            else:
                label = f"{x:0.3f}"
        out.append(label)
    return out
