"""Publication plot styling (port of ``mimo_ofdm_tpu/utils/plotting.py``;
``reference/plot_settings.py:8-60``): colorblind-safe palette,
golden-ratio figure sizing, optional LaTeX fonts (off by default so
headless runs need no TeX toolchain). matplotlib is imported inside the
functions only."""

from __future__ import annotations

CB_COLOR_CYCLE = ['#006BA4', '#FF800E', '#ABABAB', '#595959', '#5F9ED1',
                  '#C85200', '#898989', '#A2C8EC', '#FFBC79', '#CFCFCF']

GOLDEN_RATIO = (5 ** 0.5 - 1) / 2


def set_latex_plot_style(use_tex: bool = False, fig_width_in: float = 3.5,
                         fig_height_in: float | None = None):
    """Configure matplotlib for publication figures
    (``reference/plot_settings.py:8-47``)."""
    import matplotlib
    import matplotlib.pyplot as plt

    if fig_height_in is None:
        fig_height_in = fig_width_in * GOLDEN_RATIO
    params = {
        "figure.figsize": (fig_width_in, fig_height_in),
        "axes.prop_cycle": matplotlib.cycler(color=CB_COLOR_CYCLE),
        "axes.grid": True,
        "grid.alpha": 0.4,
        "font.size": 8,
        "legend.fontsize": 7,
        "lines.linewidth": 1.0,
        "lines.markersize": 3.5,
        "savefig.dpi": 600,
        "savefig.bbox": "tight",
    }
    if use_tex:
        params.update({"text.usetex": True, "font.family": "serif"})
    plt.rcParams.update(params)


def reset_color_cycle():
    """Restart the axes color cycle (``reference/plot_settings.py:50-60``)."""
    import matplotlib.pyplot as plt
    plt.gca().set_prop_cycle(None)
