"""Publication replots from saved CSVs, the ``final_plots`` layer
(port of ``mimo_ofdm_tpu/utils/replot.py``;
``reference/final_plots/ber_vs_ebn0.py:34-60`` and siblings): reconstruct
the deterministic filename, read the CSV and re-render with the
publication style. No simulation is run.

The CSVs are read from the port's results directory,
``figs/csv_results_torch/`` (or ``$MIMO_OFDM_TPU_TORCH_RESULTS``), unless
``results_dir=`` names another, e.g. the JAX package's committed
``figs/csv_results/``; the file layout is the same. matplotlib is imported
inside each function, so importing this module does not need it."""

from __future__ import annotations

import numpy as np

from mimo_ofdm_tpu_torch.utils import results
from mimo_ofdm_tpu_torch.utils.plotting import CB_COLOR_CYCLE, set_latex_plot_style


def replot_ber_vs_ebn0(kind: str, rx_name: str, chan_name: str, n_ant: int,
                       ibo_db: float, ebn0_arr, cnc_iter_lst,
                       sel_iters=None, results_dir=None, save_path=None,
                       show: bool = False):
    """Re-render a BER-vs-Eb/N0 CSV (row 0 = Eb/N0, row 1 = clean, rows
    2.. = per-iteration), mirroring ``reference/final_plots/ber_vs_ebn0.py``."""
    import matplotlib.pyplot as plt

    set_latex_plot_style()
    fname = results.ber_sweep_filename(kind, rx_name, chan_name, n_ant,
                                       ibo_db, np.asarray(ebn0_arr),
                                       cnc_iter_lst)
    kw = {} if results_dir is None else {"results_dir": results_dir}
    ebn0, ber = results.load_ber_sweep(fname, **kw)

    fig, ax = plt.subplots()
    ax.set_yscale("log", base=10)
    ax.plot(ebn0, ber[0], color=CB_COLOR_CYCLE[0], label="No distortion")
    sel = set(sel_iters) if sel_iters is not None else None
    color_idx = 1
    for i in range(1, ber.shape[0]):
        it = i - 1
        if sel is not None and it not in sel:
            continue
        label = "Standard RX" if it == 0 else f"NI = {it}"
        ax.plot(ebn0, ber[i], color=CB_COLOR_CYCLE[color_idx % len(CB_COLOR_CYCLE)],
                label=label)
        color_idx += 1
    ax.set_xlabel("Eb/N0 [dB]")
    ax.set_ylabel("BER")
    ax.grid(True)
    ax.legend()
    fig.tight_layout()
    if save_path:
        fig.savefig(save_path, dpi=600, bbox_inches="tight")
    if show:
        plt.show()
    return fig, ax


def _iter_series(ax, x, rows, iter_vals, sel_iters, linestyle="-"):
    """Plot one curve per selected iteration count with the reference's
    per-iteration color indexing (``reference/final_plots/ber_vs_ibo.py:
    57-69``: color index starts at 1 and advances per selected curve)."""
    color_idx = 1
    for ri, it in enumerate(iter_vals):
        if sel_iters is not None and it not in sel_iters:
            continue
        ax.plot(x, rows[ri], linestyle,
                color=CB_COLOR_CYCLE[color_idx % len(CB_COLOR_CYCLE)])
        color_idx += 1


def _cnc_mcnc_legend(ax, sel_iters, has_mcnc):
    """The reference's two-part legend: color patches for the iteration
    counts + black line styles for CNC (solid) vs MCNC (dashed)
    (``reference/final_plots/ber_vs_ibo.py:70-96``)."""
    import matplotlib.lines as mlines
    import matplotlib.patches as mpatches

    patches = [mpatches.Patch(color=CB_COLOR_CYCLE[(1 + i) % len(CB_COLOR_CYCLE)],
                              label=str(v))
               for i, v in enumerate(sel_iters)]
    leg1 = ax.legend(handles=patches, title="I iterations:",
                     loc="upper right", ncol=1, framealpha=0.9)
    ax.add_artist(leg1)
    if has_mcnc:
        lines = [mlines.Line2D([0], [0], linestyle="-", color="k", label="CNC"),
                 mlines.Line2D([0], [0], linestyle="--", color="k", label="MCNC")]
        ax.legend(handles=lines, loc="lower left", framealpha=0.9)


def replot_ber_vs_ibo(chan_name: str, n_ant: int, ebn0_db: float, ibo_arr,
                      cnc_iter_lst=tuple(range(9)), sel_iters=(0, 1, 2, 5, 8),
                      include_mcnc: bool = True, results_dir=None,
                      save_path=None, show: bool = False):
    """BER vs IBO at fixed Eb/N0, CNC solid / MCNC dashed per iteration
    count (``reference/final_plots/ber_vs_ibo.py``). Our CSV layout:
    row 0 = IBO, rows 1.. = iterations 0..n."""
    import matplotlib.pyplot as plt

    set_latex_plot_style()
    kw = {} if results_dir is None else {"results_dir": results_dir}
    fig, ax = plt.subplots()
    ax.set_yscale("log", base=10)
    arms = [("cnc", "-")] + ([("mcnc", "--")] if include_mcnc else [])
    for alg, style in arms:
        fname = results.ber_vs_ibo_filename(alg, chan_name, n_ant, ebn0_db,
                                            np.asarray(ibo_arr),
                                            [v for v in cnc_iter_lst if v])
        rows = results.read_from_csv(fname, **kw)
        _iter_series(ax, rows[0], rows[1:], list(cnc_iter_lst), sel_iters,
                     style)
    ax.set_xlabel("IBO [dB]")
    ax.set_ylabel("BER")
    ax.grid(True)
    _cnc_mcnc_legend(ax, sel_iters, include_mcnc)
    fig.tight_layout()
    if save_path:
        fig.savefig(save_path, dpi=600, bbox_inches="tight")
    if show:
        plt.show()
    return fig, ax


def replot_fixed_ber_req_ebn0_vs_ibo(chan_name: str, n_ant: int, ebn0_arr,
                                     ibo_arr, target_ber: float = 1e-2,
                                     cnc_iter_lst=tuple(range(9)),
                                     sel_iters=(0, 1, 2, 5, 8),
                                     include_mcnc: bool = True,
                                     ibo_arr_mcnc=None,
                                     results_dir=None, save_path=None,
                                     show: bool = False):
    """Required Eb/N0 for a target BER vs IBO, interpolated from the saved
    raw (IBO x Eb/N0) BER grid exactly like
    ``reference/final_plots/fixed_ber_ebno_vs_ibo.py`` (CNC solid, MCNC
    dashed). ``ibo_arr_mcnc`` lets the MCNC arm use a coarser saved IBO
    grid than the CNC arm (our covering runs use 0.25/0.5 dB steps)."""
    import matplotlib.pyplot as plt

    from mimo_ofdm_tpu_torch.experiments.ber_sweeps import interp_req_ebn0

    set_latex_plot_style()
    kw = {} if results_dir is None else {"results_dir": results_dir}
    ebn0_arr = np.asarray(ebn0_arr, float)
    fig, ax = plt.subplots()
    arms = [("cnc", "-", np.asarray(ibo_arr))]
    if include_mcnc:
        arms.append(("mcnc", "--",
                     np.asarray(ibo_arr if ibo_arr_mcnc is None
                                else ibo_arr_mcnc)))
    for alg, style, arm_ibo in arms:
        fname = results.fixed_ber_filename(target_ber, alg, chan_name, n_ant,
                                           ebn0_arr, arm_ibo,
                                           [v for v in cnc_iter_lst if v])
        rows = results.read_from_csv(fname, **kw)
        ibo = rows[0]
        n_ebn0 = len(ebn0_arr)
        grid = np.stack([np.stack(rows[1 + j * n_ebn0: 1 + (j + 1) * n_ebn0])
                         for j in range(len(ibo))])
        req = interp_req_ebn0(grid, ebn0_arr, target_ber)
        _iter_series(ax, ibo, req, list(cnc_iter_lst), sel_iters, style)
    ax.set_xlabel("IBO [dB]")
    ax.set_ylabel(f"Eb/N0 [dB] for BER = {target_ber:g}")
    ax.grid(True)
    _cnc_mcnc_legend(ax, sel_iters, include_mcnc)
    fig.tight_layout()
    if save_path:
        fig.savefig(save_path, dpi=600, bbox_inches="tight")
    if show:
        plt.show()
    return fig, ax


def replot_ber_vs_nant(n_ant_arr, ebn0_db: float, ibo_db: float,
                       channels=("los", "two_path", "rayleigh"),
                       cnc_iter_lst=tuple(range(9)), sel_iters=(0, 2, 8),
                       rx_name: str = "cnc", results_dir=None,
                       save_path=None, show: bool = False):
    """BER vs number of antennas per channel
    (``reference/final_plots/ber_vs_nant_vs_chan.py``). Our CSV: row 0 =
    antenna counts, then per channel clean + iterations 0..n."""
    import matplotlib.pyplot as plt

    set_latex_plot_style()
    kw = {} if results_dir is None else {"results_dir": results_dir}
    fname = results.ber_vs_nant_filename(rx_name, list(n_ant_arr), ebn0_db,
                                         ibo_db, [v for v in cnc_iter_lst if v])
    rows = results.read_from_csv(fname, **kw)
    nant = rows[0]
    n_per_chan = 1 + len(cnc_iter_lst)
    fig, ax = plt.subplots()
    ax.set_yscale("log", base=10)
    ax.set_xscale("log", base=2)
    styles = {"los": "-", "two_path": "--", "rayleigh": ":"}
    for ci, chan in enumerate(channels):
        base = 1 + ci * n_per_chan
        _iter_series(ax, nant, rows[base + 1:base + n_per_chan],
                     list(cnc_iter_lst), sel_iters,
                     styles.get(chan, "-"))
    ax.set_xlabel("N antennas")
    ax.set_ylabel("BER")
    ax.grid(True)
    import matplotlib.lines as mlines
    chan_lines = [mlines.Line2D([0], [0], linestyle=styles.get(c, "-"),
                                color="k", label=c.replace("_", " "))
                  for c in channels]
    leg = ax.legend(handles=chan_lines, loc="lower left", framealpha=0.9)
    ax.add_artist(leg)
    _cnc_mcnc_legend(ax, sel_iters, has_mcnc=False)
    fig.tight_layout()
    if save_path:
        fig.savefig(save_path, dpi=600, bbox_inches="tight")
    if show:
        plt.show()
    return fig, ax


def replot_ber_vs_ite(kind: str, rx_names, chan_name: str, n_ant: int,
                      ibo_db: float, ebn0_arr, cnc_iter_lst, ebn0_sel,
                      results_dir=None, save_path=None, show: bool = False):
    """BER vs CNC iteration count at selected Eb/N0 values
    (``reference/final_plots/ber_vs_ite.py``): re-slices the saved
    BER-vs-Eb/N0 CSVs along the iteration axis; one line style per
    receiver (CNC solid, MCNC dashed), one color per Eb/N0."""
    import matplotlib.pyplot as plt

    set_latex_plot_style()
    kw = {} if results_dir is None else {"results_dir": results_dir}
    fig, ax = plt.subplots()
    ax.set_yscale("log", base=10)
    styles = {"cnc": "-", "mcnc": "--"}
    for rx in rx_names:
        fname = results.ber_sweep_filename(kind, rx, chan_name, n_ant,
                                           ibo_db, np.asarray(ebn0_arr),
                                           cnc_iter_lst)
        ebn0, ber = results.load_ber_sweep(fname, **kw)
        iters = np.arange(ber.shape[0] - 1)
        for k, e in enumerate(ebn0_sel):
            i = int(np.argmin(np.abs(np.asarray(ebn0) - e)))
            ax.plot(iters, ber[1:, i], styles.get(rx, "-"),
                    color=CB_COLOR_CYCLE[(1 + k) % len(CB_COLOR_CYCLE)],
                    label=f"{rx.upper()} Eb/N0={ebn0[i]:g} dB")
    ax.set_xlabel("CNC iterations I")
    ax.set_ylabel("BER")
    ax.grid(True)
    ax.legend()
    fig.tight_layout()
    if save_path:
        fig.savefig(save_path, dpi=600, bbox_inches="tight")
    if show:
        plt.show()
    return fig, ax


def replot_mu_ber_vs_ebn0(precoding_str: str, chan_name: str, n_ant: int,
                          ibo_db: float, ebn0_arr, cnc_iter_lst,
                          usr_angles, usr_distances, n_users: int = 2,
                          sel_iters=(0, 2, 8), rx_name: str = "cnc",
                          results_dir=None, save_path=None,
                          show: bool = False):
    """Per-user BER vs Eb/N0 (``reference/final_plots/mu_ber_vs_ebn0.py``):
    one line style per user, colors per iteration count. Our CSV: row 0 =
    Eb/N0, then per user clean + iterations 0..n."""
    import matplotlib.pyplot as plt

    set_latex_plot_style()
    kw = {} if results_dir is None else {"results_dir": results_dir}
    fname = results.mu_ber_filename(precoding_str, chan_name, n_ant, ibo_db,
                                    np.asarray(ebn0_arr), cnc_iter_lst,
                                    usr_angles, usr_distances,
                                    rx_name=rx_name)
    rows = results.read_from_csv(fname, **kw)
    ebn0 = rows[0]
    n_per_usr = 2 + len(cnc_iter_lst)
    fig, ax = plt.subplots()
    ax.set_yscale("log", base=10)
    usr_styles = ["-", "--", ":", "-."]
    for u in range(n_users):
        base = 1 + u * n_per_usr
        ax.plot(ebn0, rows[base], usr_styles[u % 4],
                color=CB_COLOR_CYCLE[0])
        _iter_series(ax, ebn0, rows[base + 1:base + n_per_usr],
                     [0] + list(cnc_iter_lst), sel_iters,
                     usr_styles[u % 4])
    ax.set_xlabel("Eb/N0 [dB]")
    ax.set_ylabel("BER")
    ax.grid(True)
    import matplotlib.lines as mlines
    usr_lines = [mlines.Line2D([0], [0], linestyle=usr_styles[u % 4],
                               color="k", label=f"User {u + 1}")
                 for u in range(n_users)]
    leg = ax.legend(handles=usr_lines, loc="lower left", framealpha=0.9)
    ax.add_artist(leg)
    _cnc_mcnc_legend(ax, sel_iters, has_mcnc=False)
    fig.tight_layout()
    if save_path:
        fig.savefig(save_path, dpi=600, bbox_inches="tight")
    if show:
        plt.show()
    return fig, ax


def replot_ldpc_ber(code_rate_str: str, chan_name: str, n_ant: int,
                    ibo_db: float, ebn0_arr, cnc_iter_lst,
                    include_mcnc: bool = True, results_dir=None,
                    save_path=None, show: bool = False):
    """Coded (NR-LDPC) BER vs Eb/N0, CNC vs MCNC overlay
    (``reference/final_plots/ber_ebn0_w_ldpc.py``). CSV rows: Eb/N0,
    clean, iterations 0..n."""
    import matplotlib.pyplot as plt

    set_latex_plot_style()
    kw = {} if results_dir is None else {"results_dir": results_dir}
    num, den = code_rate_str.split("/")
    fig, ax = plt.subplots()
    ax.set_yscale("log", base=10)
    arms = [("cnc", "-")] + ([("mcnc", "--")] if include_mcnc else [])
    sel = [0] + list(cnc_iter_lst)
    for alg, style in arms:
        fname = results.ber_sweep_filename(
            f"ldpc_{num}_{den}_ber_vs_ebn0", alg, chan_name, n_ant, ibo_db,
            np.asarray(ebn0_arr), cnc_iter_lst)
        ebn0, ber = results.load_ber_sweep(fname, **kw)
        ax.plot(ebn0, ber[0], style, color=CB_COLOR_CYCLE[0])
        _iter_series(ax, ebn0, ber[1:], sel, sel, style)
    ax.set_xlabel("Eb/N0 [dB]")
    ax.set_ylabel("BER")
    ax.grid(True)
    _cnc_mcnc_legend(ax, sel, include_mcnc)
    fig.tight_layout()
    if save_path:
        fig.savefig(save_path, dpi=600, bbox_inches="tight")
    if show:
        plt.show()
    return fig, ax


def replot_ber_vs_csi_err(rx_name: str, chan_name: str, n_ant: int,
                          ibo_db: float, ebn0_arr, cnc_iter_lst,
                          eps_values=(0.1,), sel_iters=(0, 2, 8),
                          results_dir=None, save_path=None,
                          show: bool = False):
    """BER vs Eb/N0 across CSI-error magnitudes
    (``reference/final_plots/ber_vs_csi_err.py``): one line style per
    epsilon, colors per iteration."""
    import matplotlib.pyplot as plt

    set_latex_plot_style()
    kw = {} if results_dir is None else {"results_dir": results_dir}
    fig, ax = plt.subplots()
    ax.set_yscale("log", base=10)
    styles = ["-", "--", ":", "-."]
    for k, eps in enumerate(eps_values):
        fname = results.ber_sweep_filename(
            "ber_vs_ebn0", rx_name, f"{chan_name}_csi_eps{eps:.3f}", n_ant,
            ibo_db, np.asarray(ebn0_arr), cnc_iter_lst)
        ebn0, ber = results.load_ber_sweep(fname, **kw)
        _iter_series(ax, ebn0, ber[1:], [0] + list(cnc_iter_lst), sel_iters,
                     styles[k % 4])
    ax.set_xlabel("Eb/N0 [dB]")
    ax.set_ylabel("BER")
    ax.grid(True)
    import matplotlib.lines as mlines
    eps_lines = [mlines.Line2D([0], [0], linestyle=styles[k % 4], color="k",
                               label=f"eps = {eps:g}")
                 for k, eps in enumerate(eps_values)]
    leg = ax.legend(handles=eps_lines, loc="lower left", framealpha=0.9)
    ax.add_artist(leg)
    _cnc_mcnc_legend(ax, sel_iters, has_mcnc=False)
    fig.tight_layout()
    if save_path:
        fig.savefig(save_path, dpi=600, bbox_inches="tight")
    if show:
        plt.show()
    return fig, ax


def replot_sdr_vs_ibo(filename: str = ("sdr_vs_ibo_per_channel_ibo0to8"
                                       "_1_4_16_32_64nant"),
                      n_ant_values=(1, 4, 16, 32, 64),
                      channels=("los", "two_path", "rayleigh"),
                      ibo_arr=None, results_dir=None, save_path=None,
                      show: bool = False):
    """SDR [dB] vs IBO per channel and antenna count
    (``reference/final_plots/sdr_vs_ibo_vs_chan.py``,
    ``reference/main_wwrf_plots/sdr_vs_ibo_vs_chan.py``). Our CSV: row 0 =
    IBO, then (n_ant-major x channel) rows of linear SDR."""
    import matplotlib.pyplot as plt

    set_latex_plot_style()
    kw = {} if results_dir is None else {"results_dir": results_dir}
    rows = results.read_from_csv(filename, **kw)
    ibo = rows[0] if ibo_arr is None else np.asarray(ibo_arr)
    styles = {"los": "-", "two_path": "--", "rayleigh": ":"}
    fig, ax = plt.subplots()
    for ai, nant in enumerate(n_ant_values):
        for ci, chan in enumerate(channels):
            r = 1 + ai * len(channels) + ci
            ax.plot(ibo, 10 * np.log10(rows[r]), styles.get(chan, "-"),
                    color=CB_COLOR_CYCLE[ai % len(CB_COLOR_CYCLE)])
    ax.set_xlabel("IBO [dB]")
    ax.set_ylabel("SDR [dB]")
    ax.grid(True)
    import matplotlib.lines as mlines
    import matplotlib.patches as mpatches
    patches = [mpatches.Patch(color=CB_COLOR_CYCLE[ai % len(CB_COLOR_CYCLE)],
                              label=f"K = {nant}")
               for ai, nant in enumerate(n_ant_values)]
    leg1 = ax.legend(handles=patches, title="N antennas:", loc="upper left",
                     framealpha=0.9)
    ax.add_artist(leg1)
    chan_lines = [mlines.Line2D([0], [0], linestyle=styles.get(c, "-"),
                                color="k", label=c.replace("_", " "))
                  for c in channels]
    ax.legend(handles=chan_lines, loc="lower right", framealpha=0.9)
    fig.tight_layout()
    if save_path:
        fig.savefig(save_path, dpi=600, bbox_inches="tight")
    if show:
        plt.show()
    return fig, ax


def replot_polar_beampattern(chan_name: str, ibo_db: float, n_ant: int,
                             n_points: int = 180, n_snapshots: int = 100,
                             precoding_angle: float = 45.0,
                             results_dir=None, save_path=None,
                             show: bool = False):
    """Polar desired/distortion radiation pattern for one antenna count
    (``reference/main_wwrf_plots/polar_beampattern_plot.py``,
    ``reference/msc_figures/polar_beampattern_plot.py``): reads the
    2-row (desired, distortion) powers-vs-angle CSV and renders both on a
    half-circle polar axis in dB."""
    import matplotlib.pyplot as plt

    set_latex_plot_style()
    kw = {} if results_dir is None else {"results_dir": results_dir}
    fname = results.sig_powers_filename(chan_name, ibo_db, n_points,
                                        n_snapshots, precoding_angle, n_ant)
    rows = results.read_from_csv(fname, **kw)

    def to_pattern(row):
        """One float per cell (single-count file) OR one python-list cell
        per antenna count, cumulative save-inside-the-loop layout
        (``reference/main_beampatterns_plotting/
        main_mrt_precoding_radiation_pattern.py``; our writer matches) —
        the last cell is the file's terminal antenna count."""
        try:
            return np.asarray(row, float)
        except (TypeError, ValueError):
            import ast
            return np.asarray(ast.literal_eval(row[-1]), float)

    desired, distortion = to_pattern(rows[0]), to_pattern(rows[1])
    angles = np.radians(np.linspace(0, 180, len(desired)))
    fig, ax = plt.subplots(subplot_kw={"projection": "polar"})
    ax.set_thetamin(0)
    ax.set_thetamax(180)
    ax.plot(angles, 10 * np.log10(desired), label="Desired",
            color=CB_COLOR_CYCLE[0])
    ax.plot(angles, 10 * np.log10(np.maximum(distortion, 1e-30)),
            label="Distortion", color=CB_COLOR_CYCLE[1])
    ax.set_title(f"K = {n_ant}, IBO = {ibo_db:g} dB")
    ax.legend(loc="lower center", ncol=2)
    fig.tight_layout()
    if save_path:
        fig.savefig(save_path, dpi=600, bbox_inches="tight")
    if show:
        plt.show()
    return fig, ax


def replot_berin_berout_vs_ibo(chan_name: str = "los", n_ant: int = 64,
                               ebn0_list=(15.0, 1000.0),
                               sel_iters=(1, 2, 5), ibo_arr=None,
                               n_iters: int = 8, results_dir=None,
                               save_path=None, show: bool = False):
    """Receiver-output BER vs receiver-input BER, traced by sweeping IBO
    (``reference/final_plots/berin_berout_vs_ibo.py``): for each Eb/N0
    and each selected iteration count ``i``, plot ``BER[iter i+1]``
    against ``BER[iter i]`` from the ``ber_vs_ibo_{cnc,mcnc}_*`` grids
    (CNC solid, MCNC dashed), log-log with equal aspect and the
    no-gain diagonal. ``ebn0`` 1000 is the reference's label for the
    effectively-noise-free arm (the noise scale underflows to 0;
    ``ber_vs_ibo_cnc_los_nant64_ebn0_1000_*`` — no ``no_noise_`` prefix,
    matching the committed filenames)."""
    import matplotlib.lines as mlines
    import matplotlib.patches as mpatches
    import matplotlib.pyplot as plt
    from matplotlib import ticker as mticker

    set_latex_plot_style()
    if ibo_arr is None:
        ibo_arr = np.arange(-9.0, 9.5, 0.5)
    kw = {} if results_dir is None else {"results_dir": results_dir}
    iters = list(range(1, n_iters + 1))

    fig, ax = plt.subplots()
    ax.set_xscale("log", base=10)
    ax.set_yscale("log", base=10)
    ax.set_aspect("equal")
    for ebn0 in ebn0_list:
        for alg, style in (("cnc", "-"), ("mcnc", "--")):
            fname = results.ber_vs_ibo_filename(alg, chan_name, n_ant,
                                                ebn0, ibo_arr, iters)
            _, ber = results.load_ber_sweep(fname, **kw)
            # rows: iteration 0..n_iters (no clean row in the vs-IBO layout)
            color_idx = 2  # reference starts its color cycle at index 2
            for it in range(n_iters):
                if it not in sel_iters:
                    continue
                ax.plot(ber[it], ber[it + 1], style,
                        color=CB_COLOR_CYCLE[color_idx % len(CB_COLOR_CYCLE)])
                color_idx += 1

    handles = []
    color_idx = 2
    for it in sel_iters:
        handles.append(mpatches.Patch(
            color=CB_COLOR_CYCLE[color_idx % len(CB_COLOR_CYCLE)], label=it))
        color_idx += 1
    leg1 = ax.legend(handles=handles, title="I iterations:",
                     loc="upper left", ncol=1, framealpha=0.9)
    ax.add_artist(leg1)
    ax.legend(handles=[
        mlines.Line2D([0], [0], linestyle="-", color="k", label="CNC"),
        mlines.Line2D([0], [0], linestyle="--", color="k", label="MCNC"),
        mlines.Line2D([0], [0], linestyle=":", color="k", label="No gain")],
        loc="lower right", framealpha=0.9, ncol=1)
    ax.set_xlabel("BER in [-]")
    ax.set_ylabel("BER out [-]")
    ax.set_xlim([1e-5, 4e-1])
    ax.set_ylim([1e-5, 4e-1])
    ax.xaxis.set_major_locator(mticker.LogLocator(numticks=999))
    lo, hi = ax.get_xlim()
    ax.plot([lo, hi], [lo, hi], color="k", linestyle=":", linewidth=1)
    ax.grid(True)
    fig.tight_layout()
    if save_path:
        fig.savefig(save_path, dpi=600, bbox_inches="tight")
    if show:
        plt.show()
    return fig, ax


def replot_alpha_per_ant_vs_ibo(n_ant: int = 64, ibo_db: float = 0.0,
                                channels=("rayleigh", "two_path", "los"),
                                results_dir=None, save_path=None,
                                show: bool = False):
    """Per-antenna empirical Bussgang alpha_k scatter vs that antenna's
    effective IBO_k under MRT power redistribution, against the
    analytical alpha(IBO) curve
    (``reference/final_plots/alpha_per_ant_vs_ibo.py`` consuming
    ``alpha_vs_tx_power_per_ant64_ibo0.0.csv``). Reads our
    ``alpha_vs_tx_pow_per_ant_nant{n}_ibo{i}`` layout (rows: one IBO row
    per channel, then one lambda row per channel)."""
    import matplotlib.pyplot as plt
    from matplotlib.ticker import MaxNLocator
    from mimo_ofdm_tpu_torch.ops.pa import bussgang_alpha

    set_latex_plot_style()
    kw = {} if results_dir is None else {"results_dir": results_dir}
    rows = results.read_from_csv(
        f"alpha_vs_tx_pow_per_ant_nant{n_ant}_ibo{int(ibo_db)}", **kw)
    n_chan = len(channels)
    ibo_rows = [np.asarray(rows[i], float) for i in range(n_chan)]
    lam_rows = [np.asarray(rows[n_chan + i], float) for i in range(n_chan)]

    labels = {"rayleigh": "Rayleigh", "two_path": "Two-path", "los": "LOS"}
    fig, ax = plt.subplots()
    for ci, chan in enumerate(channels):
        ax.plot(ibo_rows[ci], lam_rows[ci], ".",
                color=CB_COLOR_CYCLE[ci % len(CB_COLOR_CYCLE)],
                label=labels.get(chan, chan))
    ibo_range = np.linspace(min(r.min() for r in ibo_rows),
                            max(r.max() for r in ibo_rows), 100)
    ax.plot(ibo_range, np.asarray(bussgang_alpha(ibo_range)), "--k",
            label="Analytical", alpha=0.7)
    ax.yaxis.set_major_locator(MaxNLocator(5))
    ax.xaxis.set_major_locator(MaxNLocator(6))
    ax.set_xlabel(r"$\mathrm{IBO_k}$ [dB]")
    ax.set_ylabel(r"$\mathrm{\alpha_k}$ [-]")
    ax.grid(True)
    ax.legend(title="Channel:", loc="lower right", framealpha=0.9)
    fig.tight_layout()
    if save_path:
        fig.savefig(save_path, dpi=600, bbox_inches="tight")
    if show:
        plt.show()
    return fig, ax


def replot_soft_limiter_tf(sat_pow: float = 25.0, save_path=None,
                           show: bool = False):
    """Soft-limiter transfer characteristic in signal *power* with the
    P_max annotation ticks (``reference/msc_figures/soft_limiter_tf_char.py``
    — a pure function plot, no saved data)."""
    import numpy as np
    import matplotlib.pyplot as plt

    set_latex_plot_style()
    amp = np.arange(0.0, 10.1, 0.1)
    # numpy re-statement of ops.pa.soft_limiter's amplitude clip
    out = np.where(amp ** 2 <= sat_pow, amp, np.sqrt(sat_pow))
    fig, ax = plt.subplots()
    pm = np.sqrt(sat_pow)
    ax.plot(amp, out, linewidth=2)
    ax.set_xticks([0, pm])
    ax.set_xticklabels(["0", r"$P_{\mathrm{max}}$"])
    ax.set_yticks([0, pm])
    ax.set_yticklabels(["0", r"$P_{\mathrm{max}}$"])
    ax.set_title("Soft limiter transfer function")
    ax.set_xlabel("Input signal power")
    ax.set_ylabel("Output signal power")
    ax.grid(True)
    fig.tight_layout()
    if save_path:
        fig.savefig(save_path, dpi=600, bbox_inches="tight")
    if show:
        plt.show()
    return fig, ax


def replot_mobile_growth_bars(save_path=None, show: bool = False):
    """The thesis-intro industry-statistics bar charts
    (``reference/msc_figures/whitepaper_figures.py``): mobile subscriber
    and data-traffic projections from the public Ericsson mobility
    report figures hardcoded by the reference."""
    import numpy as np
    import matplotlib.pyplot as plt

    set_latex_plot_style()
    years = np.arange(2021, 2028)
    subs = np.array([6084.265, 6198.8, 6328.789, 6426.262, 6521.513,
                     6612.575, 6698.486]) / 1000.0
    traffic = np.array([67, 90, 115, 145, 179, 217, 257], float)

    fig, axes = plt.subplots(1, 2, figsize=(9, 3.2))
    axes[0].bar(years, subs, width=0.65, alpha=0.75)
    axes[0].set_ylim([5.5, 7.0])
    axes[0].set_title("Mobile subscribers")
    axes[0].set_ylabel("Billions of mobile subscribers")
    axes[0].set_xlabel("Year")
    axes[1].bar(years, traffic, width=0.65, alpha=0.75,
                color=CB_COLOR_CYCLE[1])
    axes[1].set_title("Global mobile data traffic")
    axes[1].set_ylabel("Exabytes per month")
    axes[1].set_xlabel("Year")
    for ax in axes:
        ax.set_axisbelow(True)
        ax.grid(axis="y")
    fig.tight_layout()
    if save_path:
        fig.savefig(save_path, dpi=600, bbox_inches="tight")
    if show:
        plt.show()
    return fig, axes
