"""The port's host-side utilities (mimo_ofdm_tpu_torch/utils/{replot,
plotting,spatial_plot,progress,baseline_cpu,compile_cache,profiling}.py)
held against the JAX package's: every replot function renders the
committed CSVs of figs/csv_results/ with each line's data, labels and
count equal to JAX's figure; the plot style, spatial plots and progress
bar equal JAX's; the CPU baseline frame draws and detects as JAX's does.
matplotlib is imported inside the tests only (Agg backend), so collection
needs it nowhere."""

import os
import subprocess
import sys

import numpy as np
import pytest
import torch

from mimo_ofdm_tpu.utils import baseline_cpu as j_baseline
from mimo_ofdm_tpu.utils import progress as j_progress
from mimo_ofdm_tpu.utils.config import LinkConfig as JLinkConfig

from mimo_ofdm_tpu_torch.kernels import fused_pa
from mimo_ofdm_tpu_torch.utils import baseline_cpu, compile_cache, profiling, progress, spans
from mimo_ofdm_tpu_torch.utils.config import LinkConfig

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
COMMITTED = os.path.join(REPO, "figs", "csv_results")
ITERS = list(range(1, 9))


@pytest.fixture
def plt():
    mpl = pytest.importorskip("matplotlib")
    mpl.use("Agg")
    import matplotlib.pyplot as pyplot
    yield pyplot
    pyplot.close("all")


def figure_data(fig):
    """Every axes' lines (x, y[, z], label, style, colour), scatter offsets,
    title, axis labels, scales and legend texts (a 3-D line's data, not its
    projection, which depends on whether the figure was drawn)."""
    out = []
    for ax in fig.axes:
        lines = [(np.asarray(ln.get_data_3d() if hasattr(ln, "get_data_3d")
                             else ln.get_data(), float).tolist(), ln.get_label(),
                  ln.get_linestyle(), ln.get_color()) for ln in ax.get_lines()]
        cols = [np.asarray(getattr(c, "_offsets3d", c.get_offsets()), float).tolist()
                for c in ax.collections]
        legends = [[t.get_text() for t in leg.get_texts()]
                   for leg in [*ax.findobj(lambda o: o.__class__.__name__ == "Legend")]]
        out.append({"lines": lines, "collections": cols, "title": ax.get_title(),
                    "xlabel": ax.get_xlabel(), "ylabel": ax.get_ylabel(),
                    "xscale": ax.get_xscale(), "yscale": ax.get_yscale(),
                    "legends": legends, "n_bars": len(ax.patches)})
    return out


# (function name, positional args, keyword args) on committed CSVs
REPLOTS = [
    ("replot_ber_vs_ebn0", ("ber_vs_ebn0", "cnc", "los", 64, 0.0,
                            np.arange(5.0, 20.5, 0.5), ITERS), {}),
    ("replot_ber_vs_ibo", ("los", 64, 15.0, np.arange(0.0, 9.5, 0.5)), {}),
    ("replot_fixed_ber_req_ebn0_vs_ibo", ("los", 64, np.arange(10.0, 22.5, 0.5),
                                          np.arange(0.0, 7.25, 0.25)),
     {"ibo_arr_mcnc": np.arange(0.0, 7.5, 0.5)}),
    ("replot_ber_vs_nant", ((1, 2, 4, 8, 16, 32, 64, 128), 15.0, 0.0), {}),
    ("replot_ber_vs_ite", ("ber_vs_ebn0", ("cnc", "mcnc"), "los", 64, 0.0,
                           np.arange(5.0, 21.0, 1.0), ITERS, (10.0, 15.0)), {}),
    ("replot_mu_ber_vs_ebn0", ("mr", "los", 64, 0.0, np.arange(5.0, 21.0, 1.0), ITERS,
                               (-30, 30), (100, 316.3)), {}),
    ("replot_ldpc_ber", ("1/2", "los", 16, 0.0, np.arange(-5.0, 16.0, 2.0), [1, 2, 3]), {}),
    ("replot_ber_vs_csi_err", ("cnc", "los", 64, 0.0, np.arange(5.0, 21.0, 1.0), ITERS),
     {"eps_values": (0.1, 0.2)}),
    ("replot_sdr_vs_ibo", (), {}),
    ("replot_polar_beampattern", ("los", 3.0, 64), {}),
    ("replot_berin_berout_vs_ibo", ("los", 64), {}),
    ("replot_alpha_per_ant_vs_ibo", (64, 0.0), {}),
    ("replot_soft_limiter_tf", (), {}),
    ("replot_mobile_growth_bars", (), {}),
]
NO_CSV = ("replot_soft_limiter_tf", "replot_mobile_growth_bars")


@pytest.mark.parametrize("name,args,kw", REPLOTS, ids=[r[0] for r in REPLOTS])
def test_replot_equals_jax_figure(plt, tmp_path, name, args, kw):
    """Each of the 14 replot functions, on the committed CSVs (``results_dir``
    passed to both packages), draws the same figure as JAX's: every line's
    x and y data, label, style and colour, the line count, scatter and bar
    data, titles, axis labels, scales and legend texts, exactly; and it
    saves the figure where asked. One exception: the analytic Bussgang
    curve of ``replot_alpha_per_ant_vs_ibo``, which each package computes
    with its own float32 ``exp`` and ``erfc`` (JAX run in its default
    float32 mode), agrees within one float32 ulp (1.2e-7; 41 of its 100
    points differ by that much), not bit for bit."""
    import jax
    from mimo_ofdm_tpu.utils import replot as j_replot
    from mimo_ofdm_tpu_torch.utils import replot
    if name not in NO_CSV:
        kw = {**kw, "results_dir": COMMITTED}
    with jax.enable_x64(False):
        fig_j, _ = getattr(j_replot, name)(*args, **kw)
    fig_p, _ = getattr(replot, name)(*args, save_path=tmp_path / "fig.png", **kw)
    want, got = figure_data(fig_j), figure_data(fig_p)
    assert sum(len(a["lines"]) + a["n_bars"] for a in want) > 0
    if name == "replot_alpha_per_ant_vs_ibo":
        ((wx, wy), *w_rest), ((gx, gy), *g_rest) = want[0]["lines"][-1], got[0]["lines"][-1]
        assert w_rest[0] == g_rest[0] == "Analytical" and w_rest == g_rest and gx == wx
        np.testing.assert_allclose(gy, wy, rtol=0, atol=1.2e-7)
        want[0]["lines"].pop(), got[0]["lines"].pop()
    assert got == want
    assert (tmp_path / "fig.png").exists()


def test_replot_reads_the_port_results_dir_by_default(plt, tmp_path, monkeypatch):
    """Without ``results_dir`` the port reads its own results directory
    (``$MIMO_OFDM_TPU_TORCH_RESULTS``, else figs/csv_results_torch/)."""
    from mimo_ofdm_tpu_torch.utils import replot, results
    ebn0 = np.arange(5.0, 11.0, 1.0)
    ber = np.abs(np.random.default_rng(0).normal(size=(4, len(ebn0)))) * 1e-2 + 1e-5
    name = results.ber_sweep_filename("ber_vs_ebn0", "cnc", "los", 8, 0.0, ebn0, [1, 2])
    results.save_ber_sweep(ebn0, ber, name, tmp_path)
    monkeypatch.setenv("MIMO_OFDM_TPU_TORCH_RESULTS", str(tmp_path))
    _, ax = replot.replot_ber_vs_ebn0("ber_vs_ebn0", "cnc", "los", 8, 0.0, ebn0, [1, 2])
    assert len(ax.lines) == 4
    np.testing.assert_array_equal(ax.lines[0].get_ydata(), ber[0])


def test_plot_style_equals_jax(plt):
    """``set_latex_plot_style`` sets JAX's rcParams (both widths and TeX
    settings); ``reset_color_cycle`` restarts the cycle; the palette is
    JAX's."""
    from mimo_ofdm_tpu.utils import plotting as j_plotting
    from mimo_ofdm_tpu_torch.utils import plotting
    import matplotlib
    assert plotting.CB_COLOR_CYCLE == j_plotting.CB_COLOR_CYCLE
    for kw in ({}, {"use_tex": True, "fig_width_in": 5.0, "fig_height_in": 2.0}):
        matplotlib.rcdefaults()
        j_plotting.set_latex_plot_style(**kw)
        want = dict(matplotlib.rcParams)
        matplotlib.rcdefaults()
        plotting.set_latex_plot_style(**kw)
        assert dict(matplotlib.rcParams) == want
    matplotlib.rcdefaults()
    plt.figure()
    plt.plot([0, 1])
    plotting.reset_color_cycle()
    assert plt.plot([0, 1])[0].get_color() == plt.gca().lines[0].get_color()


@pytest.mark.parametrize("call", ["spatial_3d", "spatial_2d", "array_2d", "array_3d"])
def test_spatial_plots_equal_jax(plt, tmp_path, call):
    """The spatial and array-configuration plots draw JAX's figure data
    (scatter offsets, LOS line, titles, labels, legends)."""
    from mimo_ofdm_tpu.utils import spatial_plot as j_spatial
    from mimo_ofdm_tpu_torch.models.geometry import ula_positions
    from mimo_ofdm_tpu_torch.utils import spatial_plot
    pos = ula_positions(8, 3.5e9, cord_z=15.0)
    rx, pts = np.array([212.0, 212.0, 1.5]), np.array([[100.0, 50.0, 1.5], [80.0, 20.0, 1.5]])
    calls = {"spatial_3d": ("plot_spatial_config", (pos,), {"rx_pos": rx, "rx_points": pts}),
             "spatial_2d": ("plot_spatial_config", (pos,), {"rx_pos": rx, "plot_3d": False}),
             "array_2d": ("plot_array_config", (pos,), {}),
             "array_3d": ("plot_array_config", (pos,), {"plot_3d": True})}
    fn, args, kw = calls[call]
    fig_j, _ = getattr(j_spatial, fn)(*args, **kw)
    fig_p, _ = getattr(spatial_plot, fn)(*args, save_path=tmp_path / "s.png", **kw)
    assert figure_data(fig_p) == figure_data(fig_j)
    assert (tmp_path / "s.png").exists()


@pytest.mark.parametrize("it,total", [(0, 10), (3, 10), (10, 10)])
def test_progress_bar_equals_jax(capsys, it, total):
    """``print_progress_bar`` writes JAX's bytes, the newline at the end
    included."""
    j_progress.print_progress_bar(it, total, prefix="sweep", suffix="done", decimals=2)
    want = capsys.readouterr().out
    progress.print_progress_bar(it, total, prefix="sweep", suffix="done", decimals=2)
    assert capsys.readouterr().out == want
    assert want.endswith("\n") == (it >= total)


def test_baseline_frame_equals_jax(monkeypatch):
    """``run_baseline_frame`` on the same ``np.random.Generator`` draws the
    same randoms as JAX's (the generators end in the same state) and passes
    the same signals through every FFT call; its per-pass bit errors equal
    those of JAX's detections, which are recovered from the CNC replica's
    inputs (JAX's frame returns nothing)."""
    jcfg = JLinkConfig()
    pcfg = LinkConfig()
    cfg_small = dict(constel_size=16, n_fft=256, n_sub_carr=128)
    import dataclasses
    jcfg = dataclasses.replace(jcfg, modem=dataclasses.replace(jcfg.modem, **cfg_small),
                               array=dataclasses.replace(jcfg.array, n_elements=4))
    pcfg = dataclasses.replace(pcfg, modem=dataclasses.replace(pcfg.modem, **cfg_small),
                               array=dataclasses.replace(pcfg.array, n_elements=4))
    seen = {"jax": [], "port": []}

    def recorder(mod, side):
        inner = mod._ifft

        def rec(x):
            seen[side].append(np.array(x))
            return inner(x)
        monkeypatch.setattr(mod, "_ifft", rec)
    recorder(j_baseline, "jax")
    recorder(baseline_cpu, "port")
    rng0 = np.random.default_rng(5)
    h = (rng0.standard_normal((4, 256)) + 1j * rng0.standard_normal((4, 256))) / np.sqrt(2)
    rj, rp = np.random.default_rng(9), np.random.default_rng(9)
    assert j_baseline.run_baseline_frame(jcfg, 3, rj, h, 0.8) is None
    errors = baseline_cpu.run_baseline_frame(pcfg, 3, rp, h, 0.8)
    assert rj.bit_generator.state == rp.bit_generator.state
    assert len(seen["jax"]) == len(seen["port"]) == 4 + 3 + 1
    for a, b in zip(seen["jax"], seen["port"]):
        np.testing.assert_array_equal(a, b)
    # JAX's detections: the CNC passes embed the detected symbols
    bits = np.random.default_rng(9).integers(0, 2, 128 * 4).reshape(-1, 4)
    const = baseline_cpu._constellation_np(16)
    want = []
    for emb in seen["jax"][4:]:
        det = baseline_cpu._extract(emb, 128)
        idx = np.abs(det - const[:, None]).argmin(0)
        want.append(int(((idx[:, None] >> np.arange(3, -1, -1)) & 1 != bits).sum()))
    assert errors.tolist() == want and errors.dtype == np.int64
    assert errors[0] > 0


def test_baseline_frames_per_s_runs():
    """The baseline timer runs on the CPU and reports a rate."""
    import dataclasses
    cfg = LinkConfig()
    cfg = dataclasses.replace(cfg, modem=dataclasses.replace(cfg.modem, n_fft=256,
                                                             n_sub_carr=128),
                              array=dataclasses.replace(cfg.array, n_elements=2))
    assert baseline_cpu.measure_baseline_frames_per_s(cfg, 1, min_seconds=0.05) > 0


def test_compile_cache_redirects_the_kernel_build(tmp_path, monkeypatch):
    """``enable_persistent_cache`` points the kernel build at its argument,
    else at ``$MIMO_OFDM_TPU_TORCH_COMPILE_CACHE``; an ``off`` value
    disables it and keeps the default; with neither it leaves the default
    ``mimo_ofdm_tpu_torch/_build/`` in place."""
    default = fused_pa.BUILD_DIR
    assert default == fused_pa._PACKAGE_DIR / "_build"
    monkeypatch.setattr(fused_pa, "BUILD_DIR", default)
    monkeypatch.delenv(compile_cache.ENV_VAR, raising=False)
    assert compile_cache.enable_persistent_cache() == str(default)
    assert fused_pa.BUILD_DIR == default
    for off in ("off", "0", "None", "disabled"):
        monkeypatch.setenv(compile_cache.ENV_VAR, off)
        assert compile_cache.enable_persistent_cache(str(tmp_path)) is None
        assert fused_pa.BUILD_DIR == default
    monkeypatch.setenv(compile_cache.ENV_VAR, str(tmp_path / "env"))
    assert compile_cache.enable_persistent_cache() == str(tmp_path / "env")
    assert fused_pa.BUILD_DIR == tmp_path / "env"
    assert compile_cache.enable_persistent_cache(str(tmp_path / "arg")) == str(tmp_path / "arg")
    assert fused_pa.BUILD_DIR == tmp_path / "arg"


def test_wallclock_trace_and_throughput_meter(tmp_path, capsys):
    """``wallclock`` prints the reference's line, ``trace`` writes a Chrome
    trace of the body's ops, ``ThroughputMeter`` counts frames and bits."""
    with profiling.wallclock("label"):
        pass
    out = capsys.readouterr().out
    assert out.startswith("--- Computation time: ") and out.rstrip().endswith("--- label")
    with profiling.wallclock("quiet", verbose=False):
        pass
    assert capsys.readouterr().out == ""
    with profiling.trace(str(tmp_path / "tr")) as prof:
        torch.fft.fft(torch.ones(64, dtype=torch.complex64))
    assert prof is not None
    text = (tmp_path / "tr" / "trace.json").read_text()
    assert "fft" in text and "traceEvents" in text
    meter = profiling.ThroughputMeter()
    meter.add(10, 1000)
    meter.add(5, 500)
    assert (meter.frames, meter.bits) == (15, 1500)
    assert meter.frames_per_s > 0 and meter.bits_per_s > meter.frames_per_s


def test_device_work_by_class_splits_the_chain():
    """A synthetic Chrome trace and the program's spans on its clock: each
    kernel goes to the innermost span of a listed name around its launch,
    and the fused kernel's ms and launches are told apart from the
    conversions around it in the chain."""
    def launch(corr, ts):
        return {"cat": "cuda_runtime", "name": "cudaLaunchKernel", "ts": ts,
                "args": {"correlation": corr}}

    def kernel(corr, name, dur):
        return {"cat": "kernel", "name": name, "ts": 100, "dur": dur,
                "args": {"correlation": corr}}

    fused = "void (anonymous namespace)::fused_ifft_pa_fft_kernel<12, true, Planes<float> >"
    trace = {"traceEvents": [
        launch(1, 12), kernel(1, "elementwise_kernel<copy>", 40.0),
        launch(2, 20), kernel(2, fused, 200.0),
        launch(3, 25), kernel(3, "complex_kernel_cuda", 60.0),
        launch(4, 55), kernel(4, "decode_kernel", 500.0),
        launch(5, 70), kernel(5, fused, 100.0),
        {"cat": "gpu_memset", "name": "Memset", "dur": 5.0, "args": {"correlation": 6}}]}
    on_trace = [spans.TraceSpan(0, 80, "frame", -1, 0, {}),
                spans.TraceSpan(10, 40, "chain", 0, 0, {"rows": 4}),
                spans.TraceSpan(50, 60, "decode", 0, 0, {})]
    work = profiling.device_work_by_class(trace, on_trace, ("chain", "decode"))
    assert work["chain"] == pytest.approx({"ms": 0.3, "kernels": 3, "fused_ms": 0.2, "fused_kernels": 1})
    assert work["decode"] == pytest.approx({"ms": 0.5, "kernels": 1, "fused_ms": 0.0, "fused_kernels": 0})
    assert work["rest"] == pytest.approx({"ms": 0.105, "kernels": 1, "fused_ms": 0.1, "fused_kernels": 1})
    costs = profiling.chain_costs(work, rounds=2)
    assert costs == pytest.approx({"chain_ms_per_round": 0.15, "chain_fused_ms_per_round": 0.1,
                                   "conversion_ms_per_round": 0.05,
                                   "conversion_launches_per_round": 1.0})


def test_idle_share_is_a_union_over_the_traced_window():
    """Overlapping kernels count once, and the window runs from the trace's
    first event to its last, host events included."""
    def x(cat, ts, dur):
        return {"ph": "X", "cat": cat, "name": cat, "ts": ts, "dur": dur}

    trace = {"traceEvents": [x("cpu_op", 0, 5), x("kernel", 10, 20), x("kernel", 20, 20),
                             x("gpu_memcpy", 60, 10), x("cuda_runtime", 90, 10),
                             {"ph": "M", "name": "process_name"}]}
    assert profiling.idle_share(trace) == pytest.approx(1 - (30 + 10) / 100)


def test_port_imports_without_matplotlib():
    """Importing every module of the port needs no matplotlib (the card's
    machine has none): a fresh interpreter imports them all with
    matplotlib hidden."""
    code = ("import sys, pkgutil, importlib; sys.modules['matplotlib'] = None\n"
            "import mimo_ofdm_tpu_torch as p\n"
            "for m in pkgutil.walk_packages(p.__path__, 'mimo_ofdm_tpu_torch.'):\n"
            "    importlib.import_module(m.name)\n"
            "assert not any(k.startswith(('jax', 'mimo_ofdm_tpu.')) for k in sys.modules)\n"
            "print('ok')")
    out = subprocess.run([sys.executable, "-c", code], cwd=REPO, capture_output=True,
                         text=True, timeout=120)
    assert out.returncode == 0 and out.stdout.strip() == "ok", out.stderr[-2000:]
