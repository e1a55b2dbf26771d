"""The port's analysis-family experiments held against the JAX package's on
the CPU: the registry equals JAX's, all 37 experiments; every new
experiment needs ``device="cpu"`` where there is no card; the SISO frame's
counters equal JAX's frame run op by op on JAX's draws; ``reproduce_reference_curve``
reads the repo's committed canonical curve; the misc and SISO experiments
write the files JAX's write (same names, rows and cells per row), at n_fft
256 with a few points and snapshots; ``alpha_eval``, ``alpha_vs_tx_pow``
and ``precoding_nl_commutation`` return JAX's values on JAX's draws (each
tolerance in its test); and the physics checks of
tests/test_experiments.py hold on the port. The spatial experiments are in
tests/test_torch_experiments_spatial.py (radiation patterns, beampatterns,
PSDs) and tests/test_torch_experiments_scans.py (EVM, SDR, correlations).
"""

import csv
import dataclasses

import numpy as np
import jax
import pytest
import torch

import torch_parity_draws as pdr
from mimo_ofdm_tpu.experiments import EXPERIMENTS as JAX_EXPERIMENTS
from mimo_ofdm_tpu.experiments import siso_checks as jax_siso

from mimo_ofdm_tpu_torch.experiments import EXPERIMENTS
from mimo_ofdm_tpu_torch.experiments import __main__ as cli
from mimo_ofdm_tpu_torch.experiments import ber_sweeps, siso_checks
from mimo_ofdm_tpu_torch.ops.pa import bussgang_alpha

Q = dict(small=True, verbose=False)
SISO = dict(Q, snr_min=20.0, snr_max=24.0, snr_step=4.0, iters=(0, 1), batch=2,
            n_symb_err_min=10 ** 9, n_symb_sent_max=256)
RUNS = {
    "alpha_vs_tx_pow": dict(Q, n_ant=4, n_snapshots=4),
    "siso_ser_vs_snr": SISO,
    "siso_rayleigh_zf_cnc": SISO,
}
SEED, N_BITS = 7, 6 * 128
# the runs on JAX's draws: experiment -> arguments
PAIRED = {
    "alpha_vs_tx_pow": dict(RUNS["alpha_vs_tx_pow"], seed=SEED),
    "alpha_eval": dict(Q, n_ant=4, n_snapshots=4, seed=SEED),
    "precoding_nl_commutation": dict(verbose=False, n_frames=4, seed=SEED),
}


def _paired_draws(name):
    """JAX's draws of ``name`` in the order the port draws them: every
    snapshot of ``split(key(seed), n)``; alpha_vs_tx_pow per channel ``c``
    from ``k = fold_in(key(seed), c)``, its fade from ``fold_in(k, 999)``
    (``_point_channel``'s Rayleigh normals, drawn by the port on every
    channel), its snapshots from ``split(k, n)``."""
    kw, key = PAIRED[name], jax.random.key(SEED)
    n = kw.get("n_snapshots", kw.get("n_frames"))
    if name != "alpha_vs_tx_pow":
        return [pdr.scan_snapshot_bits(key, n, (N_BITS,))], []
    ks = [jax.random.fold_in(key, c) for c in range(3)]
    return ([pdr.scan_snapshot_bits(k, n, (N_BITS,)) for k in ks],
            [np.asarray(pdr.normals(jax.random.fold_in(k, 999), kw["n_ant"], 128))
             for k in ks])


@pytest.fixture(scope="module")
def pairs(tmp_path_factory):
    """experiment -> :class:`torch_parity_draws.ExperimentPair`, each run
    once: the layout and value tests share it."""
    done = {}

    def get(name):
        if name not in done:
            done[name] = pdr.run_experiment_pair(
                JAX_EXPERIMENTS[name], EXPERIMENTS[name], PAIRED[name],
                lambda: _paired_draws(name), tmp_path_factory.mktemp(name))
        return done[name]
    return get
# the experiments this slice ports (tests/test_torch_experiments.py holds the rest)
NEW = {"beampattern", "mrt_radiation_pattern", "mu_radiation_pattern", "mu_sinr",
       "evm_vs_ibo", "sdr_vs_ibo", "mu_beampattern", "channel_corr", "spatial_corr",
       "psd_eval", "mu_sdr_vs_angle", "mu_sdr_vs_nusers", "alpha_eval", "complexity_eval",
       "pa_characteristics", "channel_tf", "alpha_vs_tx_pow", "precoding_nl_commutation",
       "siso_ser_vs_snr", "siso_rayleigh_zf_cnc", "reproduce_reference_curve"}


def csv_layout(directory):
    """File name -> cells per row."""
    out = {}
    for path in sorted(directory.glob("*.csv")):
        with open(path, newline="") as f:
            out[path.name] = [len(r) for r in csv.reader(f)]
    return out


def test_registry_equals_jax_minus_weak_scaling():
    """The port registers every experiment of the JAX package, all 37, now
    ``weak_scaling`` (experiments/parallel_evals.py) too."""
    assert set(EXPERIMENTS) == set(JAX_EXPERIMENTS)
    assert len(EXPERIMENTS) == 37 and NEW | {"weak_scaling"} <= set(EXPERIMENTS)


@pytest.mark.parametrize("name", sorted(NEW))
def test_new_experiment_runs_on_the_card_by_default(name):
    """Without ``device`` an experiment runs on the card; where there is
    none, it raises instead of falling back to the CPU."""
    if torch.cuda.is_available():
        assert "device" in EXPERIMENTS[name].__code__.co_varnames
        return
    with pytest.raises(RuntimeError, match="no CUDA device"):
        EXPERIMENTS[name](verbose=False)


@pytest.mark.parametrize("name", sorted(RUNS))
def test_experiment_writes_jax_files(name, tmp_path, monkeypatch, pairs):
    """Same file names, same number of rows and of cells per row
    (``alpha_vs_tx_pow``: the files of its run on JAX's draws)."""
    if name in PAIRED:
        tmp_path = pairs(name).directory
    else:
        monkeypatch.setenv("MIMO_OFDM_TPU_RESULTS", str(tmp_path / "jax"))
        monkeypatch.setenv("MIMO_OFDM_TPU_TORCH_RESULTS", str(tmp_path / "port"))
        JAX_EXPERIMENTS[name](**RUNS[name])
        EXPERIMENTS[name](**RUNS[name], device="cpu")
    jax_files = csv_layout(tmp_path / "jax")
    assert jax_files and csv_layout(tmp_path / "port") == jax_files


def test_results_without_csv_match_jax():
    """complexity_eval exactly; pa_characteristics and the deterministic
    two-path channel_tf within float32 rounding (the channel's magnitude:
    the compiled JAX run rounds the ~2e4 rad phases otherwise)."""
    j, p = JAX_EXPERIMENTS["complexity_eval"](verbose=False), \
        EXPERIMENTS["complexity_eval"](verbose=False, device="cpu")
    for k in ("std", "cnc", "mcnc"):
        for a, b in zip(p[k], j[k]):
            np.testing.assert_array_equal(a, b)
    with jax.enable_x64(False):
        for model in ("softlim", "rapp", "toi"):
            jx, jy = JAX_EXPERIMENTS["pa_characteristics"](model=model, ibo_db=2.0,
                                                           verbose=False)
            px, py = EXPERIMENTS["pa_characteristics"](model=model, ibo_db=2.0,
                                                       verbose=False, device="cpu")
            np.testing.assert_array_equal(px, jx)
            np.testing.assert_allclose(py, jy, rtol=1e-6, atol=1e-6)
        jh = JAX_EXPERIMENTS["channel_tf"](channel="two_path", n_ant=2, verbose=False)
    ph = EXPERIMENTS["channel_tf"](channel="two_path", n_ant=2, verbose=False, device="cpu")
    assert ph.shape == (2, 256) and ph.dtype == torch.complex64
    np.testing.assert_allclose(ph.abs().numpy(), np.abs(jh), rtol=1e-2)


@pytest.mark.parametrize("rayleigh", [False, True], ids=["awgn", "rayleigh"])
def test_siso_frame_counters_equal_jax(rayleigh):
    """The SISO frame (clean run, clipped run, CNC with 3 iterations) on
    JAX's draws: per-frame symbol-error counters EQUAL those of JAX's frame
    run op by op, at the same measured eta."""
    m, n_fft, n_sc, ibo, n_iters, snr = 64, 256, 128, 0.0, 3, 21.0
    keys = jax.random.split(jax.random.key(11), 6)
    with jax.enable_x64(False):
        eta = jax_siso._measure_eta(m, n_fft, n_sc, ibo)
        frame = jax_siso._make_siso_frame_fn(m, n_fft, n_sc, ibo, n_iters, eta, rayleigh)
        with jax.disable_jit():
            jc, jd = jax.vmap(frame, in_axes=(0, None))(keys, np.float32(snr))
        draws = pdr.siso_draws(keys, n_sc, 6 * n_sc, rayleigh)
    pc, pd = siso_checks._make_siso_frame_fn(m, n_fft, n_sc, ibo, n_iters, eta, rayleigh,
                                             device="cpu")(snr, draws)
    assert pd.shape == (6, n_iters + 1) and pd.dtype == torch.int32
    np.testing.assert_array_equal(pc.numpy(), np.asarray(jc))
    np.testing.assert_array_equal(pd.numpy(), np.asarray(jd))
    assert np.asarray(jd).sum() > 0


def test_measure_eta_near_alpha_squared():
    """The clipped signal's in-band power ratio sits just above alpha^2
    (the Bussgang part's power plus the in-band share of the distortion)."""
    eta = siso_checks._measure_eta(64, 256, 128, 0.0, device="cpu")
    a2 = float(bussgang_alpha(0.0)) ** 2
    assert a2 < eta < a2 + 0.1


def test_siso_cnc_converges():
    """AWGN at 27 dB: the clean SER is the lowest, CNC lowers the distorted
    SER pass by pass (the committed figure's convergence)."""
    snrs, ser = EXPERIMENTS["siso_ser_vs_snr"](
        small=True, batch=16, n_symb_err_min=10 ** 9, n_symb_sent_max=16 * 128 * 4,
        snr_min=27.0, snr_max=27.0, iters=(0, 3, 12), save_csv=False, verbose=False,
        device="cpu")
    assert ser.shape == (4, 1)
    assert ser[0, 0] < ser[3, 0] < ser[2, 0] < ser[1, 0]


def test_reproduce_reference_curve_reads_the_committed_curve():
    """At full width, one round of one frame at 18 dB: the reference column
    is the committed CSV's at 18 dB, the measured vector has the ten
    counters [clean, it0..it8]."""
    with open(ber_sweeps.REFERENCE_CURVE_CSV, newline="") as f:
        rows = [[float(x) for x in r] for r in csv.reader(f)]
    col = rows[0].index(18.0)
    out = EXPERIMENTS["reproduce_reference_curve"](
        ebn0_points=(18.0,), n_err_min=10 ** 9, bits_sent_max=1, batch=1, verbose=False,
        device="cpu")
    ref, ours, pt = out[18.0]
    np.testing.assert_array_equal(ref, [r[col] for r in rows[1:11]])
    assert ours.shape == (10,) and np.all((0 <= ours) & (ours < 0.5))
    assert pt.n_rounds == 3                       # the pipeline's 3 rounds in flight
    np.testing.assert_array_equal(ours, pt.n_err / (3 * 12288))


def test_siso_awgn_config_equals_jax():
    from mimo_ofdm_tpu.utils.config import siso_awgn as jax_siso_awgn
    from mimo_ofdm_tpu_torch.utils.config import config_from_dict, siso_awgn
    cfg = siso_awgn()
    assert cfg == config_from_dict(dataclasses.asdict(jax_siso_awgn()))
    assert (cfg.array.n_elements, cfg.channel.model, cfg.precoding) == (1, "awgn", "none")


def test_cli_runs_sdr_vs_ibo_on_the_cpu(capsys):
    assert cli.main(["sdr_vs_ibo", "--small", "True", "--device", "cpu", "--save-csv",
                     "False", "--n-ant-values", "(4,)", "--ibo-values", "(0.0,4.0)",
                     "--n-snapshots", "4"]) == 0
    assert "nant4 rayleigh: SDR[dB]" in capsys.readouterr().out


def test_alpha_experiments_match_jax(pairs):
    """On JAX's bits and fades. alpha_eval (op by op in JAX): the analytic
    and the empirical alphas (JAX: over the time samples; the port: over
    the data bins, by Parseval) within 1e-6 relative, 3x the 3.6e-7
    measured. alpha_vs_tx_pow, compiled in JAX: on Rayleigh each antenna's
    IBO within 2e-6 dB and its lambda within 1e-6 (measured 5.3e-7 dB and
    1.5e-7). On LOS and two-path the compiled run folds the constant factors
    of the phases, and on two-path the near-cancelling sum of both paths
    sets each antenna's power: measured 3.1e-6 dB and 8.6e-6 on LOS, 3.1e-4
    dB and 3.1e-5 on two-path (against JAX run op by op: 3.1e-6 dB and
    2.3e-7, 8e-7 dB and 1.6e-7), asserted 1e-5 dB and 3e-5, 1e-3 dB and
    1e-4. The analytic curve spans the IBOs found, so it moves with them:
    within 5e-4 dB and 5e-5."""
    (ja, je), (pa_, pe) = pairs("alpha_eval").jax, pairs("alpha_eval").port
    np.testing.assert_allclose(pa_, ja, rtol=1e-6)
    np.testing.assert_allclose(pe, je, rtol=1e-6)
    pr = pairs("alpha_vs_tx_pow")
    (jibo, jlam, jrng, jana), (pibo, plam, prng, pana) = pr.jax, pr.port
    assert PAIRED["alpha_vs_tx_pow"].get("channels_lst") is None    # rayleigh, two_path, los
    for c, (ibo_tol, lam_tol) in enumerate(((2e-6, 1e-6), (1e-3, 1e-4), (1e-5, 3e-5))):
        np.testing.assert_allclose(pibo[c], jibo[c], rtol=0, atol=ibo_tol)
        np.testing.assert_allclose(plam[c], jlam[c], rtol=lam_tol)
    np.testing.assert_allclose(prng, jrng, rtol=0, atol=5e-4)
    np.testing.assert_allclose(pana, jana, rtol=5e-5)


def test_alpha_experiments_land_on_the_analytic_curve():
    """alpha_eval: the empirical per-antenna alpha within 2% of the closed
    form; alpha_vs_tx_pow: lambda at each antenna's own IBO within 0.01 of
    alpha(IBO) on every channel."""
    analytic, emp = EXPERIMENTS["alpha_eval"](n_ant=4, n_snapshots=16, verbose=False,
                                              small=True, device="cpu")
    np.testing.assert_allclose(emp, analytic, rtol=0.02)
    ibo, lam, rng, ana = EXPERIMENTS["alpha_vs_tx_pow"](n_ant=8, n_snapshots=64, small=True,
                                                        save_csv=False, verbose=False,
                                                        device="cpu")
    np.testing.assert_allclose(lam, bussgang_alpha(ibo).numpy(), atol=0.01)
    assert rng.shape == ana.shape == (100,)


def test_precoding_nl_commutation_matches_jax(pairs):
    """On JAX's bits: the three precoders' EVMs within 5e-7 relative (3x
    the 1.7e-7 measured)."""
    j, p = pairs("precoding_nl_commutation").jax, pairs("precoding_nl_commutation").port
    assert set(p) == set(j) == {"none", "flat", "swept"}
    for k in j:
        assert p[k] == pytest.approx(j[k], rel=5e-7), k


def test_precoding_nl_commutation_flat_equals_none():
    out = EXPERIMENTS["precoding_nl_commutation"](n_frames=16, small=True, verbose=False,
                                                  seed=3, device="cpu")
    assert out["flat"] == pytest.approx(out["none"], rel=1e-5)
    assert abs(out["swept"] - out["none"]) > 1e-3 * out["none"]


def test_pa_characteristics_and_complexity():
    x, y = EXPERIMENTS["pa_characteristics"](model="softlim", verbose=False, device="cpu")
    assert np.max(y) == pytest.approx(1.0, rel=1e-6)   # clipped at sqrt(sat) = 1
    out = EXPERIMENTS["complexity_eval"](verbose=False, device="cpu")
    (cnc_add, cnc_mul), (mcnc_add, _), (std_add, std_mul) = (out["cnc"], out["mcnc"],
                                                             out["std"])
    assert cnc_add[0] == std_add and cnc_mul[0] == std_mul
    assert (mcnc_add[1] - mcnc_add[0]) > 30 * (cnc_add[1] - cnc_add[0])
