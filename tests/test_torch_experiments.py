"""The port's BER experiments and CLI held against the JAX package's on the
CPU, at the small shape (n_fft 256) with stop criteria that end each point
after a few rounds: every ported experiment writes the file JAX's writes,
with the same CSV shape; the canonical LOS sweep's BERs agree with JAX's
statistically; the TOI alpha estimate agrees; and the CLI lists, rejects
and runs experiments.
"""

import csv

import numpy as np
import pytest

from mimo_ofdm_tpu.experiments import EXPERIMENTS as JAX_EXPERIMENTS
from mimo_ofdm_tpu_torch.experiments import EXPERIMENTS
from mimo_ofdm_tpu_torch.experiments import __main__ as cli
from mimo_ofdm_tpu_torch.experiments import ber_sweeps
from mimo_ofdm_tpu_torch.utils import results

FEW = dict(n_iters=1, n_err_min=10 ** 9, bits_sent_max=2 * 4 * 768, batch=4,
           small=True, verbose=False)
RUNS = {
    "miso_ber_vs_ebn0": dict(FEW, n_ant=4, ebn0_min=8.0, ebn0_max=10.0, ebn0_step=2.0,
                             channels=("los", "two_path")),
    "miso_ber_vs_ibo": dict(FEW, n_ant=4, ibo_values=(0.0, 3.0), no_noise=True),
    "miso_ber_vs_nant": dict(FEW, n_ant_values=(1, 2), channels=("los", "rayleigh")),
    "req_ebn0_vs_ibo": dict(FEW, n_ant=4, ibo_min=0.0, ibo_max=3.0, ibo_step=2.0,
                            ebn0_min=8.0, ebn0_max=11.0, ebn0_step=2.0),
    "awgn_ber_vs_ebn0": dict(FEW, ebn0_min=6.0, ebn0_max=8.0),
    "csi_err_ber_vs_ebn0": dict(FEW, n_ant=4, csi_eps=(0.0, 0.1), ebn0_min=8.0,
                                ebn0_max=10.0, ebn0_step=2.0),
    "csi_noise_ber_vs_ebn0": dict(FEW, n_ant=4, csi_snr_db=(15.0,), ebn0_min=8.0,
                                  ebn0_max=10.0, ebn0_step=2.0),
    "toi_ber_vs_ebn0": dict(FEW, ebn0_min=8.0, ebn0_max=10.0, ebn0_step=2.0,
                            n_est_symbols=64),
    "multiuser_ber": dict(FEW, n_ant=4, ebn0_min=8.0, ebn0_max=10.0, ebn0_step=2.0),
}


def _csv_shapes(directory):
    out = {}
    for path in sorted(directory.glob("*.csv")):
        with open(path, newline="") as f:
            out[path.name] = [len(r) for r in csv.reader(f)]
    return out


# the LDPC-coded experiments, held against JAX in tests/test_torch_experiments_ldpc.py
CODED = {"ldpc_coded_ber", "transport_coded_ber", "ldpc_ref_ber", "ldpc_in_loop_ber",
         "nvadj_ldpc_ber", "ldpc_table_sensitivity"}


# the analysis family, held against JAX in tests/test_torch_experiments_{analysis,scans,spatial}.py
ANALYSIS = {"reproduce_reference_curve", "beampattern", "mrt_radiation_pattern",
            "mu_radiation_pattern", "mu_sinr", "evm_vs_ibo", "sdr_vs_ibo", "mu_beampattern",
            "channel_corr", "spatial_corr", "psd_eval", "mu_sdr_vs_angle", "mu_sdr_vs_nusers",
            "alpha_eval", "complexity_eval", "pa_characteristics", "channel_tf",
            "alpha_vs_tx_pow", "precoding_nl_commutation", "siso_ser_vs_snr",
            "siso_rayleigh_zf_cnc"}


SCALING = {"weak_scaling"}              # tests/test_torch_sharding.py runs it


def test_registry_is_the_ported_experiments():
    assert set(EXPERIMENTS) == set(RUNS) | CODED | ANALYSIS | SCALING
    assert set(EXPERIMENTS) == set(JAX_EXPERIMENTS)


@pytest.mark.parametrize("name", sorted(RUNS))
def test_experiment_writes_jax_file(name, tmp_path, monkeypatch):
    """Same file names, same number of rows and of columns per row."""
    monkeypatch.setenv("MIMO_OFDM_TPU_RESULTS", str(tmp_path / "jax"))
    monkeypatch.setenv("MIMO_OFDM_TPU_TORCH_RESULTS", str(tmp_path / "port"))
    JAX_EXPERIMENTS[name](**RUNS[name])
    EXPERIMENTS[name](**RUNS[name], device="cpu")
    jax_files = _csv_shapes(tmp_path / "jax")
    assert jax_files and _csv_shapes(tmp_path / "port") == jax_files


def test_los_sweep_ber_matches_jax_statistically(tmp_path, monkeypatch):
    """miso_ber_vs_ebn0 on LOS at two Eb/N0 points, same stop criteria (a
    fixed bit budget, so both count the same bits): every BER within 5
    binomial standard deviations of JAX's."""
    monkeypatch.setenv("MIMO_OFDM_TPU_RESULTS", str(tmp_path / "jax"))
    kw = dict(channels=("los",), n_ant=8, n_iters=2, ebn0_min=6.0, ebn0_max=10.0,
              ebn0_step=4.0, n_err_min=10 ** 9, bits_sent_max=12 * 8 * 768,
              batch=8, small=True, verbose=False, save_csv=False)
    j = JAX_EXPERIMENTS["miso_ber_vs_ebn0"](**kw)["los"]
    p = EXPERIMENTS["miso_ber_vs_ebn0"](**kw, device="cpu")["los"]
    for jp, pp in zip(j.points, p.points):
        np.testing.assert_array_equal(pp.n_bits, jp.n_bits)
    bj, bp = j.ber_matrix, p.ber_matrix
    n = np.stack([pt.n_bits for pt in p.points], axis=1)
    pool = (bj + bp) / 2
    sd = np.sqrt(np.maximum(pool * (1 - pool), 1.0 / n) * 2.0 / n)
    assert np.all(np.abs(bp - bj) <= 5 * sd), (bj, bp)
    assert np.all(bp[1] > bp[-1]) and bp[0, 0] > 0      # CNC helps on LOS at IBO 0


def test_multiuser_ber_matches_jax(tmp_path, monkeypatch):
    """multiuser_ber (2 users, LOS, MRT, CNC, 8 iterations) at two Eb/N0
    points with a fixed bit budget: the CSV has JAX's name and layout
    (Eb/N0, then per user the clean row and it0..it8: 1 + 2 x 10 rows), and
    every per-user BER is within 5 binomial standard deviations of JAX's.
    (The far user's BER rises with the iterations under MRT cross-talk, in
    both packages.)"""
    monkeypatch.setenv("MIMO_OFDM_TPU_RESULTS", str(tmp_path / "jax"))
    monkeypatch.setenv("MIMO_OFDM_TPU_TORCH_RESULTS", str(tmp_path / "port"))
    n_bits = 6 * 8 * 768
    kw = dict(n_ant=8, n_iters=8, ebn0_min=10.0, ebn0_max=15.0, ebn0_step=5.0,
              n_err_min=10 ** 9, bits_sent_max=n_bits, batch=8, small=True, verbose=False)
    je, jb = JAX_EXPERIMENTS["multiuser_ber"](**kw)
    pe, pb = EXPERIMENTS["multiuser_ber"](**kw, device="cpu")
    np.testing.assert_array_equal(pe, je)
    files = _csv_shapes(tmp_path / "port")
    assert files == _csv_shapes(tmp_path / "jax") and list(files.values()) == [[2] * 21]
    x, ber = results.load_ber_sweep(next(iter(files)).removesuffix(".csv"), tmp_path / "port")
    np.testing.assert_array_equal(x, [10.0, 15.0])
    np.testing.assert_allclose(ber.reshape(2, 10, 2), pb, rtol=1e-12)
    pool = (jb + pb) / 2
    sd = np.sqrt(np.maximum(pool * (1 - pool), 1.0 / n_bits) * 2.0 / n_bits)
    assert np.all(np.abs(pb - jb) <= 5 * sd), (jb, pb)
    assert np.all(pb[0, 1] > pb[0, -1])          # CNC helps the near user at IBO 0


def test_toi_alpha_matches_jax():
    kw = dict(n_iters=1, ebn0_min=10.0, ebn0_max=10.0, n_err_min=10 ** 9,
              bits_sent_max=768, batch=1, n_est_symbols=256, small=True,
              verbose=False, save_csv=False)
    ja, _ = JAX_EXPERIMENTS["toi_ber_vs_ebn0"](**kw)
    pa, res = EXPERIMENTS["toi_ber_vs_ebn0"](**kw, device="cpu")
    assert abs(pa - ja) <= 0.02 * ja, (pa, ja)
    assert res.ber_matrix.shape == (3, 1)


def test_interp_req_ebn0_matches_jax():
    from mimo_ofdm_tpu.experiments import ber_sweeps as jax_sweeps
    rng = np.random.default_rng(4)
    grid = np.sort(rng.random((3, 6, 4)), axis=1)[:, ::-1] * 0.1
    grid[1, :, 2] = 0.05                             # a flat floor
    ebn0 = np.arange(6.0)
    for target in (1e-2, 0.05, 1.0):
        np.testing.assert_array_equal(ber_sweeps.interp_req_ebn0(grid, ebn0, target),
                                      jax_sweeps.interp_req_ebn0(grid, ebn0, target))


def test_cli_help_unknown_and_run(tmp_path, monkeypatch, capsys):
    assert cli.main(["--help"]) == 0
    listed = capsys.readouterr().out
    assert all(name in listed for name in EXPERIMENTS)
    assert cli.main(["no_such_experiment"]) == 1
    assert cli.main(["miso_ber_vs_ebn0", "n-ant"]) == 1
    monkeypatch.setenv("MIMO_OFDM_TPU_TORCH_RESULTS", str(tmp_path))
    assert cli.main(["miso_ber_vs_ebn0", "--device", "cpu", "--small", "True",
                     "--save-csv", "False", "--n-ant", "4", "--n-iters", "1",
                     "--ebn0-max", "6", "--bits-sent-max", "3072", "--batch", "4"]) == 0
    assert not list(tmp_path.iterdir())
    assert cli.main(["miso_ber_vs_ebn0", "--device", "cpu", "--small", "True",
                     "--n-ant", "4", "--n-iters", "2", "--ebn0-max", "6",
                     "--bits-sent-max", "3072", "--batch", "4"]) == 0
    name = results.ber_sweep_filename("ber_vs_ebn0", "cnc", "los", 4, 0.0,
                                      np.arange(5.0, 6.25, 0.5), [1, 2])
    x, ber = results.load_ber_sweep(name, tmp_path)
    np.testing.assert_array_equal(x, [5.0, 5.5, 6.0])
    assert ber.shape == (2 + 2, 3)
    assert cli.run_grid([("miso_ber_vs_ebn0", dict(n_ant="x", device="cpu")),
                         {"name": "awgn_ber_vs_ebn0", "device": "cpu", "small": True,
                          "save_csv": False, "verbose": False, "n_iters": 1,
                          "ebn0_min": 8.0, "ebn0_max": 8.0, "bits_sent_max": 768,
                          "batch": 1}]) == 1
