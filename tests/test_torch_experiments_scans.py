"""The port's spatial scan experiments (EVM and SDR vs IBO, channel and
spatial correlation, the two-user and n-user SDR studies) held against the
JAX package's on the CPU: they write the files JAX's write (same names,
rows and cells per row) at n_fft 256 with a few points and snapshots;
``evm_vs_ibo`` returns JAX's EVMs on JAX's bits and fades; and the physics
checks of tests/test_analysis.py and tests/test_experiments.py hold on the
port. The other scans' values are held against JAX's in
tests/test_torch_analysis_scans.py and tests/test_torch_analysis_mu.py.

Tolerance. ``evm_vs_ibo`` runs op by op in JAX (a vmap, no jit), so the
channel, the AGC-equalized constellation and the EVM come out of the same
float32 operations: the EVMs agree within 1e-6 relative (measured 3.5e-7
on LOS, 7.5e-8 on Rayleigh).
"""

import csv

import numpy as np
import jax
import pytest

import torch_parity_draws as pdr
from mimo_ofdm_tpu.experiments import EXPERIMENTS as JAX_EXPERIMENTS

from mimo_ofdm_tpu_torch.experiments import EXPERIMENTS

Q = dict(small=True, verbose=False)
RUNS = {
    "evm_vs_ibo": dict(Q, n_ant=4, ibo_values=(0.0,), n_snapshots=2),
    "sdr_vs_ibo": dict(Q, channels=("los", "rayleigh"), n_ant_values=(4,),
                       ibo_values=(0.0, 4.0), n_snapshots=3),
    "channel_corr": dict(Q, channels=("rayleigh",), n_ant_values=(2, 4), n_points=12),
    "spatial_corr": dict(Q, channels=("los",), n_ant_values=(2,), n_points=6),
    "mu_sdr_vs_angle": dict(Q, n_ant=4, n_points=12),
    "mu_sdr_vs_nusers": dict(Q, n_users_values=(1, 2), n_ant=4, ibo_values=(0.0, 3.0),
                             n_snapshots=3),
}
SEED = 5
# the runs on JAX's draws: case -> arguments of evm_vs_ibo
PAIRED = {
    "evm_vs_ibo": dict(RUNS["evm_vs_ibo"], seed=SEED),
    "evm_vs_ibo_rayleigh": dict(Q, n_ant=4, channel="rayleigh", ibo_values=(0.0, 4.0),
                                n_snapshots=3, seed=SEED),
}


@pytest.fixture(scope="module")
def pairs(tmp_path_factory):
    """case -> :class:`torch_parity_draws.ExperimentPair`, each run once:
    the layout and value tests share it."""
    done = {}

    def get(case):
        if case not in done:
            kw = PAIRED[case]
            n_ant, n_ibo = kw["n_ant"], len(kw["ibo_values"])
            rayleigh = kw.get("channel") == "rayleigh"

            def draws():       # the same frames at every IBO
                b, f = pdr.experiment_evm(jax.random.key(SEED), kw["n_snapshots"], 6 * 128,
                                          (n_ant, 128) if rayleigh else None)
                return [b] * n_ibo, [f] * n_ibo if rayleigh else []
            done[case] = pdr.run_experiment_pair(
                JAX_EXPERIMENTS["evm_vs_ibo"], EXPERIMENTS["evm_vs_ibo"], kw, draws,
                tmp_path_factory.mktemp(case))
        return done[case]
    return get


def csv_layout(directory):
    """File name -> cells per row."""
    out = {}
    for path in sorted(directory.glob("*.csv")):
        with open(path, newline="") as f:
            out[path.name] = [len(r) for r in csv.reader(f)]
    return out


@pytest.mark.parametrize("name", sorted(RUNS))
def test_experiment_writes_jax_files(name, tmp_path, monkeypatch, pairs):
    """Same file names, same number of rows and of cells per row
    (``evm_vs_ibo``: the files of its run on JAX's draws)."""
    if name in PAIRED:
        tmp_path = pairs(name).directory
    else:
        monkeypatch.setenv("MIMO_OFDM_TPU_RESULTS", str(tmp_path / "jax"))
        monkeypatch.setenv("MIMO_OFDM_TPU_TORCH_RESULTS", str(tmp_path / "port"))
        JAX_EXPERIMENTS[name](**RUNS[name])
        EXPERIMENTS[name](**RUNS[name], device="cpu")
    jax_files = csv_layout(tmp_path / "jax")
    assert jax_files and csv_layout(tmp_path / "port") == jax_files


@pytest.mark.parametrize("case", sorted(PAIRED))
def test_evm_vs_ibo_matches_jax(pairs, case):
    """On JAX's bits (and Rayleigh fades): the IBO grid, and the RMS EVM of
    the AGC-equalized constellation at each IBO within 1e-6 relative."""
    pr = pairs(case)
    (ji, je), (pi, pe) = pr.jax, pr.port
    np.testing.assert_array_equal(pi, ji)
    np.testing.assert_allclose(pe, je, rtol=1e-6)


def test_evm_falls_with_ibo():
    ibo, evm = EXPERIMENTS["evm_vs_ibo"](n_ant=8, ibo_values=(0.0, 4.0, 8.0), n_snapshots=4,
                                         small=True, save_csv=False, verbose=False,
                                         device="cpu")
    assert evm[0] > evm[1] > evm[2]
    assert evm[0] > 0.1 and evm[2] < 0.02


def test_mu_sdr_experiments():
    """Two users co-located at the main angle are fully correlated and see
    the same SDR; the n-user SDR rises with IBO."""
    angles, corr, sdr = EXPERIMENTS["mu_sdr_vs_angle"](
        n_ant=4, main_angle_deg=60.0, n_points=18, n_snapshots=2, small=True,
        save_csv=False, verbose=False, device="cpu")
    assert angles.shape == corr.shape == (19,) and sdr.shape == (2, 19)
    np.testing.assert_allclose(corr[6], 1.0, atol=1e-5)
    np.testing.assert_allclose(sdr[0, 6], sdr[1, 6], atol=1e-3)
    out = EXPERIMENTS["mu_sdr_vs_nusers"](n_users_values=(1, 3), n_ant=8,
                                          ibo_values=(0.0, 6.0), n_snapshots=8, small=True,
                                          save_csv=False, verbose=False, device="cpu")
    assert out[1].shape == (2, 1) and out[3].shape == (2, 3)
    for s in out.values():
        assert np.all(s[1] > s[0])


def test_correlation_experiments():
    out = EXPERIMENTS["channel_corr"](channels=("los",), n_ant_values=(4, 8), n_points=18,
                                      small=True, save_csv=False, verbose=False,
                                      device="cpu")
    angles, mat = out["los"]
    assert mat.shape == (2, 19) and angles.shape == (19,)
    main = int(round(18 / 180 * 45.0))
    assert np.allclose(mat[:, main], 1.0, atol=1e-5) and np.all(mat.argmax(1) == main)
    angles2, mat2 = EXPERIMENTS["spatial_corr"](channels=("los",), n_ant_values=(4,),
                                                n_points=12, small=True, save_csv=False,
                                                verbose=False, device="cpu")["los"]
    assert mat2.shape == (1, 13) and angles2.shape == (13,)
