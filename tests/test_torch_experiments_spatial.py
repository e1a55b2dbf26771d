"""The port's radiation-pattern, beampattern and PSD experiments held
against the JAX package's on the CPU: they write the files JAX's write
(same names, rows, and cells per row, including the cumulative
python-list cells of ``mrt_radiation_pattern``) at n_fft 256 with a few
points and snapshots; ``mu_beampattern`` (linear, circular, planar with
the TOI PA) and ``psd_eval`` (soft limiter, TOI) return JAX's values on
JAX's bits; and the physics checks of tests/test_analysis.py and
tests/test_experiments.py hold on the port.

Tolerances, each about 3x the gap measured on these inputs. The
precoder, the saturation power and the TOI coefficient come out of float32
operations run op by op in both packages, summed in another order (the
users' channels are stacked in JAX, batched in the port): measured 3.6e-7
relative, asserted 1e-6. ``mu_beampattern`` maps a compiled function over
its points, which folds the constant factors of the LOS phase, so its
powers agree with the port to 1.6e-4 of the scan's peak (circular array;
5.7e-5 on the ULA), asserted 5e-4 (the same trap as
tests/test_torch_analysis.py). ``psd_eval`` runs op by op in JAX, so its
PSDs agree to float32 rounding: measured 1.7e-6 of the peak, asserted
5e-6.
"""

import ast
import csv

import numpy as np
import jax
import pytest

import torch_parity_draws as pdr
from mimo_ofdm_tpu.experiments import EXPERIMENTS as JAX_EXPERIMENTS
from mimo_ofdm_tpu.experiments import spatial as jax_spatial

from mimo_ofdm_tpu_torch.experiments import EXPERIMENTS
from mimo_ofdm_tpu_torch.experiments import spatial

Q = dict(small=True, verbose=False)
RUNS = {
    "beampattern": dict(Q, n_ant_values=(4,), n_points=12, n_snapshots=2),
    "mrt_radiation_pattern": dict(Q, channels=("los",), n_ant_values=(1, 4), n_points=12,
                                  n_snapshots=2),
    "mu_radiation_pattern": dict(Q, n_ant_values=(4,), n_points=12, n_snapshots=2),
    "mu_beampattern": dict(Q, n_ant=8, n_points=12, n_snapshots=2),
    "psd_eval": dict(Q, n_ant=4, n_snapshots=4),
}
N_BITS = 6 * 128
SEED = 3
# the runs on JAX's draws: case -> (experiment, arguments, users per frame)
PAIRED = {
    "mu_beampattern": ("mu_beampattern", dict(RUNS["mu_beampattern"], seed=SEED), 2),
    "mu_beampattern_circular": ("mu_beampattern", dict(
        Q, n_ant=8, geometry="circular", n_points=12, n_snapshots=2, seed=SEED), 2),
    "mu_beampattern_planar_toi": ("mu_beampattern", dict(
        Q, n_ant=16, geometry="planar", n_rows=4, n_cols=4, pa_model="toi", ibo_db=10.0,
        usr_angles_deg=((15.0, 15.0), (-15.0, -15.0)), n_points=36, n_snapshots=3,
        seed=SEED), 2),
    "psd_eval": ("psd_eval", dict(RUNS["psd_eval"], seed=SEED), None),
    "psd_eval_toi": ("psd_eval", dict(RUNS["psd_eval"], pa_model="toi", ibo_db=12.0,
                                      seed=SEED), None),
}


@pytest.fixture(scope="module")
def pairs(tmp_path_factory):
    """case -> :class:`torch_parity_draws.ExperimentPair`, each run once:
    the layout and value tests below share it."""
    done = {}

    def get(case):
        if case not in done:
            name, kw, n_usr = PAIRED[case]
            shape = (N_BITS,) if n_usr is None else (n_usr, N_BITS)

            def draws():
                return [pdr.scan_snapshot_bits(jax.random.key(SEED), kw["n_snapshots"],
                                               shape)], []
            done[case] = pdr.run_experiment_pair(JAX_EXPERIMENTS[name], EXPERIMENTS[name],
                                                 kw, draws, tmp_path_factory.mktemp(case))
        return done[case]
    return get


def _cells(directory):
    """File name -> rows, each a list of its cells as text."""
    out = {}
    for path in sorted(directory.glob("*.csv")):
        with open(path, newline="") as f:
            out[path.name] = list(csv.reader(f))
    return out


@pytest.mark.parametrize("name", sorted(RUNS))
def test_experiment_writes_jax_files(name, tmp_path, monkeypatch, pairs):
    """Same file names, rows and cells per row; a cell that holds a python
    list (the cumulative powers of mrt_radiation_pattern) holds a list of
    the same length. The experiments of ``PAIRED`` are checked on the
    files of their run on JAX's draws."""
    if name in PAIRED:
        tmp_path = pairs(name).directory
    else:
        monkeypatch.setenv("MIMO_OFDM_TPU_RESULTS", str(tmp_path / "jax"))
        monkeypatch.setenv("MIMO_OFDM_TPU_TORCH_RESULTS", str(tmp_path / "port"))
        JAX_EXPERIMENTS[name](**RUNS[name])
        EXPERIMENTS[name](**RUNS[name], device="cpu")
    jax_files, port_files = _cells(tmp_path / "jax"), _cells(tmp_path / "port")
    assert jax_files and set(port_files) == set(jax_files)
    for fname, rows in jax_files.items():
        assert [len(r) for r in port_files[fname]] == [len(r) for r in rows], fname
        for jr, pr in zip(rows, port_files[fname]):
            for jc, pc in zip(jr, pr):
                if jc.startswith("["):
                    assert len(ast.literal_eval(pc)) == len(ast.literal_eval(jc))


def test_mrt_radiation_pattern_cumulative_cells(tmp_path, monkeypatch):
    """The powers-vs-angle CSV holds one python-list cell per antenna count
    so far (the reference saves inside its loop), each of n_points+1
    powers, desired row then distortion row."""
    monkeypatch.setenv("MIMO_OFDM_TPU_TORCH_RESULTS", str(tmp_path))
    out = EXPERIMENTS["mrt_radiation_pattern"](**RUNS["mrt_radiation_pattern"], device="cpu")
    rows = _cells(tmp_path)["mrt_sig_powers_vs_angle_los_chan_ibo3_npoints12_nsnap2"
                            "_angle45_nant4.csv"]
    assert len(rows) == 2 and [len(r) for r in rows] == [2, 2]
    for cell, n_ant in zip(rows[0], (1, 4)):
        np.testing.assert_allclose(ast.literal_eval(cell), out[("los", n_ant)].desired_pow,
                                   rtol=1e-6)


def test_mu_beampattern_intermod_lobes():
    """Two-user MRT: the third-order clipping products beamform toward
    2 theta1 - theta2 and 2 theta2 - theta1
    (reference/main_multiuser/2_users_ula_distortion_angles_prediction.py)."""
    ang, d, e, pred = EXPERIMENTS["mu_beampattern"](
        n_ant=32, n_points=72, n_snapshots=4, usr_angles_deg=(-20.0, 20.0), small=True,
        save_csv=False, verbose=False, device="cpu")
    deg = np.degrees(ang)
    edb = 10 * np.log10(e / e.max())

    def at(a):
        return edb[int(np.argmin(abs(deg - a)))]

    assert pred == [-60.0, 60.0]
    assert at(-20) > -3 and at(20) > -3
    assert at(60) > at(40) + 3 and at(-60) > at(-40) + 3


def test_mu_beampattern_geometries():
    """ULA: the desired beam peaks at the users (+-30 deg); UCA: positive
    distortion everywhere; URA with the TOI PA and the gain estimated from
    the frames: a finite semisphere grid peaking in its central half."""
    ang, d, e, _ = EXPERIMENTS["mu_beampattern"](n_ant=16, n_points=36, n_snapshots=6,
                                                 small=True, seed=3, save_csv=False,
                                                 verbose=False, device="cpu")
    assert d.shape == (37,)
    top = set(np.round(np.degrees(ang[np.argsort(d)[-4:]])).astype(int))
    assert top & {-30, -35} and top & {30, 35}
    _, d, e, _ = EXPERIMENTS["mu_beampattern"](n_ant=16, geometry="circular", n_points=36,
                                               n_snapshots=6, small=True, seed=3,
                                               save_csv=False, verbose=False, device="cpu")
    assert d.shape == (37,) and np.all(e > 0)
    _, d, e, _ = EXPERIMENTS["mu_beampattern"](
        n_ant=16, geometry="planar", n_rows=4, n_cols=4,
        usr_angles_deg=((15.0, 15.0), (-15.0, -15.0)), pa_model="toi", ibo_db=10.0,
        n_points=100, n_snapshots=5, small=True, seed=4, save_csv=False, verbose=False,
        device="cpu")
    assert d.shape == (10, 10) and np.all(np.isfinite(e))
    pk = np.unravel_index(np.argmax(d), d.shape)
    assert 2 <= pk[0] <= 7 and 2 <= pk[1] <= 7


@pytest.mark.parametrize("case", ["mu_beampattern", "mu_beampattern_circular",
                                  "mu_beampattern_planar_toi"])
def test_mu_beampattern_matches_jax(pairs, case):
    """On JAX's bits: the same scan grid and predicted intermod directions;
    the multi-user precoder within 1e-6 of its peak, the saturation power
    and the TOI coefficient (from the precoded average power) within 1e-6;
    the desired and distortion powers within 5e-4 of the peak (planar: with
    the gain estimated from the frames)."""
    pr = pairs(case)
    (ja, jd, je, jpred), (pa_, pd, pe, ppred) = pr.jax, pr.port
    np.testing.assert_array_equal(pa_, ja)
    assert ppred == jpred and pd.shape == np.shape(jd)
    assert pdr.peak_rel(pr.port_tx["v"], pr.jax_tx["v"]) < 1e-6
    for k in ("sat", "toi_coeff"):
        np.testing.assert_allclose(pr.port_tx[k], pr.jax_tx[k], rtol=1e-6, err_msg=k)
    assert (float(pr.jax_tx["toi_coeff"]) != 0.0) == case.endswith("toi")
    assert pdr.peak_rel(pd, jd) < 5e-4 and pdr.peak_rel(pe, je) < 5e-4


def test_planar_user_position_equals_jax():
    for az, el in ((15.0, 15.0), (-15.0, -15.0), (0.0, 90.0), (-60.0, 30.0)):
        for center in ((0.0, 0.0, 15.0), (1.0, -2.0, 0.0)):
            assert (spatial._planar_user_position(az, el, 300.0, center)
                    == jax_spatial._planar_user_position(az, el, 300.0, center))


@pytest.mark.parametrize("case", ["psd_eval", "psd_eval_toi"])
def test_psd_eval_matches_jax(pairs, case):
    """On JAX's bits, soft limiter and TOI PA: the same frequency grid, the
    desired and distortion PSDs within 5e-6 of their peaks."""
    pr = pairs(case)
    (jf, jd, je), (pf, pd, pe) = pr.jax, pr.port
    np.testing.assert_array_equal(pf, jf)
    assert pdr.peak_rel(pd, jd) < 5e-6 and pdr.peak_rel(pe, je) < 5e-6


def test_beampattern_and_psd_physics():
    """beampattern: the desired peak at the precoded angle (-45 deg on the
    -90..90 grid); psd_eval: the desired PSD well above the distortion's."""
    out = EXPERIMENTS["beampattern"](n_ant_values=(16,), n_points=36, n_snapshots=4,
                                     small=True, save_csv=False, verbose=False, device="cpu")
    res = out[16]
    assert np.degrees(res.angles_rad[int(np.argmax(res.desired_pow))]) == pytest.approx(
        -45.0, abs=5.0)
    f, p_des, p_dist = EXPERIMENTS["psd_eval"](n_ant=8, n_snapshots=8, small=True,
                                               save_csv=False, verbose=False, device="cpu")
    assert f.shape == p_des.shape == p_dist.shape == (128,)
    assert p_des.mean() > 10 * p_dist.mean()
