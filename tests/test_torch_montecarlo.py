"""The port's Monte-Carlo driver, result CSVs and metric helpers held
against the JAX package's on the CPU: the same scripted rounds through both
drivers give the same counters and round counts, every file name is JAX's
string, a saved sweep is byte for byte JAX's file, and the metrics agree.
"""

import numpy as np
import jax.numpy as jnp
import pytest
import torch

from mimo_ofdm_tpu.ops import metrics as jmetrics
from mimo_ofdm_tpu.parallel import montecarlo as jmc
from mimo_ofdm_tpu.utils import results as jresults

from mimo_ofdm_tpu_torch.models import link
from mimo_ofdm_tpu_torch.ops import metrics
from mimo_ofdm_tpu_torch.parallel import montecarlo as mc
from mimo_ofdm_tpu_torch.utils import config, results

N_COUNTERS = 4
BATCH = 4
N_BITS = 100


def _scripted(idx, snr) -> np.ndarray:
    """Counters that depend on the round index and SNR only; counter c has
    about (c + 1) x as many errors, so the counters stop at different
    rounds."""
    rng = np.random.default_rng([int(idx), int(round(float(snr) * 1000))])
    return (rng.integers(0, 20, N_COUNTERS) * (1 + np.arange(N_COUNTERS))).astype(np.int32)


def _jax_round(key, idx, snr):
    return jnp.asarray(_scripted(idx, snr))


def _port_round(key, idx, snr):
    return torch.from_numpy(_scripted(idx, snr))


STOPS = [dict(n_err_min=150, bits_sent_max=10 ** 9),
         dict(n_err_min=10 ** 9, bits_sent_max=7 * BATCH * N_BITS)]


def _same(a, b):
    np.testing.assert_array_equal(a.n_err, b.n_err)
    np.testing.assert_array_equal(a.n_bits, b.n_bits)
    assert a.n_rounds == b.n_rounds
    np.testing.assert_array_equal(a.ber, b.ber)


@pytest.mark.parametrize("depth", [1, 2, 3])
@pytest.mark.parametrize("stop", range(len(STOPS)))
def test_run_point_matches_jax(depth, stop):
    kw = dict(n_counters=N_COUNTERS, n_bits_per_frame=N_BITS, batch=BATCH,
              pipeline_depth=depth, **STOPS[stop])
    j = jmc.run_point(_jax_round, None, 12.5, idx_arg=True, **kw)
    p = mc.run_point(_port_round, 0, 12.5, **kw)
    _same(p, j)
    assert p.n_err.dtype == np.int64 and p.n_rounds > 2


@pytest.mark.parametrize("depth", [1, 2, 3])
@pytest.mark.parametrize("stop", range(len(STOPS)))
def test_run_sweep_pipelined_matches_jax(depth, stop):
    snrs = np.array([10.0, 12.5, 15.0])
    kw = dict(n_counters=N_COUNTERS, n_bits_per_frame=N_BITS, batch=BATCH,
              pipeline_depth=depth, max_rounds=40, **STOPS[stop])
    js = jmc.run_sweep_pipelined(_jax_round, jnp.zeros(2, jnp.uint32), snrs,
                                 idx_arg=True, **kw)
    ps = mc.run_sweep_pipelined(_port_round, 0, snrs, **kw)
    assert len(ps) == len(js) == 3
    for p, j in zip(ps, js):
        _same(p, j)
    res = mc.SweepResult(param_values=snrs, points=ps)
    jres = jmc.SweepResult(param_values=snrs, points=js)
    np.testing.assert_array_equal(res.ber_matrix, jres.ber_matrix)


def test_pipelined_points_use_round_seed_keys():
    """Point i runs under round_seed(seed, i) and round r under index r,
    the port's counterpart of fold_in(fold_in(key, i), r)."""
    seen = []

    def rf(key, idx, snr):
        seen.append((key, idx, snr))
        return torch.ones(2, dtype=torch.int32)

    mc.run_sweep_pipelined(rf, 7, [1.0, 2.0], n_counters=2, n_bits_per_frame=1,
                           batch=1, n_err_min=2, bits_sent_max=10, pipeline_depth=1)
    assert {(k, s) for k, _, s in seen} == {(link.round_seed(7, 0), 1.0),
                                            (link.round_seed(7, 1), 2.0)}
    assert [i for k, i, s in seen if s == 1.0] == [0, 1]


def test_run_ber_sweep_small_on_cpu():
    cfg, _ = config.canonical_miso_cnc()
    cfg = cfg.replace(modem=config.ModemConfig(n_fft=256, n_sub_carr=128),
                      array=config.ArrayConfig(n_elements=4))
    sweep = config.SweepConfig(ebn0_min=10.0, ebn0_max=14.0, ebn0_step=4.0,
                               n_err_min=10 ** 9, bits_sent_max=3 * 4 * 768,
                               batch_frames=4)
    res = mc.run_ber_sweep(cfg, sweep, 2, seed=1, device="cpu")
    np.testing.assert_array_equal(res.param_values, [10.0, 14.0])
    assert res.ber_matrix.shape == (4, 2)
    assert all(3 <= p.n_rounds <= 5 for p in res.points)
    assert np.all(res.ber_matrix < 0.5) and np.all(res.ber_matrix[0] < res.ber_matrix[1])
    assert res.frames_per_s > 0


FILENAME_CASES = [
    ("ber_sweep_filename", ("ber_vs_ebn0", "cnc", "los", 64, 0.0,
                            np.arange(5.0, 20.25, 0.5), list(range(1, 9)))),
    ("ber_sweep_filename", ("toi_ber_vs_ebn0", "mcnc", "two_path_csi_eps0.100", 1,
                            22.75, np.array([7.0]), [1, 2])),
    ("ber_vs_ibo_filename", ("cnc", "los", 16, 15.0, np.arange(0.0, 9.5, 0.5),
                             list(range(1, 9)))),
    ("ber_vs_nant_filename", ("mcnc", (1, 2, 4, 8), 15.0, 3.0, [1, 2, 3])),
    ("fixed_ber_filename", (1e-2, "cnc", "two_path", 64, np.arange(10.0, 22.1, 0.5),
                            np.arange(0.0, 8.0, 0.5), list(range(1, 9)))),
    ("mu_ber_filename", ("mr", "los", 64, 0.0, np.arange(5.0, 21.0, 1.0), [1, 2],
                         (-30, 30.5), (100, 316.3))),
    ("psd_filename", ("los", 3.0, 360, 10, 45.0, 64)),
    ("sig_powers_filename", ("two_path", -2.0, 181, 4, 30.0, 16, "zf")),
]


@pytest.mark.parametrize("name,args", FILENAME_CASES,
                         ids=[f"{n}-{i}" for i, (n, _) in enumerate(FILENAME_CASES)])
def test_filenames_match_jax(name, args):
    assert getattr(results, name)(*args) == getattr(jresults, name)(*args)


def test_save_ber_sweep_byte_identical(tmp_path):
    ebn0 = np.arange(5.0, 8.5, 0.5)
    ber = np.random.default_rng(3).random((10, len(ebn0))) * np.logspace(-1, -6, 10)[:, None]
    ber[3, 2] = 0.0
    jp = jresults.save_ber_sweep(ebn0, ber, "jax_sweep", tmp_path / "jax")
    pp = results.save_ber_sweep(ebn0, ber, "jax_sweep", tmp_path / "port")
    assert pp.read_bytes() == jp.read_bytes()
    x, m = results.load_ber_sweep("jax_sweep", tmp_path / "port")
    np.testing.assert_array_equal(x, ebn0)
    np.testing.assert_array_equal(m, ber)


def test_default_results_dir(monkeypatch, tmp_path):
    """The port writes to figs/csv_results_torch or its own environment
    variable, never to the JAX package's figs/csv_results."""
    monkeypatch.delenv("MIMO_OFDM_TPU_TORCH_RESULTS", raising=False)
    monkeypatch.setenv("MIMO_OFDM_TPU_RESULTS", str(tmp_path / "jax_dir"))
    assert results._resolve_dir(None).as_posix() == "figs/csv_results_torch"
    monkeypatch.setenv("MIMO_OFDM_TPU_TORCH_RESULTS", str(tmp_path / "port_dir"))
    path = results.save_to_csv([[1.0, 2.0]], "x")
    assert path == tmp_path / "port_dir" / "x.csv" and not (tmp_path / "jax_dir").exists()
    assert results.read_from_csv("x") == [[1.0, 2.0]]


def test_metrics_match_jax():
    ebn0 = np.array([0.0, 5.5, 20.0])
    for fn in ("ebn0_to_snr", "snr_to_ebn0"):
        np.testing.assert_allclose(getattr(metrics, fn)(ebn0, 4096, 2048, 64),
                                   getattr(jmetrics, fn)(ebn0, 4096, 2048, 64), rtol=1e-12)
    np.testing.assert_allclose(metrics.qam_awgn_ber_theory(64, ebn0),
                               jmetrics.qam_awgn_ber_theory(64, ebn0), rtol=1e-12)
    rng = np.random.default_rng(0)
    x = (rng.standard_normal((3, 64)) + 1j * rng.standard_normal((3, 64))).astype(np.complex64)
    y = (x + 0.1 * rng.standard_normal((3, 64))).astype(np.complex64)
    t = torch.from_numpy
    for fn, args in (("td_signal_power", (x,)), ("fd_signal_power", (x,)),
                     ("evm_rms", (y, x))):
        np.testing.assert_allclose(getattr(metrics, fn)(*map(t, args)).numpy(),
                                   np.asarray(getattr(jmetrics, fn)(*args)), rtol=1e-5)
    p = np.array([0.5, 2.0], np.float32)
    np.testing.assert_allclose(metrics.to_db(t(p)).numpy(), np.asarray(jmetrics.to_db(p)),
                               rtol=1e-6)
    np.testing.assert_allclose(metrics.to_db(p), np.asarray(jmetrics.to_db(p)), rtol=1e-6)
