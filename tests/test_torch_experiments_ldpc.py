"""The port's six LDPC-coded experiments held against the JAX package's on
the CPU, at the small shape (n_fft 256, 768 coded bits a frame, 4 antennas)
with a fixed bit budget, so that both count the same bits: each writes
JAX's CSV files (BER and ``_bler``, same names, same rows and columns), and
every BER lies within 5 binomial standard deviations of JAX's. The CLI
lists and runs them.
"""

import csv

import numpy as np
import pytest

from mimo_ofdm_tpu.experiments import EXPERIMENTS as JAX_EXPERIMENTS
from mimo_ofdm_tpu_torch.experiments import EXPERIMENTS
from mimo_ofdm_tpu_torch.experiments import __main__ as cli
from mimo_ofdm_tpu_torch.utils import results

CODED = ("ldpc_coded_ber", "transport_coded_ber", "ldpc_ref_ber", "ldpc_in_loop_ber",
         "nvadj_ldpc_ber", "ldpc_table_sensitivity")
BATCH = 4
FEW = dict(n_ant=4, n_iters=1, ldpc_iters=4, n_err_min=10 ** 9, batch=BATCH, small=True,
           verbose=False)
ROUNDS = 6

RUNS = {   # (kwargs, payload bits a frame)
    "ldpc_coded_ber": (dict(FEW, ebn0_min=2.0, ebn0_max=6.0, ebn0_step=4.0), 384),
    "ldpc_coded_ber_ira": (dict(FEW, ebn0_min=2.0, ebn0_max=6.0, ebn0_step=4.0,
                                family="ira"), 384),
    "transport_coded_ber": (dict(FEW, ebn0_min=2.0, ebn0_max=6.0, ebn0_step=4.0,
                                 ldpc_algorithm="sumprod"), 360),
    "ldpc_ref_ber": (dict(FEW, ebn0_min=2.0, ebn0_max=6.0, ebn0_step=4.0), 384),
    "ldpc_in_loop_ber": (dict(FEW, ebn0_min=-2.0, ebn0_max=0.0, ebn0_step=2.0), 256),
    "nvadj_ldpc_ber": (dict(FEW, ebn0_min=6.0, ebn0_max=10.0, ebn0_step=4.0), 576),
}


def _csv_shapes(directory):
    out = {}
    for path in sorted(directory.glob("*.csv")):
        with open(path, newline="") as f:
            out[path.name] = [len(r) for r in csv.reader(f)]
    return out


def _ber(res):
    """The BER matrix ``[n_iters + 2, n_points]`` of any coded experiment."""
    if isinstance(res, tuple):
        return np.asarray(res[1])
    return res.ber_matrix


def _within_5_sd(bj, bp, n_bits):
    pool = (bj + bp) / 2
    sd = np.sqrt(np.maximum(pool * (1 - pool), 1.0 / n_bits) * 2.0 / n_bits)
    assert np.all(np.abs(bp - bj) <= 5 * sd), (bj, bp)


@pytest.mark.parametrize("name", sorted(RUNS))
def test_coded_experiment_matches_jax(name, tmp_path, monkeypatch):
    """Same CSV names and layouts (Eb/N0, clean, it0..itN; the transport
    experiments also a ``_bler`` file); BERs within 5 binomial standard
    deviations of JAX's over the same bit count."""
    monkeypatch.setenv("MIMO_OFDM_TPU_RESULTS", str(tmp_path / "jax"))
    monkeypatch.setenv("MIMO_OFDM_TPU_TORCH_RESULTS", str(tmp_path / "port"))
    kw, n_pay = RUNS[name]
    exp = name.removesuffix("_ira")
    n_bits = ROUNDS * BATCH * n_pay
    kw = dict(kw, bits_sent_max=n_bits)
    bj = _ber(JAX_EXPERIMENTS[exp](**kw))
    bp = _ber(EXPERIMENTS[exp](**kw, device="cpu"))
    files = _csv_shapes(tmp_path / "port")
    assert files and files == _csv_shapes(tmp_path / "jax")
    assert len(files) == (1 if name.endswith("_ira") else 2)
    assert all(shape == [2] * 4 for shape in files.values())      # Eb/N0, clean, it0, it1
    assert bp.shape == bj.shape == (3, 2)
    _within_5_sd(bj, bp, n_bits)
    assert bp[0, -1] < bp[0, 0]                                  # the clean BER falls


def test_table_sensitivity_matches_jax():
    """Draw 1 with sum-product and min-sum: the same labels, Eb/N0 grid and
    BERs within 5 binomial standard deviations; the draw is reset to 0."""
    from mimo_ofdm_tpu_torch.ops import nr_ldpc
    kw = dict(FEW, draws=(1,), ebn0_min=2.0, ebn0_max=6.0, ebn0_step=4.0,
              bits_sent_max=ROUNDS * BATCH * 384)
    j = JAX_EXPERIMENTS["ldpc_table_sensitivity"](**kw)
    p = EXPERIMENTS["ldpc_table_sensitivity"](**kw, device="cpu")
    assert list(p) == list(j) == ["draw1_sumprod", "draw1_minsum"]
    for label in p:
        np.testing.assert_array_equal(p[label][0], j[label][0])
        _within_5_sd(j[label][1], p[label][1], kw["bits_sent_max"])
    assert nr_ldpc._surrogate_draw == 0


def test_in_loop_rejects_serial_and_nvadj():
    with pytest.raises(ValueError, match="in_loop=True"):
        EXPERIMENTS["transport_coded_ber"](in_loop=True, nv_adjust=True, small=True,
                                           device="cpu")


def test_cli_lists_and_runs_coded(tmp_path, monkeypatch, capsys):
    assert set(CODED) <= set(EXPERIMENTS) and set(CODED) <= set(JAX_EXPERIMENTS)
    assert cli.main(["--help"]) == 0
    listed = capsys.readouterr().out
    assert all(name in listed for name in CODED)
    monkeypatch.setenv("MIMO_OFDM_TPU_TORCH_RESULTS", str(tmp_path))
    assert cli.main(["ldpc_ref_ber", "--device", "cpu", "--small", "True", "--n-ant", "4",
                     "--n-iters", "1", "--ldpc-iters", "2", "--ebn0-min", "4",
                     "--ebn0-max", "4", "--bits-sent-max", "768", "--batch", "2",
                     "--verbose", "False"]) == 0
    name = results.ber_sweep_filename("ldpc_1_2_ber_vs_ebn0", "cnc", "los", 4, 0.0,
                                      np.array([4.0]), [1])
    x, ber = results.load_ber_sweep(name, tmp_path)
    assert list(x) == [4.0] and ber.shape == (3, 1)
    assert (tmp_path / (name.replace("ber_vs_ebn0", "ber_vs_ebn0_bler") + ".csv")).exists()


@pytest.mark.parametrize("name", CODED)
def test_coded_experiments_need_a_card_unless_told_cpu(name):
    """Without ``device="cpu"`` an experiment runs on ``cuda``, and raises
    where there is none: nothing falls back to the CPU."""
    import torch
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        EXPERIMENTS[name](small=True, n_ant=4, n_iters=1, ebn0_min=4.0, ebn0_max=4.0,
                          bits_sent_max=768, batch=1, verbose=False)
