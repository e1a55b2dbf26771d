"""Result CSV I/O with the reference's schema and file names
(the port's own copy of ``mimo_ofdm_tpu/utils/results.py``; the files it
writes are byte for byte the JAX package's).

Schema (``reference/docs/source/usage.rst:37-56``): row 0 holds the swept
parameter values, the following rows hold the measured metric per
configuration (e.g. clean run, then one row per CNC iteration count).

The default directory is ``figs/csv_results_torch/`` (or
``$MIMO_OFDM_TPU_TORCH_RESULTS``), never the JAX package's
``figs/csv_results/``, whose committed files are evidence the port must not
overwrite.
"""

from __future__ import annotations

import csv
import os
from pathlib import Path

import numpy as np

DEFAULT_RESULTS_DIR = None  # sentinel: resolve MIMO_OFDM_TPU_TORCH_RESULTS lazily


def _resolve_dir(results_dir) -> Path:
    if results_dir is None:
        results_dir = os.environ.get("MIMO_OFDM_TPU_TORCH_RESULTS",
                                     "figs/csv_results_torch")
    return Path(results_dir)


def save_to_csv(data_lst: list, filename: str,
                results_dir: str | Path = DEFAULT_RESULTS_DIR) -> Path:
    """Write a list of flat vectors as CSV rows
    (``reference/utilities.py:342-352``). Creates the directory if needed
    and returns the written path."""
    results_dir = _resolve_dir(results_dir)
    results_dir.mkdir(parents=True, exist_ok=True)
    path = results_dir / f"{filename}.csv"
    with open(path, "w", newline="") as f:
        writer = csv.writer(f)
        writer.writerows([np.asarray(row).tolist() for row in data_lst])
    return path


def read_from_csv(filename: str,
                  results_dir: str | Path = DEFAULT_RESULTS_DIR) -> list:
    """Read CSV rows as float lists (``reference/utilities.py:355-365``)."""
    path = _resolve_dir(results_dir) / f"{filename}.csv"
    with open(path, newline="") as f:
        return list(csv.reader(f, quoting=csv.QUOTE_NONNUMERIC))


def _num(v) -> str:
    """Number formatting of the reference's ``'_'.join(str(val) ...)``
    filename blocks: integral values print without a decimal point
    (``str(-30)`` -> ``-30``), non-integral as their float repr."""
    f = float(v)
    return str(int(f)) if f == int(f) else str(f)


def _iters(cnc_iter_lst) -> str:
    return "_".join(str(int(v)) for v in cnc_iter_lst)


def ber_sweep_filename(kind: str, rx_name: str, chan_name: str, n_ant: int,
                       ibo_db: float, ebn0_arr: np.ndarray,
                       cnc_iter_lst) -> str:
    """File name of BER-vs-Eb/N0 sweeps
    (``reference/main_clipping_noise_cancellation/main_miso_cnc_ber_vs_ebn0.py:279-281``)."""
    step = ebn0_arr[1] - ebn0_arr[0] if len(ebn0_arr) > 1 else 0.0
    return (f"{kind}_{rx_name}_{chan_name}_nant{n_ant}_ibo{int(ibo_db)}"
            f"_ebn0_min{int(min(ebn0_arr))}_max{int(max(ebn0_arr))}"
            f"_step{step:1.2f}_niter{_iters(cnc_iter_lst)}")


def ber_vs_ibo_filename(rx_name: str, chan_name: str, n_ant: int,
                        ebn0_db: float, ibo_arr: np.ndarray,
                        cnc_iter_lst) -> str:
    """File name of BER-vs-IBO sweeps
    (``reference/main_clipping_noise_cancellation/main_miso_cnc_ber_vs_ibo.py:212-215``)."""
    step = ibo_arr[1] - ibo_arr[0] if len(ibo_arr) > 1 else 0.0
    return (f"ber_vs_ibo_{rx_name}_{chan_name}_nant{n_ant}_ebn0_{int(ebn0_db)}"
            f"_ibo_min{int(min(ibo_arr))}_max{int(max(ibo_arr))}"
            f"_step{step:1.2f}_niter{_iters(cnc_iter_lst)}")


def ber_vs_nant_filename(rx_name: str, n_ant_arr, ebn0_db: float,
                         ibo_db: float, cnc_iter_lst) -> str:
    """File name of BER-vs-antenna-count sweeps
    (``reference/main_clipping_noise_cancellation/main_miso_cnc_ber_vs_nant_vs_chan.py:273-274``)."""
    nants = "_".join(str(int(v)) for v in n_ant_arr)
    return (f"ber_vs_nant_{rx_name}_nant{nants}_ebn0_{int(ebn0_db)}"
            f"_ibo{int(ibo_db)}_niter{_iters(cnc_iter_lst)}")


def fixed_ber_filename(target_ber: float, rx_name: str, chan_name: str,
                       n_ant: int, ebn0_arr: np.ndarray, ibo_arr: np.ndarray,
                       cnc_iter_lst) -> str:
    """File name of the fixed-BER required-Eb/N0 grids
    (``reference/main_mp_clipping_noise_cancellation/main_mp_miso_cnc_constant_ber_req_ebn0_vs_ibo.py:198-201``)."""
    e_step = ebn0_arr[1] - ebn0_arr[0] if len(ebn0_arr) > 1 else 0.0
    i_step = ibo_arr[1] - ibo_arr[0] if len(ibo_arr) > 1 else 0.0
    return (f"fixed_ber{target_ber:1.1e}_{rx_name}_{chan_name}_nant{n_ant}"
            f"_ebn0_min{int(min(ebn0_arr))}_max{int(max(ebn0_arr))}"
            f"_step{e_step:1.2f}"
            f"_ibo_min{int(min(ibo_arr))}_max{int(max(ibo_arr))}"
            f"_step{i_step:1.2f}_niter{_iters(cnc_iter_lst)}")


def mu_ber_filename(precoding_str: str, chan_name: str, n_ant: int,
                    ibo_db: float, ebn0_arr: np.ndarray, cnc_iter_lst,
                    usr_angles, usr_distances, rx_name: str = "cnc") -> str:
    """File name of multi-user BER sweeps
    (``reference/main_multiuser/main_multiuser_cnc_ber_vs_ebn0.py:652-656``);
    ``precoding_str`` uses the reference spelling (``mr``/``zf``)."""
    step = ebn0_arr[1] - ebn0_arr[0] if len(ebn0_arr) > 1 else 0.0
    angles = "_".join(_num(a) for a in usr_angles)
    dists = "_".join(_num(d) for d in usr_distances)
    return (f"ber_vs_ebn0_mu_{precoding_str}_{rx_name}_{chan_name}"
            f"_nant{n_ant}_ibo{int(ibo_db)}"
            f"_ebn0_min{int(min(ebn0_arr))}_max{int(max(ebn0_arr))}"
            f"_step{step:1.2f}_niter{_iters(cnc_iter_lst)}"
            f"_angles{angles}_distances{dists}")


def psd_filename(chan_name: str, ibo_db: float, n_points: int,
                 n_snapshots: int, angle_deg: float, n_ant: int,
                 prefix: str = "psd_mrt") -> str:
    """File name of the per-angle Welch PSDs of the radiation pattern scan
    (``reference/main_beampatterns_plotting/main_mrt_precoding_radiation_pattern.py:205-206``)."""
    return (f"{prefix}_{chan_name}_chan_ibo{int(ibo_db)}_npoints{n_points}"
            f"_nsnap{n_snapshots}_angle{int(angle_deg)}_nant{n_ant}")


def sig_powers_filename(chan_name: str, ibo_db: float, n_points: int,
                        n_snapshots: int, precoding_angle_deg: float,
                        n_ant: int, prefix: str = "mrt") -> str:
    """File name of desired/distortion powers vs angle
    (``reference/main_beampatterns_plotting/main_mrt_precoding_radiation_pattern.py:265-266``)."""
    return (f"{prefix}_sig_powers_vs_angle_{chan_name}_chan_ibo{int(ibo_db)}"
            f"_npoints{n_points}_nsnap{n_snapshots}"
            f"_angle{int(precoding_angle_deg)}_nant{n_ant}")


def save_ber_sweep(param_values: np.ndarray, ber_matrix: np.ndarray,
                   filename: str,
                   results_dir: str | Path = DEFAULT_RESULTS_DIR) -> Path:
    """Row 0 = swept parameter; rows 1.. = BER per configuration
    (``reference/main_clipping_noise_cancellation/main_miso_cnc_ber_vs_ebn0.py:289-294``)."""
    data = [np.asarray(param_values)] + [np.asarray(r) for r in ber_matrix]
    return save_to_csv(data, filename, results_dir)


def load_ber_sweep(filename: str,
                   results_dir: str | Path = DEFAULT_RESULTS_DIR):
    """``(param_values, ber_matrix)`` of a CSV written by :func:`save_ber_sweep`."""
    rows = read_from_csv(filename, results_dir)
    return np.asarray(rows[0]), np.asarray(rows[1:])
