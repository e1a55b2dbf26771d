"""Closed-form arithmetic-complexity model of the std/CNC/MCNC receivers
(the port's own copy of ``mimo_ofdm_tpu/models/complexity.py``;
``reference/main_misc_evals/comp_complexity_eval.py:9-60``). All counts are
totals per OFDM frame, float64 NumPy on the host; divide by ``n_u`` for the
per-data-subcarrier numbers the reference tabulates."""

from __future__ import annotations

import numpy as np


def std_rx_ops(m: int = 64, n_u: int = 2048, n: int = 4096):
    """Standard receiver adds/muls (``comp_complexity_eval.py:19-21``)."""
    add = 5 * n_u + 5 * ((n / 2) * np.log2(n)) + 2 * n * np.log2(n) \
        + n_u * (3 * 2 * np.sqrt(m))
    mul = 3 * n_u + 3 * ((n / 2) * np.log2(n)) + n_u * (2 * 2 * np.sqrt(m))
    return add, mul


def cnc_ops(iters, m: int = 64, n_u: int = 2048, n: int = 4096):
    """CNC adds/muls per iteration count (``comp_complexity_eval.py:23-26``)."""
    i = np.asarray(iters, np.float64)
    std_add, std_mul = std_rx_ops(m, n_u, n)
    add = std_add + i * (2 * (5 * ((n / 2) * np.log2(n)) + 2 * n * np.log2(n))
                         + 70 * n + 2 * n_u + n_u * (3 * 2 * np.sqrt(m)))
    mul = std_mul + i * (2 * (3 * ((n / 2) * np.log2(n))) + 5 * n + 2 * n_u
                         + n_u * (2 * 2 * np.sqrt(m)))
    return add, mul


def mcnc_ops(iters, m: int = 64, n_u: int = 2048, n: int = 4096, k: int = 64):
    """MCNC adds/muls: ~(K+1)x the FFT cost and Kx the clip cost per
    iteration (``comp_complexity_eval.py:30-35``)."""
    i = np.asarray(iters, np.float64)
    std_add, std_mul = std_rx_ops(m, n_u, n)
    add = std_add + i * ((k + 1) * (5 * ((n / 2) * np.log2(n)) + 2 * n * np.log2(n))
                         + k * (70 * n) + (2 * k + 1) * (5 * n_u)
                         + (k - 1) * n_u + 2 * n_u + n_u * (3 * 2 * np.sqrt(m)))
    mul = std_mul + i * ((k + 1) * (3 * ((n / 2) * np.log2(n))) + k * (5 * n)
                         + (2 * k + 1) * 3 * n_u + n_u * (2 * 2 * np.sqrt(m)))
    return add, mul
