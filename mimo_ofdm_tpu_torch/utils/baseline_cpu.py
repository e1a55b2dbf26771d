"""Reference-style CPU baseline for benchmarking (port of
``mimo_ofdm_tpu/utils/baseline_cpu.py``).

A re-creation of the reference's computation pattern: a Python loop over
antennas with one ``torch.fft`` round trip per call
(``reference/antenna_array.py:110-140``, ``reference/modulation.py:269-290``)
and an O(M) min-distance detector in the CNC loop
(``reference/modulation.py:76``, ``reference/corrector.py:52-112``), in
NumPy on the CPU. It times the baseline frames/s; written against the same
math as the port, not a copy of the reference code.
"""

from __future__ import annotations

import time

import numpy as np
import torch

from mimo_ofdm_tpu_torch.ops.pa import bussgang_alpha
from mimo_ofdm_tpu_torch.ops.qam import _constellation_np
from mimo_ofdm_tpu_torch.utils.config import LinkConfig


def _fft(x):
    return torch.fft.fft(torch.from_numpy(x), norm="ortho").numpy()


def _ifft(x):
    return torch.fft.ifft(torch.from_numpy(x), norm="ortho").numpy()


def _embed(sym, n_fft):
    out = np.zeros(n_fft, np.complex128)
    n_sc = sym.shape[-1]
    out[-(n_sc // 2):] = sym[: n_sc // 2]
    out[1: n_sc // 2 + 1] = sym[n_sc // 2:]
    return out


def _extract(fd, n_sc):
    return np.concatenate((fd[-(n_sc // 2):], fd[1: n_sc // 2 + 1]))


def _clip(x, sat_pow):
    p = np.abs(x) ** 2
    scale = np.sqrt(sat_pow / np.where(p > 0, p, 1.0))
    return np.where(p <= sat_pow, x, x * scale)


def run_baseline_frame(cfg: LinkConfig, n_iters: int, rng: np.random.Generator,
                       h_fd: np.ndarray, alpha: float) -> np.ndarray:
    """One distorted frame + CNC receive, reference-style (per-antenna
    Python loop, one FFT call per antenna). Draws from ``rng`` exactly as
    the JAX package's baseline does; returns the bit errors of each CNC
    pass, ``[n_iters + 1]`` int64."""
    m = cfg.modem.constel_size
    n_fft, n_sc = cfg.modem.n_fft, cfg.modem.n_sub_carr
    n_ant = cfg.array.n_elements
    constellation = _constellation_np(m)
    bps = int(np.log2(m))
    weights = 1 << np.arange(bps - 1, -1, -1)

    bits = rng.integers(0, 2, n_sc * bps)
    idx = bits.reshape(-1, bps) @ weights
    sym = constellation[idx]

    # MRT precoding from the channel (per-subcarrier)
    h_sc = np.stack([_extract(h_fd[a], n_sc) for a in range(n_ant)])
    v = np.conj(h_sc) / np.sqrt(np.sum(np.abs(h_sc) ** 2, axis=0))
    sat = 10 ** (cfg.pa.ibo_db / 10) * cfg.modem.avg_sample_power \
        * np.mean(np.abs(v) ** 2)

    # per-antenna TX loop (the reference's hot loop)
    out_fd = np.empty((n_ant, n_fft), np.complex128)
    for a in range(n_ant):
        fd = _embed(v[a] * sym, n_fft)
        td = _ifft(fd)
        out_fd[a] = _fft(_clip(td, sat))

    rx = np.sum(out_fd * h_fd, axis=0)
    rx = rx + (rng.standard_normal(n_fft) + 1j * rng.standard_normal(n_fft)) * 0.1

    agc = np.ones(n_fft, np.complex128)
    hv = np.sum(h_sc * v, axis=0)
    agc[-(n_sc // 2):] = hv[: n_sc // 2]
    agc[1: n_sc // 2 + 1] = hv[n_sc // 2:]
    rx = rx / agc

    # CNC loop with O(M) detection (reference/corrector.py:52-112)
    rx_sc = _extract(rx, n_sc)
    sat_cnc = 10 ** (cfg.pa.ibo_db / 10) * cfg.modem.avg_symbol_power * n_sc / n_fft
    d_est = np.zeros(n_sc, np.complex128)
    errors = np.zeros(n_iters + 1, np.int64)
    for i in range(n_iters + 1):
        corr = rx_sc - d_est
        det_idx = np.abs(corr - constellation[:, None]).argmin(0)
        det_bits = (det_idx[:, None] & weights) > 0
        errors[i] = np.count_nonzero(det_bits != bits.reshape(-1, bps))
        det = constellation[det_idx]
        rep = _extract(_fft(_clip(_ifft(_embed(det, n_fft)), sat_cnc)), n_sc)
        d_est = rep / alpha - det
    return errors


def measure_baseline_frames_per_s(cfg: LinkConfig, n_iters: int,
                                  min_seconds: float = 5.0) -> float:
    """Frames/s of :func:`run_baseline_frame` on this CPU."""
    rng = np.random.default_rng(0)
    n_ant, n_fft = cfg.array.n_elements, cfg.modem.n_fft
    h_fd = (rng.standard_normal((n_ant, n_fft))
            + 1j * rng.standard_normal((n_ant, n_fft))) / np.sqrt(2)
    alpha = float(bussgang_alpha(cfg.pa.ibo_db))
    # warmup
    run_baseline_frame(cfg, n_iters, rng, h_fd, alpha)
    n = 0
    t0 = time.perf_counter()
    while time.perf_counter() - t0 < min_seconds:
        run_baseline_frame(cfg, n_iters, rng, h_fd, alpha)
        n += 1
    return n / (time.perf_counter() - t0)
