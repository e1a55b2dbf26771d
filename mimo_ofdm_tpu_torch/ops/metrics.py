"""Power, SNR and BER metric helpers (port of
``mimo_ofdm_tpu/ops/metrics.py``, ``reference/utilities.py:71-143``).

The SNR conversions and the closed-form BER are host-side float64 NumPy,
as in the JAX package; the signal metrics take tensors."""

from __future__ import annotations

import numpy as np
import torch


def td_signal_power(signal: torch.Tensor, axis=-1) -> torch.Tensor:
    """Mean |x|^2 (``reference/utilities.py:71-79``)."""
    return (signal.abs() ** 2).mean(axis)


def fd_signal_power(signal: torch.Tensor, axis=-1) -> torch.Tensor:
    """Sum |X|^2 (``reference/utilities.py:83-91``)."""
    return (signal.abs() ** 2).sum(axis)


def ebn0_to_snr(eb_per_n0_db, n_fft: int, n_sub_carr: int, constel_size: int):
    """Eb/N0 [dB] -> SNR [dB] (``reference/utilities.py:108-118``)."""
    return 10.0 * np.log10(
        10.0 ** (np.asarray(eb_per_n0_db, np.float64) / 10.0)
        * n_sub_carr * np.log2(constel_size) / n_fft)


def snr_to_ebn0(snr_db, n_fft: int, n_sub_carr: int, constel_size: int):
    """SNR [dB] -> Eb/N0 [dB] (``reference/utilities.py:121-133``)."""
    return 10.0 * np.log10(
        10.0 ** (np.asarray(snr_db, np.float64) / 10.0)
        * n_fft / (n_sub_carr * np.log2(constel_size)))


def to_db(x):
    """Linear power ratio -> dB (``reference/utilities.py:136-142``)."""
    return 10.0 * (torch.log10(x) if isinstance(x, torch.Tensor) else np.log10(x))


def evm_rms(rx_symbols: torch.Tensor, ref_symbols: torch.Tensor,
            axis=-1) -> torch.Tensor:
    """Root-mean-square error vector magnitude (linear ratio):
    ``sqrt( E|rx - ref|^2 / E|ref|^2 )``."""
    err = ((rx_symbols - ref_symbols).abs() ** 2).mean(axis)
    ref = (ref_symbols.abs() ** 2).mean(axis)
    return torch.sqrt(err / ref)


def qam_awgn_ber_theory(constel_size: int, ebn0_db) -> np.ndarray:
    """Closed-form uncoded square-QAM BER over AWGN with Gray mapping:
    ``4/k (1 - 1/sqrt(M)) Q(sqrt(3 k Eb/N0 / (M-1)))``."""
    from scipy.special import erfc
    m = constel_size
    k = np.log2(m)
    ebn0 = 10.0 ** (np.asarray(ebn0_db, np.float64) / 10.0)
    arg = np.sqrt(3.0 * k * ebn0 / (m - 1.0))
    q = 0.5 * erfc(arg / np.sqrt(2.0))
    return (4.0 / k) * (1.0 - 1.0 / np.sqrt(m)) * q
