"""OFDM framing: subcarrier mapping, ortho (I)FFT, cyclic prefix and bin
frequencies (port of ``mimo_ofdm_tpu/ops/ofdm.py``).

Layout (``reference/modulation.py:264-267``): bin 0 (DC) is unused, the
first ``n_sc/2`` data symbols sit on the negative bins
``[n_fft - n_sc/2 .. n_fft-1]`` and the rest on bins ``[1 .. n_sc/2]``.
Extraction reads ``fd[-n_sc/2:]`` then ``fd[1:n_sc/2+1]``, so bin
``n_sc/2`` (the "straggler") comes last (``reference/modulation.py:288-293``).
"""

from __future__ import annotations

import numpy as np
import torch


def map_subcarriers(symbols: torch.Tensor, n_fft: int,
                    fill_value=0.0) -> torch.Tensor:
    """Embed ``[..., n_sc]`` data symbols into an ``[..., n_fft]`` frame;
    ``fill_value`` fills DC and the guard bins."""
    *lead, n_sc = symbols.shape
    h = n_sc // 2
    out = torch.full((*lead, n_fft), fill_value, dtype=symbols.dtype,
                     device=symbols.device)
    out[..., 1:h + 1] = symbols[..., h:]
    out[..., n_fft - h:] = symbols[..., :h]
    return out


def extract_subcarriers(fd_frame: torch.Tensor, n_sc: int) -> torch.Tensor:
    """The ``n_sc`` data bins of ``[..., n_fft]`` in ``[neg | pos]`` order."""
    h = n_sc // 2
    return torch.cat([fd_frame[..., -h:], fd_frame[..., 1:h + 1]], dim=-1)


def fd_to_td(fd_frame: torch.Tensor) -> torch.Tensor:
    """Ortho IFFT over the last axis (``reference/utilities.py:332-339``)."""
    return torch.fft.ifft(fd_frame, dim=-1, norm="ortho")


def td_to_fd(td_frame: torch.Tensor) -> torch.Tensor:
    """Ortho FFT over the last axis (``reference/utilities.py:311-329``)."""
    return torch.fft.fft(td_frame, dim=-1, norm="ortho")


def add_cyclic_prefix(td_frame: torch.Tensor, cp_len: int) -> torch.Tensor:
    """Prepend the last ``cp_len`` samples (``reference/modulation.py:273``)."""
    if cp_len == 0:
        return td_frame
    return torch.cat([td_frame[..., -cp_len:], td_frame], dim=-1)


def remove_cyclic_prefix(td_frame: torch.Tensor, cp_len: int) -> torch.Tensor:
    """Drop the first ``cp_len`` samples (``reference/modulation.py:290``)."""
    return td_frame[..., cp_len:]


def ofdm_modulate(symbols: torch.Tensor, n_fft: int, cp_len: int = 0) -> torch.Tensor:
    """Data symbols ``[..., n_sc]`` -> time-domain OFDM frame ``[..., cp_len +
    n_fft]`` (``reference/modulation.py:248-273``)."""
    return add_cyclic_prefix(fd_to_td(map_subcarriers(symbols, n_fft)), cp_len)


def ofdm_demodulate(td_frame: torch.Tensor, n_sc: int, cp_len: int = 0) -> torch.Tensor:
    """Time-domain OFDM frame ``[..., cp_len + n_fft]`` -> data symbols
    ``[..., n_sc]`` (``reference/modulation.py:277-293``)."""
    return extract_subcarriers(td_to_fd(remove_cyclic_prefix(td_frame, cp_len)), n_sc)


def ofdm_avg_sample_power(avg_symbol_power: float, n_fft: int, n_sc: int) -> float:
    """Average time-domain sample power of the OFDM signal,
    ``avg_symbol_power * n_sc / n_fft`` (``reference/modulation.py:418-424``)."""
    return avg_symbol_power * (n_sc / n_fft)


def fft_bin_frequencies(n_fft: int, carrier_spacing: float,
                        center_freq: float) -> np.ndarray:
    """Absolute RF frequency of each FFT bin in FFT order, float64
    (``reference/channel.py:51-52``)."""
    k = np.fft.fftfreq(n_fft, d=1.0 / n_fft)
    return k * carrier_spacing + center_freq
