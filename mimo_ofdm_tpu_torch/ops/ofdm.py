"""OFDM subcarrier mapping and bin frequencies
(port of ``mimo_ofdm_tpu/ops/ofdm.py``).

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


def fft_bin_frequencies(n_fft: int, carrier_spacing: float,
                        center_freq: float) -> np.ndarray:
    """Absolute RF frequency of each FFT bin in FFT order, float64
    (``reference/channel.py:51-52``)."""
    k = np.fft.fftfreq(n_fft, d=1.0 / n_fft)
    return k * carrier_spacing + center_freq
