"""Channel helpers (port of ``mimo_ofdm_tpu/models/channels.py:33-60``):
the antenna combine, TX-RX distances and free-space attenuation."""

from __future__ import annotations

import math

import torch

from mimo_ofdm_tpu_torch.models.geometry import C_LIGHT


def propagate(channel_mat_fd: torch.Tensor, in_sig_mat: torch.Tensor,
              sum_signals: bool = True) -> torch.Tensor:
    """``H o X`` then (optionally) the sum over the antenna axis ``-2``
    (``reference/channel.py:74-89``)."""
    out = in_sig_mat * channel_mat_fd
    return out.sum(-2) if sum_signals else out


def _distances(tx_pos: torch.Tensor, rx_pos: torch.Tensor) -> torch.Tensor:
    """Euclidean TX-element -> RX distances ``[n_ant]``
    (``reference/channel.py:56-58``)."""
    return torch.sqrt(((tx_pos - rx_pos[..., None, :]) ** 2).sum(-1))


def _fs_attenuation(distances: torch.Tensor, freqs: torch.Tensor,
                    tx_gain_db: float = 0.0, rx_gain_db: float = 0.0
                    ) -> torch.Tensor:
    """Free-space amplitude attenuation ``sqrt(10^((gt+gr)/10)) * c/(4 pi d f)``
    (``reference/channel.py:65-67``)."""
    gain = math.sqrt(10.0 ** ((tx_gain_db + rx_gain_db) / 10.0))
    return gain * (C_LIGHT / (4.0 * math.pi * distances[..., :, None] * freqs))
