"""Transmit-side symbol mapping and precoding
(port of ``mimo_ofdm_tpu/models/transmit.py:28-50``)."""

from __future__ import annotations

import torch

from mimo_ofdm_tpu_torch.ops import qam


def modulate_users(bits: torch.Tensor, constel_size: int,
                   dtype=torch.complex64) -> torch.Tensor:
    """bits ``[..., n_bits]`` -> symbols ``[..., n_sc]``
    (``reference/modulation.py:346-367``)."""
    return qam.modulate_bits(bits, constel_size, dtype)


def precode_symbols(symbols: torch.Tensor, v: torch.Tensor) -> torch.Tensor:
    """Single-user frequency-domain precoding: ``symbols [..., n_sc]`` times
    ``v [..., n_ant, n_sc]`` -> ``[..., n_ant, n_sc]``
    (``reference/modulation.py:373``). The multi-user form waits for the
    multi-user slice (ROADMAP queue 1, item 9)."""
    return symbols[..., None, :] * v
