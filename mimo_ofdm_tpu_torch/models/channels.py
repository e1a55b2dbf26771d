"""MISO frequency-domain channels (port of
``mimo_ofdm_tpu/models/channels.py:33-108``): the antenna combine, TX-RX
distances, free-space attenuation and the LOS, two-path and Rayleigh
channel matrices ``[..., n_ant, n_f]`` in complex64.

A leading batch of RX positions ``[..., 3]`` (or of fade normals) gives a
batch of channels; the fade is handed in as unit normals, as everywhere in
the port."""

from __future__ import annotations

import math

import torch

from mimo_ofdm_tpu_torch.models.geometry import C_LIGHT
from mimo_ofdm_tpu_torch.ops.noise import complex_normal


def propagate(channel_mat_fd: torch.Tensor, in_sig_mat: torch.Tensor,
              sum_signals: bool = True) -> torch.Tensor:
    """``H o X`` then (optionally) the sum over the antenna axis ``-2``
    (``reference/channel.py:74-89``)."""
    out = in_sig_mat * channel_mat_fd
    return out.sum(-2) if sum_signals else out


def _distances(tx_pos: torch.Tensor, rx_pos: torch.Tensor) -> torch.Tensor:
    """Euclidean TX-element -> RX distances ``[..., n_ant]``
    (``reference/channel.py:56-58``)."""
    return torch.sqrt(((tx_pos - rx_pos[..., None, :]) ** 2).sum(-1))


def _fs_attenuation(distances: torch.Tensor, freqs: torch.Tensor,
                    tx_gain_db: float = 0.0, rx_gain_db: float = 0.0
                    ) -> torch.Tensor:
    """Free-space amplitude attenuation ``sqrt(10^((gt+gr)/10)) * c/(4 pi d f)``
    (``reference/channel.py:65-67``)."""
    gain = math.sqrt(10.0 ** ((tx_gain_db + rx_gain_db) / 10.0))
    return gain * (C_LIGHT / (4.0 * math.pi * distances[..., :, None] * freqs))


def _path_phase(d: torch.Tensor, freqs: torch.Tensor) -> torch.Tensor:
    """``exp(2j pi d f / c)`` with the phase formed in the JAX package's
    float32 order, ``((2 pi d) f) / c``."""
    theta = (2.0 * math.pi) * d[..., :, None] * freqs / C_LIGHT
    return torch.polar(torch.ones_like(theta), theta)


def los_channel(tx_pos: torch.Tensor, rx_pos: torch.Tensor, freqs: torch.Tensor,
                skip_attenuation: bool = False, tx_gain_db: float = 0.0,
                rx_gain_db: float = 0.0) -> torch.Tensor:
    """LOS channel ``H[a,f] = e^{2j pi d_a f / c} * att``
    (``reference/channel.py:35-72``)."""
    d = _distances(tx_pos, rx_pos)
    phase = _path_phase(d, freqs)
    if skip_attenuation:
        return phase
    return phase * _fs_attenuation(d, freqs, tx_gain_db, rx_gain_db)


def _mirror_distances(tx_pos: torch.Tensor, rx_pos: torch.Tensor) -> torch.Tensor:
    """Ground-reflection path lengths ``[..., n_ant]``: the elevation from
    the mirror image, then ``tz / sin(elev) + rz / sin(elev)``
    (``reference/channel.py:141-149``)."""
    rx = rx_pos[..., None, :]
    tz = tx_pos[..., :, 2]
    rz = rx[..., 2]
    horiz = torch.sqrt((tx_pos[..., :, 0] - rx[..., 0]) ** 2
                       + (tx_pos[..., :, 1] - rx[..., 1]) ** 2)
    sin_elev = torch.sin(torch.arctan((tz + rz) / horiz))
    return tz / sin_elev + rz / sin_elev


def two_path_channel(tx_pos: torch.Tensor, rx_pos: torch.Tensor,
                     freqs: torch.Tensor, skip_attenuation: bool = False,
                     tx_gain_db: float = 0.0, rx_gain_db: float = 0.0
                     ) -> torch.Tensor:
    """LOS plus a ground reflection with coefficient -1 at the mirror-image
    distance (``reference/channel.py:116-167``)."""
    d_los = _distances(tx_pos, rx_pos)
    d_sec = _mirror_distances(tx_pos, rx_pos)
    los_mat = _path_phase(d_los, freqs)
    sec_mat = -_path_phase(d_sec, freqs)
    if not skip_attenuation:
        los_mat = los_mat * _fs_attenuation(d_los, freqs, tx_gain_db, rx_gain_db)
        sec_mat = sec_mat * _fs_attenuation(d_sec, freqs, tx_gain_db, rx_gain_db)
    return los_mat + sec_mat


def rayleigh_channel(normals: torch.Tensor, tx_pos: torch.Tensor,
                     rx_pos: torch.Tensor, freqs: torch.Tensor,
                     skip_attenuation: bool = False, tx_gain_db: float = 0.0,
                     rx_gain_db: float = 0.0) -> torch.Tensor:
    """IID CN(0,1) per antenna and bin from unit ``normals [..., 2, n_ant,
    n_f]``, scaled by the LOS free-space attenuation
    (``reference/channel.py:234-251``)."""
    coeffs = complex_normal(normals.movedim(-3, -2))   # re/im axis to -2
    if skip_attenuation:
        return coeffs
    return coeffs * _fs_attenuation(_distances(tx_pos, rx_pos), freqs,
                                    tx_gain_db, rx_gain_db)
