"""Receiver AGC / equalization vectors and noise scalers
(port of ``mimo_ofdm_tpu/models/agc.py``).

* ``hk_vk_agc_sc``    = ``sum_ant H o V``, the effective SISO channel of the
  clean signal;
* ``ak_hk_vk_agc_sc`` = the same with the per-antenna Bussgang gain ``a_k``,
  the effective channel of the distorted signal's linear part;
* ``*_noise_scaler``  = mean ``|.|^2`` over subcarriers, which sets the AWGN
  power so that the post-AGC SNR is the requested one
  (``reference/mp_model.py:163,212,290-329``).

The frames work on the data subcarriers (:func:`compute_agc_sc`); the
full-band form (:func:`compute_agc`) embeds the same vectors into the
``n_fft`` grid with ones in the unused bins (``reference/mp_model.py:307-309,
324-326``), so out-of-band samples pass the divide unscaled.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from mimo_ofdm_tpu_torch.models.precoding import (per_antenna_alpha,
                                                  precoding_power_per_antenna)
from mimo_ofdm_tpu_torch.ops.ofdm import map_subcarriers
from mimo_ofdm_tpu_torch.parallel.collectives import ant_sum


class AgcState(NamedTuple):
    """Full-band AGC state of a batch of frames."""
    hk_vk_agc_nfft: torch.Tensor        # [..., n_fft] clean-signal equalizer
    hk_vk_noise_scaler: torch.Tensor    # [...]
    ak_hk_vk_agc_nfft: torch.Tensor     # [..., n_fft] distorted-signal equalizer
    ak_hk_vk_noise_scaler: torch.Tensor  # [...]
    ak_vect: torch.Tensor               # [..., n_ant] per-antenna Bussgang gains


class AgcStateSc(NamedTuple):
    """Subcarrier-domain AGC state of a batch of frames."""
    hk_vk_agc_sc: torch.Tensor          # [..., n_sc] clean-signal equalizer
    hk_vk_noise_scaler: torch.Tensor    # [...]
    ak_hk_vk_agc_sc: torch.Tensor       # [..., n_sc] distorted-signal equalizer
    ak_hk_vk_noise_scaler: torch.Tensor  # [...]
    ak_vect: torch.Tensor               # [..., n_ant] per-antenna Bussgang gains


def compute_agc_sc(h_sc: torch.Tensor, v: torch.Tensor, ibo_db: float,
                   n_ant: int, usr_idx: int | slice | None = None,
                   alpha_override: float | None = None, ant_group=None) -> AgcStateSc:
    """AGC state from the channel ``h_sc`` and precoder ``v``, both
    ``[..., n_ant, n_sc]`` (``reference/mp_model.py:290-329``).
    ``alpha_override`` replaces the per-antenna Bussgang closed form with a
    constant, for PA models without one (``reference/corrector.py:146-147``).

    With ``usr_idx``, ``v`` is the multi-user precoder ``[..., n_ant,
    n_usr, n_sc]`` and ``h_sc`` the served user's channel: ``H o V`` takes
    that user's slice while the per-antenna power, hence the IBO and
    ``a_k``, sums over all users (``reference/corrector.py:379-384``). The
    user axis is indexed in front, ``v.movedim(-2, 0)[usr_idx]``, so
    ``usr_idx=slice(None)`` with users-first channels ``[n_usr, ...,
    n_ant, n_sc]`` gives every user's state at once, with the user axis
    leading.

    With ``ant_group`` the channel and precoder hold this rank's antennas,
    ``n_ant`` stays the global count (it sets each antenna's IBO), and the
    two sums over antennas all-reduce over the group
    (``mimo_ofdm_tpu/models/agc.py:129-132``)."""
    n_sc = h_sc.shape[-1]
    if usr_idx is None:
        vk_pow_vec = precoding_power_per_antenna(v)
        v_usr = v
    else:
        vk_pow_vec = precoding_power_per_antenna(v, multi_user=True)
        v_usr = v.movedim(-2, 0)[usr_idx]
    hk_vk = h_sc * v_usr
    hk_vk_avg = ant_sum(hk_vk, -2, ant_group)
    if alpha_override is None:
        ak_vect = per_antenna_alpha(ibo_db, vk_pow_vec, n_sc, n_ant)
    else:
        ak_vect = torch.full_like(vk_pow_vec, alpha_override)
    ak_hk_vk_avg = ant_sum(ak_vect[..., None].to(hk_vk.dtype) * hk_vk, -2, ant_group)
    return AgcStateSc(
        hk_vk_agc_sc=hk_vk_avg,
        hk_vk_noise_scaler=(hk_vk_avg.abs() ** 2).mean(-1),
        ak_hk_vk_agc_sc=ak_hk_vk_avg,
        ak_hk_vk_noise_scaler=(ak_hk_vk_avg.abs() ** 2).mean(-1),
        ak_vect=ak_vect,
    )


def compute_agc(h_sc: torch.Tensor, v: torch.Tensor, ibo_db: float, n_ant: int,
                n_fft: int, usr_idx: int | None = None, ant_group=None) -> AgcState:
    """:func:`compute_agc_sc` with the two equalizers embedded into the
    ``[..., n_fft]`` grid, ones in DC and the guard band
    (``mimo_ofdm_tpu/models/agc.py:58-107``). Arguments as
    :func:`compute_agc_sc`; ``usr_idx`` picks the served user of a
    multi-user precoder."""
    sc = compute_agc_sc(h_sc, v, ibo_db, n_ant, usr_idx=usr_idx, ant_group=ant_group)
    return AgcState(
        hk_vk_agc_nfft=map_subcarriers(sc.hk_vk_agc_sc, n_fft, fill_value=1.0),
        hk_vk_noise_scaler=sc.hk_vk_noise_scaler,
        ak_hk_vk_agc_nfft=map_subcarriers(sc.ak_hk_vk_agc_sc, n_fft, fill_value=1.0),
        ak_hk_vk_noise_scaler=sc.ak_hk_vk_noise_scaler,
        ak_vect=sc.ak_vect,
    )
