"""MRT / phase-only / ZF precoders and constant-IBO bookkeeping under
precoding (port of ``mimo_ofdm_tpu/models/precoding.py``).

Shapes, with any leading batch dims:

* single user: channel ``h_sc [..., n_ant, n_sc]``, precoder ``V`` of the
  same shape;
* multi-user: channels ``[..., n_usr, n_ant, n_sc]``, precoder ``V [...,
  n_ant, n_usr, n_sc]`` (the per-transceiver slice layout of
  ``reference/corrector.py:384``). The bookkeeping functions take
  ``multi_user=True`` for it.

Antenna sharding (JAX's ``ant_axis_name``): with ``ant_group``, a
``torch.distributed`` process group over which the antennas are split,
the channels and precoders hold this rank's antennas only, and every sum
over antennas is the local sum plus an all-reduce over the group
(:mod:`mimo_ofdm_tpu_torch.parallel.collectives`). ``None`` (the
default) is the unsharded code.
"""

from __future__ import annotations

import numpy as np
import torch

from mimo_ofdm_tpu_torch.ops.pa import bussgang_alpha
from mimo_ofdm_tpu_torch.parallel.collectives import all_reduce_sum, ant_sum


def mrt_precoder(h_sc: torch.Tensor, ant_group=None) -> torch.Tensor:
    """Maximum-ratio transmission with equal-total-TX-power normalization:
    ``V = conj(H) / sqrt(sum_ant |H|^2)`` per subcarrier
    (``reference/antenna_array.py:167-171``)."""
    norm = torch.sqrt(ant_sum(h_sc.abs() ** 2, -2, ant_group))[..., None, :]
    return torch.conj(h_sc) / norm.to(h_sc.dtype)


def phase_precoder(h_sc: torch.Tensor) -> torch.Tensor:
    """Phase-only conjugate precoding ``V = e^{j angle(conj H)}``
    (``reference/antenna_array.py:176-178``)."""
    ang = torch.angle(torch.conj(h_sc))
    return torch.polar(torch.ones_like(ang), ang)


def mu_mrt_precoder(h_sc_mu: torch.Tensor, ant_group=None) -> torch.Tensor:
    """Multi-user MRT, normalized jointly over users: the per-subcarrier
    norm is ``sqrt(sum_usr sum_ant |H_u|^2)`` (``reference/antenna_array.py:201-220``).
    ``[..., n_usr, n_ant, n_sc]`` -> ``V [..., n_ant, n_usr, n_sc]``."""
    norm = torch.sqrt(ant_sum(h_sc_mu.abs() ** 2, (-3, -2), ant_group))[..., None, None, :]
    return (torch.conj(h_sc_mu) / norm.to(h_sc_mu.dtype)).transpose(-3, -2)


def mu_phase_precoder(h_sc_mu: torch.Tensor) -> torch.Tensor:
    """Multi-user phase-only precoding (``reference/antenna_array.py:259-267``)."""
    return phase_precoder(h_sc_mu).transpose(-3, -2)


def _pinv_rtol(n: int) -> float:
    """``jnp.linalg.pinv``'s default cutoff relative to the largest singular
    value of an ``n x n`` float32 matrix."""
    return 10.0 * n * float(np.finfo(np.float32).eps)


def _pinv_2x2_hermitian(gram: torch.Tensor) -> torch.Tensor:
    """Pseudo-inverse of Hermitian positive semi-definite ``[..., 2, 2]``
    matrices in closed form, with ``jnp.linalg.pinv``'s cutoff: an
    eigenvalue at most ``rtol`` times the larger one counts as zero. Full
    rank: ``adj / det``; rank one: ``P / lam_hi`` with the projector ``P =
    (G - lam_lo I) / (lam_hi - lam_lo)``; zero: zero. Unlike
    ``torch.linalg.pinv`` (an SVD that checks its status on the host), it
    never waits for the device."""
    a, b = gram[..., 0, 0], gram[..., 0, 1]
    c, d = gram[..., 1, 0], gram[..., 1, 1]
    half_tr = (a.real + d.real) / 2
    r = torch.sqrt(((a.real - d.real) / 2) ** 2 + b.abs() ** 2)
    lam_hi, lam_lo = half_tr + r, half_tr - r
    full = torch.stack([torch.stack([d, -b], -1), torch.stack([-c, a], -1)], -2)
    full = full / (a * d - b * c)[..., None, None]
    eye = torch.eye(2, dtype=gram.dtype, device=gram.device)
    rank1 = (gram - lam_lo[..., None, None] * eye) / (2 * r * lam_hi)[..., None, None]
    cut = _pinv_rtol(2) * lam_hi
    out = torch.where((lam_lo.abs() > cut)[..., None, None], full, rank1)
    return torch.where((lam_hi > 0)[..., None, None], out, torch.zeros_like(out))


def zf_precoder(h_sc_mu: torch.Tensor, ant_group=None,
                n_ant_global: int | None = None) -> torch.Tensor:
    """Zero-forcing precoding batched over frames and subcarriers
    (``reference/antenna_array.py:222-257``): per subcarrier, with the
    user-channel matrix ``Hm [n_usr, n_ant]``, ``V = sqrt(K - U) Hm^H (Hm
    Hm^H)^{-1}``, then unit total power per subcarrier.
    ``[..., n_usr, n_ant, n_sc]`` -> ``V [..., n_ant, n_usr, n_sc]``.

    The JAX package inverts the Gram matrix with ``pinv``. For two users
    the port takes the pseudo-inverse in closed form with pinv's cutoff,
    which never waits for the device (a batched ``pinv`` on CUDA is an SVD
    that checks its status on the host); for more users it calls
    ``torch.linalg.pinv`` with JAX's default cutoff, which does.

    Under antenna sharding the Gram matrix is the all-reduce of the local
    ``Hm Hm^H`` (every rank then inverts the same small matrices, by the
    same closed form for two users, and keeps its own rows of ``V``), the
    unit-power norm all-reduces the local power, and ``K`` is the global
    antenna count ``n_ant_global``."""
    n_usr, n_ant = h_sc_mu.shape[-3], h_sc_mu.shape[-2]
    if ant_group is not None:
        n_ant = n_ant_global
    hm = h_sc_mu.movedim(-1, -3)                            # [..., n_sc, n_usr, n_ant]
    hm_h = torch.conj(hm.transpose(-2, -1))                 # [..., n_sc, n_ant, n_usr]
    gram = all_reduce_sum(hm @ hm_h, ant_group)             # [..., n_sc, n_usr, n_usr]
    if n_usr == 2:
        inv = _pinv_2x2_hermitian(gram)
    else:
        inv = torch.linalg.pinv(gram, rtol=_pinv_rtol(n_usr))
    v = float(np.sqrt(np.float32(n_ant - n_usr))) * (hm_h @ inv)
    pw2 = all_reduce_sum((v.abs() ** 2).sum((-2, -1), keepdim=True), ant_group)
    v = v / torch.sqrt(pw2).to(v.dtype)                     # [..., n_sc, n_ant, n_usr]
    return v.movedim(-3, -1)


def sep_carrier_channel(h_sc_mu: torch.Tensor) -> torch.Tensor:
    """The composed channel of separate subcarriers per user: user ``u``
    owns the ``u``-th of ``n_usr`` contiguous blocks of subcarriers,
    ``[..., n_usr, n_ant, n_sc] -> [..., n_ant, n_sc]``
    (``reference/antenna_array.py:275-305``)."""
    n_usr, n_sc = h_sc_mu.shape[-3], h_sc_mu.shape[-1]
    if n_sc % n_usr:
        raise ValueError("n_sub_carr must divide by n_users for sep carriers")
    blk = n_sc // n_usr
    return torch.cat([h_sc_mu[..., u, :, u * blk:(u + 1) * blk] for u in range(n_usr)],
                     dim=-1)


def mu_sep_carrier_precoder(h_sc_mu: torch.Tensor, mr_precoding: bool = True,
                            ant_group=None) -> torch.Tensor:
    """Separate-subcarriers-per-user precoding
    (``reference/antenna_array.py:275-305``): single-user MRT (or phase) of
    the composed channel, a single-user-shaped ``V [..., n_ant, n_sc]``."""
    composed = sep_carrier_channel(h_sc_mu)
    return mrt_precoder(composed, ant_group) if mr_precoding else phase_precoder(composed)


def make_precoder(kind: str, n_users: int = 1, ant_group=None,
                  n_ant_global: int | None = None):
    """Precoder by name (``mimo_ofdm_tpu/models/precoding.py:124-145``):
    ``none``, ``mrt`` or ``phase`` for one user; ``mrt``, ``phase`` or
    ``zf`` for several, taking ``[..., n_usr, n_ant, n_sc]``. With
    ``ant_group`` the MRT norms and the ZF Gram and power all-reduce over
    it (``n_ant_global``: ZF's ``K``); the phase precoders are per antenna
    and need no collective."""
    if kind == "none":
        return torch.ones_like
    if n_users == 1:
        if kind == "mrt":
            return lambda h: mrt_precoder(h, ant_group)
        if kind == "phase":
            return phase_precoder
        raise ValueError(f"unknown single-user precoder {kind!r}")
    if kind == "mrt":
        return lambda h: mu_mrt_precoder(h, ant_group)
    if kind == "phase":
        return mu_phase_precoder
    if kind == "zf":
        return lambda h: zf_precoder(h, ant_group, n_ant_global)
    raise ValueError(f"unknown multi-user precoder {kind!r}")


def precoding_power_per_antenna(v: torch.Tensor, multi_user: bool = False
                                ) -> torch.Tensor:
    """``vk_pow_vec[..., a] = sum_sc (sum_usr) |V|^2``
    (``reference/corrector.py:143,383``, ``reference/mp_model.py:302``)."""
    return (v.abs() ** 2).sum((-2, -1) if multi_user else -1)


def avg_precoding_gain(v: torch.Tensor, multi_user: bool = False, ant_group=None,
                       n_ant_global: int | None = None) -> torch.Tensor:
    """Mean precoding power gain over antennas x subcarriers, ``[...]``;
    for several users the per-(antenna, bin) power summed over users
    (``reference/antenna_array.py:328-341``). Under antenna sharding: the
    all-reduced power over the global ``n_ant_global x n_sc`` cells."""
    pw = v.abs() ** 2
    if multi_user:
        pw = pw.sum(-2)
    if ant_group is None:
        return pw.mean((-2, -1))
    return all_reduce_sum(pw.sum((-2, -1)), ant_group) / (n_ant_global * pw.shape[-1])


def per_antenna_ibo_db(ibo_db, vk_pow_vec: torch.Tensor, n_sub_carr: int,
                       n_ant: int) -> torch.Tensor:
    """Effective per-antenna IBO after precoding redistributes power:
    ``10 log10( 10^(ibo/10) n_sc / (vk_pow_vec * n_ant) )``
    (``reference/mp_model.py:315-316``, ``reference/corrector.py:149-152``)."""
    return 10.0 * torch.log10(10.0 ** (ibo_db / 10.0) * n_sub_carr
                              / (vk_pow_vec * n_ant))


def per_antenna_alpha(ibo_db, vk_pow_vec: torch.Tensor, n_sub_carr: int,
                      n_ant: int) -> torch.Tensor:
    """``ak_vect``: per-antenna Bussgang gain at the effective IBO
    (``reference/mp_model.py:315-317``)."""
    return bussgang_alpha(per_antenna_ibo_db(ibo_db, vk_pow_vec, n_sub_carr, n_ant))


def pa_sat_power(ibo_db: float, avg_sample_power: float, v: torch.Tensor,
                 multi_user: bool = False, ant_group=None,
                 n_ant_global: int | None = None) -> torch.Tensor:
    """Per-frame PA saturation power under constant IBO: every PA's expected
    average power is rescaled by the mean precoding gain
    (``reference/antenna_array.py:313-360``):
    ``sat = 10^(ibo/10) * avg_sample_power * avg_precoding_gain``."""
    return (10.0 ** (ibo_db / 10.0) * avg_sample_power
            * avg_precoding_gain(v, multi_user, ant_group, n_ant_global))
