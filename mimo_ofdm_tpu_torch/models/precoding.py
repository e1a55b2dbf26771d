"""Single-user precoders and constant-IBO bookkeeping under precoding
(port of ``mimo_ofdm_tpu/models/precoding.py:40-55,124-196``).

Shapes: the channel on the data subcarriers ``h_sc [..., n_ant, n_sc]``
and the precoder ``V`` of the same shape; the per-frame quantities carry
the leading batch dims.
"""

from __future__ import annotations

import torch

from mimo_ofdm_tpu_torch.ops.pa import bussgang_alpha


def mrt_precoder(h_sc: torch.Tensor) -> torch.Tensor:
    """Maximum-ratio transmission with equal-total-TX-power normalization:
    ``V = conj(H) / sqrt(sum_ant |H|^2)`` per subcarrier
    (``reference/antenna_array.py:167-171``)."""
    norm = torch.sqrt((h_sc.abs() ** 2).sum(-2))[..., None, :]
    return torch.conj(h_sc) / norm.to(h_sc.dtype)


def phase_precoder(h_sc: torch.Tensor) -> torch.Tensor:
    """Phase-only conjugate precoding ``V = e^{j angle(conj H)}``
    (``reference/antenna_array.py:176-178``)."""
    ang = torch.angle(torch.conj(h_sc))
    return torch.polar(torch.ones_like(ang), ang)


def make_precoder(kind: str, n_users: int = 1):
    """Single-user precoder by name: ``none``, ``mrt`` or ``phase``. The
    multi-user precoders (including ``zf``) wait for the multi-user slice."""
    if n_users != 1 or kind == "zf":
        raise NotImplementedError(
            f"the multi-user precoders ({kind!r} for {n_users} users) are not "
            "ported yet (ROADMAP queue 1: multi-user)")
    if kind == "none":
        return torch.ones_like
    if kind == "mrt":
        return mrt_precoder
    if kind == "phase":
        return phase_precoder
    raise ValueError(f"unknown single-user precoder {kind!r}")


def precoding_power_per_antenna(v: torch.Tensor) -> torch.Tensor:
    """``vk_pow_vec[..., a] = sum_sc |V|^2`` (``reference/corrector.py:143``,
    ``reference/mp_model.py:302``)."""
    return (v.abs() ** 2).sum(-1)


def avg_precoding_gain(v: torch.Tensor) -> torch.Tensor:
    """Mean precoding power gain over antennas x subcarriers, ``[...]``
    (``reference/antenna_array.py:328-341``)."""
    return (v.abs() ** 2).mean((-2, -1))


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


def pa_sat_power(ibo_db: float, avg_sample_power: float,
                 v: torch.Tensor) -> torch.Tensor:
    """Per-frame PA saturation power under constant IBO: every PA's expected
    average power is rescaled by the mean precoding gain
    (``reference/antenna_array.py:313-360``):
    ``sat = 10^(ibo/10) * avg_sample_power * avg_precoding_gain``."""
    return 10.0 ** (ibo_db / 10.0) * avg_sample_power * avg_precoding_gain(v)
