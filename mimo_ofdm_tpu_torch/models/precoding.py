"""Constant-IBO bookkeeping under precoding
(port of ``mimo_ofdm_tpu/models/precoding.py:172-185``)."""

from __future__ import annotations

import torch

from mimo_ofdm_tpu_torch.ops.pa import bussgang_alpha


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
