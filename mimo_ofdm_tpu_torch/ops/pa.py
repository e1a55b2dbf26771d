"""Memoryless power-amplifier models and the Bussgang gain
(port of ``mimo_ofdm_tpu/ops/pa.py``).

The PA state (IBO, average sample power) is explicit: a per-row saturation
power broadcasts against the sample axis
(``reference/antenna_array.py:313-360``).
"""

from __future__ import annotations

import math

import torch

PA_MODELS = ("softlim", "rapp", "toi", "none")


def ibo_to_sat_power(ibo_db, avg_sample_power):
    """Saturation power from input back-off:
    ``10^(ibo/10) * avg_sample_power`` (``reference/distortion.py:37``)."""
    return 10.0 ** (ibo_db / 10.0) * avg_sample_power


def toi_to_cubic_coeff(toi_db, avg_sample_power):
    """Cubic coefficient from the third-order intercept:
    ``1 / 10^(toi/10) / avg_sample_power`` (``reference/distortion.py:228``)."""
    return 1.0 / (10.0 ** (toi_db / 10.0)) / avg_sample_power


def bussgang_alpha(ibo_db) -> torch.Tensor:
    """Ochiai closed-form Bussgang gain of an ideal clipper, in float32:
    ``alpha = 1 - exp(-g^2) + (sqrt(pi) g / 2) erfc(g)``, ``g = 10^(ibo/20)``
    (``reference/modulation.py:178-189``)."""
    ibo = torch.as_tensor(ibo_db, dtype=torch.float32)
    gamma = 10.0 ** (ibo / 20.0)
    return (1.0 - torch.exp(-gamma ** 2)
            + (math.sqrt(math.pi) * gamma / 2.0) * torch.special.erfc(gamma))


def apply_pa_planar(xr: torch.Tensor, xi: torch.Tensor, model: str,
                    sat_power=1.0, p_hardness: float = 1.1,
                    cubic_coeff=0.0) -> tuple[torch.Tensor, torch.Tensor]:
    """PA on split real/imag planes: the common scale factor applied to
    both planes, computed in float32 whatever the planes' dtype."""
    pr = xr.to(torch.float32)
    pi = xi.to(torch.float32)
    pwr = pr * pr + pi * pi
    if model == "softlim":
        one = torch.ones_like(pwr)
        scale = torch.where(pwr <= sat_power, one,
                            torch.sqrt(sat_power / torch.where(pwr > 0, pwr, one)))
    elif model == "rapp":
        ratio2 = pwr / sat_power
        scale = (1.0 + ratio2 ** p_hardness) ** (-1.0 / (2.0 * p_hardness))
    elif model == "toi":
        scale = 1.0 - cubic_coeff * pwr
    elif model == "none":
        return xr, xi
    else:
        raise ValueError(f"unknown PA model {model!r}")
    return (pr * scale).to(xr.dtype), (pi * scale).to(xi.dtype)
