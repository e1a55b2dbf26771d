"""Memoryless power-amplifier models and the Bussgang gain
(port of ``mimo_ofdm_tpu/ops/pa.py``), on complex samples
(:func:`apply_pa`) or on real/imag planes (:func:`apply_pa_planar`).

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


def soft_limiter(x: torch.Tensor, sat_power) -> torch.Tensor:
    """Amplitude clip at ``sqrt(sat_power)`` preserving phase
    (``reference/distortion.py:9-19``)."""
    p = x.real ** 2 + x.imag ** 2
    scale = torch.sqrt(sat_power / torch.where(p > 0, p, torch.ones_like(p)))
    return torch.where(p <= sat_power, x, x * scale.to(x.dtype))


def rapp(x: torch.Tensor, sat_power, p_hardness: float) -> torch.Tensor:
    """Rapp soft-saturation model (``reference/distortion.py:102-113``)."""
    root = (torch.sqrt(sat_power) if isinstance(sat_power, torch.Tensor)
            else math.sqrt(sat_power))
    ratio = x.abs() / root
    denom = (1.0 + ratio ** (2.0 * p_hardness)) ** (1.0 / (2.0 * p_hardness))
    return x / denom.to(x.dtype)


def third_order(x: torch.Tensor, cubic_coeff) -> torch.Tensor:
    """Third-order memoryless polynomial ``x - c x |x|^2``
    (``reference/distortion.py:202-211``)."""
    mag2 = (x.real ** 2 + x.imag ** 2).to(x.dtype)
    return x - cubic_coeff * x * mag2


def apply_pa(x: torch.Tensor, model: str, sat_power=1.0,
             p_hardness: float = 1.1, cubic_coeff=0.0) -> torch.Tensor:
    """Complex PA by model name, ``softlim | rapp | toi | none``
    (``reference/distortion.py:39-40,134-135,230-231``). ``sat_power`` and
    ``cubic_coeff`` broadcast against ``x``."""
    if model == "softlim":
        return soft_limiter(x, sat_power)
    if model == "rapp":
        return rapp(x, sat_power, p_hardness)
    if model == "toi":
        return third_order(x, cubic_coeff)
    if model == "none":
        return x
    raise ValueError(f"unknown PA model {model!r}")


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
