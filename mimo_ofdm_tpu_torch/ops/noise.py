"""Complex AWGN (port of ``mimo_ofdm_tpu/ops/noise.py``).

The noise convention is the reference's ``Awgn.process``
(``reference/noise.py:45-66``): per-complex-sample noise power
``avg_sample_pow / 10^(snr_db/10)``, or a fixed power in dBm
(:func:`awgn_fixed_power`). The caller supplies the unit normals,
so tests can hand the port the JAX package's own draws.
"""

from __future__ import annotations

import math

import torch


def complex_normal(normals: torch.Tensor) -> torch.Tensor:
    """Circular complex Gaussian with unit variance (0.5 per real dim),
    complex64 ``[..., n]``, from unit normals ``[..., 2, n]`` that hold the
    real and imaginary parts on axis -2 (JAX's ``normal(key, (2, n))``
    layout)."""
    s = math.sqrt(0.5)
    return torch.complex(normals[..., 0, :] * s, normals[..., 1, :] * s)


def _amplitude(noise_pow):
    """``sqrt(noise_pow)``, broadcast over the sample axis when it is a
    ``[...]`` tensor. A Python scalar stays on the host: turning it into a
    CUDA tensor would sync the stream."""
    if isinstance(noise_pow, torch.Tensor):
        amp = torch.sqrt(noise_pow.to(torch.float32))
        return amp[..., None] if amp.ndim else amp
    return math.sqrt(noise_pow)


def awgn(in_sig: torch.Tensor, snr_db, avg_sample_pow, noise: torch.Tensor
         ) -> torch.Tensor:
    """Add ``noise`` (unit complex normal, :func:`complex_normal`) at the
    given SNR against ``avg_sample_pow``; a ``[...]`` tensor of powers
    broadcasts against the signal's leading dims
    (``reference/noise.py:45-66``, SNR branch)."""
    noise_pow = avg_sample_pow / (10.0 ** (float(snr_db) / 10.0))
    return in_sig + noise * _amplitude(noise_pow)


def awgn_fixed_power(in_sig: torch.Tensor, noise_p_dbm, noise: torch.Tensor
                     ) -> torch.Tensor:
    """Add ``noise`` (unit complex normal) at a fixed power in dBm,
    ``0.001 * 10^(dBm/10)`` per complex sample (``reference/noise.py:59-60``).
    ``noise_p_dbm`` is a Python float or a ``[...]`` tensor that broadcasts
    against the signal's leading dims."""
    return in_sig + noise * _amplitude(0.001 * 10.0 ** (noise_p_dbm / 10.0))
