"""Complex AWGN (port of ``mimo_ofdm_tpu/ops/noise.py``).

The noise convention is the reference's ``Awgn.process``
(``reference/noise.py:45-66``): per-complex-sample noise power
``avg_sample_pow / 10^(snr_db/10)``. The caller supplies the unit normals,
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


def awgn(in_sig: torch.Tensor, snr_db, avg_sample_pow, noise: torch.Tensor
         ) -> torch.Tensor:
    """Add ``noise`` (unit complex normal, :func:`complex_normal`) at the
    given SNR against ``avg_sample_pow``; a ``[...]`` tensor of powers
    broadcasts against the signal's leading dims
    (``reference/noise.py:45-66``, SNR branch). Python scalars stay on the
    host: turning them into CUDA tensors would sync the stream."""
    noise_pow = avg_sample_pow / (10.0 ** (float(snr_db) / 10.0))
    if isinstance(noise_pow, torch.Tensor):
        amp = torch.sqrt(noise_pow.to(torch.float32))
        amp = amp[..., None] if amp.ndim else amp
    else:
        amp = math.sqrt(noise_pow)
    return in_sig + noise * amp
