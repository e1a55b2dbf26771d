"""Square-QAM constellation, Gray mapping, modulation and hard detection
(port of ``mimo_ofdm_tpu/ops/qam.py``).

* The constellation is the reference's column snake of PAM levels,
  remapped by binary-reflected Gray code, so ``constellation[b]`` is the
  symbol of the MSB-first bit pattern ``b`` (``reference/modulation.py:110-114,239-242``).
* Hard detection is the O(1) per-axis PAM quantizer, exact for square
  Gray-snake QAM, in place of the reference's O(M) distance argmin
  (``reference/modulation.py:76,145``).

All functions accept arbitrary leading batch dimensions.
"""

from __future__ import annotations

import functools

import numpy as np
import torch

from mimo_ofdm_tpu_torch.ops.bits import bits_to_ints, gray_encode, ints_to_bits
from mimo_ofdm_tpu_torch.utils.spans import spanned


@functools.lru_cache(maxsize=None)
def _constellation_np(constel_size: int) -> np.ndarray:
    """Gray-mapped square-QAM constellation as a host complex128 array."""
    n = int(np.sqrt(constel_size))
    if n * n != constel_size:
        raise ValueError("only square QAM supported (constel_size must be a perfect square)")
    pam = np.arange(-n + 1, n, 2)
    snake = np.tile(np.hstack((pam, pam[::-1])), n // 2) * 1j + pam.repeat(n)
    gray = np.arange(constel_size) ^ (np.arange(constel_size) >> 1)
    return snake[gray.argsort()].astype(np.complex128)


@functools.lru_cache(maxsize=None)
def _constellation(constel_size: int, device: torch.device,
                   dtype: torch.dtype) -> torch.Tensor:
    return torch.as_tensor(_constellation_np(constel_size), dtype=dtype,
                           device=device)


def qam_constellation(constel_size: int, device=None,
                      dtype=torch.complex64) -> torch.Tensor:
    """Gray-mapped square-QAM constellation indexed by bit pattern."""
    return _constellation(constel_size, torch.device(device or "cpu"), dtype)


def avg_symbol_power(constel_size: int) -> float:
    """Mean constellation symbol power, e.g. 42.0 for 64-QAM
    (``reference/modulation.py:218``)."""
    c = _constellation_np(constel_size)
    return float(np.mean(np.abs(c) ** 2))


def bits_per_symbol(constel_size: int) -> int:
    b = int(np.log2(constel_size))
    if 2 ** b != constel_size:
        raise ValueError("constellation size must be a power of 2")
    return b


def modulate_bits(bits: torch.Tensor, constel_size: int,
                  dtype=torch.complex64) -> torch.Tensor:
    """Map bits ``[..., n_sym * bps]`` (MSB first) to symbols ``[..., n_sym]``
    (``reference/modulation.py:13-25``)."""
    idx = bits_to_ints(bits, bits_per_symbol(constel_size))
    return qam_constellation(constel_size, bits.device, dtype)[idx.long()]


def _pam_quantize(x: torch.Tensor, n: int) -> torch.Tensor:
    """Nearest index of the PAM grid ``-(n-1), .., (n-1)`` (step 2),
    clipped to the grid edges; ties round half to even, as in JAX."""
    idx = torch.round((x + (n - 1)) * 0.5)
    return torch.clamp(idx, 0, n - 1).to(torch.int32)


def hard_detect_index(symbols: torch.Tensor, constel_size: int,
                      alpha: torch.Tensor | float = 1.0) -> torch.Tensor:
    """Nearest-constellation-point detection, returning the int32
    bit-pattern index. ``alpha`` shrinks the grid (Bussgang-corrected
    detection, ``reference/modulation.py:167-176``)."""
    n = int(np.sqrt(constel_size))
    y = symbols if isinstance(alpha, float) and alpha == 1.0 else symbols / alpha
    r = _pam_quantize(y.real, n)
    i = _pam_quantize(y.imag, n)
    # column snake: odd real-index columns run the imag index backwards
    c = torch.where(r % 2 == 0, i, n - 1 - i)
    return gray_encode(n * r + c)


def demodulate_bits(symbols: torch.Tensor, constel_size: int,
                    alpha: torch.Tensor | float = 1.0) -> torch.Tensor:
    """Hard demodulation to bits ``[..., n_sym * bps]``
    (``reference/modulation.py:63-77``)."""
    idx = hard_detect_index(symbols, constel_size, alpha)
    return ints_to_bits(idx, bits_per_symbol(constel_size))


def _points(idx: torch.Tensor, constel_size: int, alpha, dtype) -> torch.Tensor:
    """The ``alpha``-scaled constellation points of bit-pattern indices."""
    sym = qam_constellation(constel_size, idx.device, dtype)[idx.long()]
    return sym if isinstance(alpha, float) and alpha == 1.0 else sym * alpha


def hard_detect_symbols(symbols: torch.Tensor, constel_size: int,
                        alpha: torch.Tensor | float = 1.0,
                        dtype=torch.complex64) -> torch.Tensor:
    """Hard symbol detection returning the ``alpha``-scaled constellation
    points, as the reference detects against the scaled constellation
    (``reference/modulation.py:138-146``)."""
    return _points(hard_detect_index(symbols, constel_size, alpha), constel_size,
                   alpha, dtype)


def detect_symbols_and_bits(symbols: torch.Tensor, constel_size: int,
                            alpha: torch.Tensor | float = 1.0,
                            dtype=torch.complex64
                            ) -> tuple[torch.Tensor, torch.Tensor]:
    """Hard detection returning both the ``alpha``-scaled constellation
    points and the bits, from one quantization
    (``reference/corrector.py:78-82``)."""
    idx = hard_detect_index(symbols, constel_size, alpha)
    return (_points(idx, constel_size, alpha, dtype),
            ints_to_bits(idx, bits_per_symbol(constel_size)))


def hard_detect_index_argmin(symbols: torch.Tensor,
                             constellation: torch.Tensor) -> torch.Tensor:
    """The reference's O(M) minimum-distance detection
    (``reference/modulation.py:76``) against any constellation ``[M]``,
    returning int32 indices; it cross-checks :func:`hard_detect_index` and
    takes non-square constellations. Ties go to the first index."""
    d2 = (symbols[..., None] - constellation).abs() ** 2
    return torch.argmin(d2, dim=-1).to(torch.int32)


@functools.lru_cache(maxsize=None)
def _bit_halves(constel_size: int, device: torch.device) -> tuple[torch.Tensor, torch.Tensor]:
    """``(ones, zeros)``, each ``[bps, M/2]``: the bit patterns whose bit
    ``k`` (MSB first) is 1, and those where it is 0, in increasing order."""
    bps = bits_per_symbol(constel_size)
    b_idx = np.arange(constel_size)
    mask = ((b_idx[None, :] >> (bps - 1 - np.arange(bps)[:, None])) & 1).astype(bool)
    ones = np.stack([b_idx[m] for m in mask])
    zeros = np.stack([b_idx[~m] for m in mask])
    return (torch.as_tensor(ones, device=device), torch.as_tensor(zeros, device=device))


@spanned("soft_demap")
def soft_llr(symbols: torch.Tensor, constel_size: int, noise_var,
             alpha: torch.Tensor | float = 1.0) -> torch.Tensor:
    """Exact per-bit log-likelihood ratios, MSB-first, positive = bit 1
    (``mimo_ofdm_tpu/ops/qam.py:149-177``, ``reference/modulation.py:30-59``):
    ``llr[k] = log sum_{b: bit k = 1} e^{-|y - s_b|^2 / nv} - log sum_{b: bit
    k = 0} e^{-|y - s_b|^2 / nv}``, each through log-sum-exp.

    JAX masks a ``[..., n_sym, bps, M]`` tensor; here each bit gathers the
    two ``M/2``-point halves, ``[..., n_sym, bps, M/2]``: the same terms in
    the same sets, in a quarter of the memory. ``noise_var`` (a Python
    float or a tensor) broadcasts against ``symbols``; returns ``[...,
    n_sym * bps]`` float32."""
    constellation = qam_constellation(constel_size, symbols.device)
    if not (isinstance(alpha, float) and alpha == 1.0):
        constellation = constellation * alpha
    if isinstance(noise_var, torch.Tensor):
        noise_var = noise_var[..., None]
    neg_d2 = -(torch.abs(symbols[..., None] - constellation) ** 2) / noise_var
    ones, zeros = _bit_halves(constel_size, symbols.device)
    num = torch.logsumexp(neg_d2[..., ones], dim=-1)          # [..., n_sym, bps]
    den = torch.logsumexp(neg_d2[..., zeros], dim=-1)
    return (num - den).flatten(-2)
