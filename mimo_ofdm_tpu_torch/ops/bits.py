"""Bit packing/unpacking and bit-error counting
(port of ``mimo_ofdm_tpu/ops/bits.py``).

Bit order is MSB first within a symbol's bit group
(``reference/utilities.py:54-67``).
"""

from __future__ import annotations

import torch


def random_payload_bits(generator: torch.Generator,
                        shape: int | tuple[int, ...]) -> torch.Tensor:
    """IID fair payload bits as int8 on the generator's device, drawn as
    packed 32-bit words and unpacked LSB first (the JAX package's scheme;
    the stream itself differs from JAX's threefry stream)."""
    if isinstance(shape, int):
        shape = (shape,)
    n_bits = 1
    for s in shape:
        n_bits *= s
    n_words = (n_bits + 31) // 32
    dev = generator.device
    words = torch.randint(-2 ** 31, 2 ** 31, (n_words,), generator=generator,
                          device=dev, dtype=torch.int32)
    shifts = torch.arange(32, device=dev, dtype=torch.int32)
    b = (words[:, None] >> shifts) & 1
    return b.reshape(-1)[:n_bits].to(torch.int8).reshape(shape)


def bits_to_ints(bits: torch.Tensor, bits_per_word: int) -> torch.Tensor:
    """Pack groups of ``bits_per_word`` bits (MSB first) into int32
    ``[..., n_words]`` (``reference/modulation.py:22-24``)."""
    *lead, n = bits.shape
    if n % bits_per_word:
        raise ValueError(f"bit count {n} not divisible by {bits_per_word}")
    grouped = bits.reshape(*lead, n // bits_per_word, bits_per_word).to(torch.int32)
    weights = 1 << torch.arange(bits_per_word - 1, -1, -1, device=bits.device,
                                dtype=torch.int32)
    return (grouped * weights).sum(-1, dtype=torch.int32)


def ints_to_bits(ints: torch.Tensor, bits_per_word: int) -> torch.Tensor:
    """Unpack integers into int8 bits ``[..., n_words * bits_per_word]``,
    MSB first (``reference/utilities.py:18-51``)."""
    shifts = torch.arange(bits_per_word - 1, -1, -1, device=ints.device,
                          dtype=ints.dtype)
    bits = (ints[..., None] >> shifts) & 1
    return bits.reshape(*ints.shape[:-1],
                        ints.shape[-1] * bits_per_word).to(torch.int8)


def count_bit_errors(tx_bits: torch.Tensor, rx_bits: torch.Tensor,
                     axis=None) -> torch.Tensor:
    """Number of mismatched bits as int32 (``reference/utilities.py:95-104``)."""
    diff = torch.bitwise_xor(tx_bits.to(torch.int32), rx_bits.to(torch.int32))
    if axis is None:
        return diff.sum(dtype=torch.int32)
    return diff.sum(axis, dtype=torch.int32)


def gray_encode(x: torch.Tensor) -> torch.Tensor:
    """Binary-reflected Gray code ``x ^ (x >> 1)``
    (``reference/modulation.py:112``)."""
    return torch.bitwise_xor(x, x >> 1)
