"""Antenna-array geometry as ``[n_ant, 3]`` position arrays
(port of ``mimo_ofdm_tpu/models/geometry.py``; NumPy float64 on the host)."""

from __future__ import annotations

import numpy as np

C_LIGHT = 299_792_458.0  # scipy.constants.c (reference/channel.py:61)


def ula_positions(n_elements: int, center_freq: float, wav_len_spacing: float = 0.5,
                  cord_x: float = 0.0, cord_y: float = 0.0,
                  cord_z: float = 0.0) -> np.ndarray:
    """Uniform linear array along X, centered at the origin and not offset
    by ``cord_x/y`` (``reference/antenna_array.py:428-445``)."""
    lam = C_LIGHT / center_freq
    half = (n_elements - 1) * wav_len_spacing * lam / 2.0
    x = np.linspace(-half, half, n_elements) if n_elements > 1 else np.zeros(1)
    return np.stack([x, np.zeros(n_elements), np.full(n_elements, cord_z)], axis=1)


def array_positions(geometry: str, n_elements: int, center_freq: float,
                    wav_len_spacing: float = 0.5, cord_z: float = 0.0,
                    n_rows: int = 1, n_cols: int = 1) -> np.ndarray:
    """Element positions of the configured array. Only the linear array is
    ported so far; the circular and planar arrays wait for a later slice."""
    if geometry == "linear":
        return ula_positions(n_elements, center_freq, wav_len_spacing, cord_z=cord_z)
    if geometry in ("circular", "planar"):
        raise NotImplementedError(
            f"{geometry!r} arrays are not ported yet (ROADMAP queue 1, item B)")
    raise ValueError(f"unknown array geometry {geometry!r}")
