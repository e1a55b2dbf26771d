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


def uca_positions(n_elements: int, center_freq: float, wav_len_spacing: float = 0.5,
                  cord_z: float = 0.0) -> np.ndarray:
    """Uniform circular (semicircular) array on the X-Y plane
    (``reference/antenna_array.py:461-479``): radius ``lambda (n-1) / (2 pi)``,
    points on a semicircumference (``reference/utilities.py:158-167``)."""
    lam = C_LIGHT / center_freq
    radius = lam * (n_elements - 1) / (2.0 * np.pi)
    ang = np.pi / n_elements * np.arange(n_elements)
    return np.stack([np.cos(ang) * radius, np.sin(ang) * radius,
                     np.full(n_elements, cord_z)], axis=1)


def ura_positions(n_rows: int, n_cols: int, center_freq: float,
                  wav_len_spacing: float = 0.5, cord_z: float = 0.0) -> np.ndarray:
    """Uniform rectangular array on the X-Z plane
    (``reference/antenna_array.py:496-520``): ``n_cols`` elements per row
    along X, ``n_rows`` per column along Z, X outer and Z inner."""
    lam = C_LIGHT / center_freq
    col_half = (n_rows - 1) * wav_len_spacing * lam / 2.0
    row_half = (n_cols - 1) * wav_len_spacing * lam / 2.0
    z = np.linspace(-col_half, col_half, n_rows) if n_rows > 1 else np.zeros(1)
    x = np.linspace(-row_half, row_half, n_cols) if n_cols > 1 else np.zeros(1)
    xg, zg = np.meshgrid(x, z, indexing="ij")
    xs, zs = xg.ravel(), zg.ravel()
    return np.stack([xs, np.zeros_like(xs), cord_z + zs], axis=1)


def array_positions(geometry: str, n_elements: int, center_freq: float,
                    wav_len_spacing: float = 0.5, cord_z: float = 0.0,
                    n_rows: int = 1, n_cols: int = 1) -> np.ndarray:
    """Element positions of the configured array."""
    if geometry == "linear":
        return ula_positions(n_elements, center_freq, wav_len_spacing, cord_z=cord_z)
    if geometry == "circular":
        return uca_positions(n_elements, center_freq, wav_len_spacing, cord_z=cord_z)
    if geometry == "planar":
        return ura_positions(n_rows, n_cols, center_freq, wav_len_spacing, cord_z=cord_z)
    raise ValueError(f"unknown array geometry {geometry!r}")


def pts_on_circum(radius: float, n_points: int = 100) -> np.ndarray:
    """``n_points + 1`` points anticlockwise on a circle
    (``reference/utilities.py:146-155``)."""
    ang = 2.0 * np.pi / n_points * np.arange(n_points + 1)
    return np.stack([np.cos(ang) * radius, np.sin(ang) * radius], axis=1)


def pts_on_semicircum(radius: float, n_points: int = 100) -> np.ndarray:
    """``n_points + 1`` points on a semicircle, angle 0 to pi
    (``reference/utilities.py:158-167``)."""
    ang = np.pi / n_points * np.arange(n_points + 1)
    return np.stack([np.cos(ang) * radius, np.sin(ang) * radius], axis=1)


def pts_on_semisphere(radius: float, n_points: int = 100,
                      center=(0.0, 0.0, 0.0)) -> np.ndarray:
    """An azimuth x elevation grid of ``int(sqrt(n_points))**2`` points on a
    semisphere, azimuth outer (``reference/utilities.py:170-192``)."""
    n = int(np.sqrt(n_points))
    az = np.deg2rad(np.linspace(0, 180, n, endpoint=True))
    el = np.deg2rad(np.linspace(0, 180, n, endpoint=True))
    pts = [(-radius * np.sin(e) * np.cos(a) + center[0],
            -radius * np.sin(e) * np.sin(a) + center[1],
            -radius * np.cos(e) + center[2]) for a in az for e in el]
    return np.asarray(pts)
