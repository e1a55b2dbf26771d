"""Spatial/array configuration plots (port of
``mimo_ofdm_tpu/utils/spatial_plot.py``; ``reference/utilities.py:195-308``
``plot_spatial_config`` / ``plot_array_config``), taking position arrays
instead of object trees. matplotlib is imported inside the functions
only."""

from __future__ import annotations

import numpy as np


def plot_spatial_config(tx_pos: np.ndarray, rx_pos: np.ndarray | None = None,
                        rx_points: np.ndarray | None = None,
                        plot_3d: bool = True, save_path: str | None = None,
                        show: bool = False):
    """TX array + RX positions scatter (``reference/utilities.py:195-275``).

    ``tx_pos``: ``[n_ant, 3]``; ``rx_pos``: ``[3]``; ``rx_points``:
    ``[n_pts, 3]``."""
    import matplotlib.pyplot as plt

    tx_pos = np.asarray(tx_pos)
    if plot_3d:
        fig = plt.figure()
        ax = fig.add_subplot(projection="3d")
        ax.scatter(tx_pos[:, 0], tx_pos[:, 1], tx_pos[:, 2], color="C0",
                   marker="^", label="TX")
        if rx_pos is not None:
            center = tx_pos.mean(axis=0)
            ax.plot([center[0], rx_pos[0]], [center[1], rx_pos[1]],
                    [center[2], rx_pos[2]], color="C2", linestyle="--",
                    label="LOS")
            ax.scatter(*rx_pos, color="C1", marker="o", label="RX")
        if rx_points is not None:
            rx_points = np.asarray(rx_points)
            ax.scatter(rx_points[:, 0], rx_points[:, 1], rx_points[:, 2],
                       color="C1", marker="o", label="RX")
        ax.set_xlabel("X plane [m]")
        ax.set_ylabel("Y plane [m]")
        ax.set_zlabel("Z plane [m]")
    else:
        fig, ax = plt.subplots()
        ax.scatter(tx_pos[:, 0], tx_pos[:, 1], color="C0", marker="^",
                   label="TX")
        if rx_pos is not None:
            center = tx_pos.mean(axis=0)
            ax.plot([center[0], rx_pos[0]], [center[1], rx_pos[1]],
                    color="C2", linestyle="--")
            ax.scatter(rx_pos[0], rx_pos[1], color="C1", marker="o", label="RX")
        ax.set_xlabel("X plane [m]")
        ax.set_ylabel("Y plane [m]")
        ax.set_aspect("equal", "box")
    ax.set_title("TX RX spatial configuration")
    ax.grid(True)
    ax.legend()
    fig.tight_layout()
    if save_path:
        fig.savefig(save_path, dpi=600, bbox_inches="tight")
    if show:
        plt.show()
    return fig, ax


def plot_array_config(tx_pos: np.ndarray, plot_3d: bool = False,
                      save_path: str | None = None, show: bool = False):
    """Antenna-array layout scatter (``reference/utilities.py:278-308``)."""
    import matplotlib.pyplot as plt

    tx_pos = np.asarray(tx_pos)
    if plot_3d:
        fig = plt.figure()
        ax = fig.add_subplot(projection="3d")
        ax.scatter(tx_pos[:, 0], tx_pos[:, 1], tx_pos[:, 2], color="C0",
                   marker="^")
        ax.set_zlabel("Z plane [m]")
    else:
        fig, ax = plt.subplots()
        ax.scatter(tx_pos[:, 0], tx_pos[:, 2] if np.ptp(tx_pos[:, 1]) == 0
                   else tx_pos[:, 1], color="C0", marker="^")
    ax.set_title("Antenna array")
    ax.set_xlabel("X plane [m]")
    ax.set_ylabel("Y plane [m]")
    ax.grid(True)
    fig.tight_layout()
    if save_path:
        fig.savefig(save_path, dpi=600, bbox_inches="tight")
    if show:
        plt.show()
    return fig, ax
