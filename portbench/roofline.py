"""The fused chain's work a round, counted from the configuration, and the
card's published peaks: the yardstick of ``kernel.fused_pa_roofline``.

The counts do not depend on what implements the chain:

* rows (``models/link_mu.py``'s docstring has the multi-user counts): each
  frame sends its ``n_ant`` antenna rows through the chain once for the
  distorted TX (the users' signals are summed before the chain), then the
  receiver runs one replica a pass for ``n_iters + 1`` passes: CNC and
  CNC-MU one row a user a pass (the nominal PA), single-user MCNC all
  ``n_ant`` rows a pass (the whole array), MCNC-MU ``n_users x n_ant`` rows
  a pass;
* bytes: each row reads its ``n_sc`` data points and writes ``n_sc``, at the
  configuration's storage (bf16: 4 B a complex point, float32: 8 B), plus
  8 B a row (its saturation power and cubic coefficient). The multi-user
  frame hands the chain interleaved complex64 at 8 B a point where its
  storage is bf16; the count stays at the storage's 4 B, so that frame's
  share shows the gap its wider I/O costs;
* operations: ``5 n log2 n`` for each of the row's two ``n_fft``-point
  transforms;
* least time: ``max(bytes / HBM bandwidth, operations / peak)``, the peak of
  the configuration's arithmetic: bf16 products with float32 sums on the
  tensor cores (989 TFLOP/s), or float32 (67 TFLOP/s).

Peaks: NVIDIA H100 SXM data sheet, dense, at the full 700 W.
"""

from __future__ import annotations

import math

HBM_BYTES_PER_S = 3.35e12
PEAK_FLOPS = {"bfloat16": 989e12, "float32": 67e12}
POINT_BYTES = {"bfloat16": 4, "float32": 8}
ROW_PARAM_BYTES = 8


def rows_per_frame(receiver: str, n_ant: int, n_iters: int, n_users: int = 1) -> int:
    """Chain rows a frame: the TX's ``n_ant``, then the replica passes."""
    passes = n_iters + 1
    if receiver in ("cnc", "cnc_mu"):
        return n_ant + passes * n_users
    if receiver == "mcnc" and n_users == 1:
        return n_ant + passes * n_ant
    if receiver == "mcnc_mu":
        return n_ant + passes * n_users * n_ant
    raise ValueError(f"no chain row count for receiver {receiver!r} of {n_users} users")


def row_flops(n_fft: int) -> float:
    """Two ``n_fft``-point transforms at ``5 n log2 n`` operations each."""
    return 2 * 5 * n_fft * math.log2(n_fft)


def row_bytes(n_sc: int, storage: str) -> int:
    """``n_sc`` points in and ``n_sc`` out at ``storage``, plus the row's parameters."""
    return 2 * n_sc * POINT_BYTES[storage] + ROW_PARAM_BYTES


def least_seconds(rows: int, n_fft: int, n_sc: int, storage: str) -> tuple[float, str]:
    """The least time of ``rows`` chain rows, and which term bounds it."""
    t_bytes = rows * row_bytes(n_sc, storage) / HBM_BYTES_PER_S
    t_ops = rows * row_flops(n_fft) / PEAK_FLOPS[storage]
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def round_least_seconds(link: dict, traffic: dict) -> float:
    """The least time of one round's chain rows for a configuration
    (``link``, the port's configuration as a dict) and a traffic mix."""
    rows = traffic["frames_per_round"] * rows_per_frame(
        traffic["receiver"], link["array"]["n_elements"], link["rx"]["max_cnc_iters"],
        link["modem"]["n_users"])
    return least_seconds(rows, link["modem"]["n_fft"], link["modem"]["n_sub_carr"],
                         link["mxu_fft_storage"])[0]
