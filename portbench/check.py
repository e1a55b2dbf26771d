"""The comparison that decides ``correct``: the program's per-frame
counters against the plain reference's on the same frames.

A frame's answer is its bit-error counters ``[clean, pass 0 .. pass n]``.
Planes stored in a lower precision move a few symbols across a decision
boundary, so a frame's count moves by about the square root of the bits
that flip. The numbers are normalised by the reference's errors (plus one,
so that an error-free pass does not divide by 0):

* ``gap_sq_first``: over the frames' clean run and first pass (channel,
  precoder, AGC, noise, the distorted TX through the chain, detection),
  the sum of ``(program - reference)^2`` over the sum of ``reference + 1``,
  about the bits flipped per error;
* ``gap_sq_passes``: the same over the receiver's later passes, each after
  a CNC or MCNC replica;
* ``ber_gap``: over the counters, the widest ``|sum(program) -
  sum(reference)| / sum(reference + 1)`` of the sample, the gap of the
  sample's BER.

Each cell's ``limits/<cell>.json`` says which of them are compared, each
with its limit and the readings it was set from.

The control, which the limits have to refuse, is the plain reference put
in the program's place and computed one precision below the one the
configuration states for its chain (:func:`control_planes`).
"""

from __future__ import annotations

import numpy as np


CONTROL_PLANES = {"bfloat16": "float8_e4m3fn", "float32": "bfloat16"}


def control_planes(link: dict) -> str:
    """The control's precision: the one below the configuration's chain
    storage (``mxu_fft_storage``)."""
    return CONTROL_PLANES[link["mxu_fft_storage"]]


def gap_sq(p: np.ndarray, r: np.ndarray) -> float:
    """Sum of ``(p - r)^2`` over the sum of ``r + 1``."""
    return float(((p - r) ** 2).sum() / (r + 1).sum())


def _ber_gap(p: np.ndarray, r: np.ndarray) -> float:
    return float((np.abs((p - r).sum(0)) / (r + 1).sum(0)).max())


def numbers(program: np.ndarray, reference: np.ndarray) -> dict[str, float]:
    """The comparison's numbers for ``[frames, counters]`` integer arrays
    whose counters are ``[clean, pass 0, pass 1 ..]``."""
    p = np.asarray(program, np.float64)
    r = np.asarray(reference, np.float64)
    if p.shape != r.shape or p.size == 0:
        raise ValueError(f"counters of shape {p.shape} against {r.shape}")
    return {
        "gap_sq_first": gap_sq(p[:, :2], r[:, :2]),
        "gap_sq_passes": gap_sq(p[:, 2:], r[:, 2:]),
        "ber_gap": _ber_gap(p, r),
    }


def per_counter(program: np.ndarray, reference: np.ndarray) -> dict[str, list[float]]:
    """Each counter apart, for reading where a gap comes from: its
    ``gap_sq_mean`` and its signed BER gap."""
    p = np.asarray(program, np.float64)
    r = np.asarray(reference, np.float64)
    return {"gap_sq_mean": (((p - r) ** 2).sum(0) / (r + 1).sum(0)).tolist(),
            "ber_gap_signed": ((p - r).sum(0) / (r + 1).sum(0)).tolist()}


def judge(found: dict[str, float], limits: dict) -> tuple[bool, dict]:
    """``(correct, checks)``: every compared number at or under its limit;
    ``checks`` maps each to ``{"value", "limit"}``."""
    checks = {k: {"value": found[k], "limit": v["limit"]} for k, v in limits.items()}
    ok = all(np.isfinite(c["value"]) and c["value"] <= c["limit"] for c in checks.values())
    return ok, checks
