"""Monte-Carlo BER loop: batched rounds and host-side stop criteria
(port of ``mimo_ofdm_tpu/parallel/montecarlo.py``).

* A **round** simulates ``batch`` frames at once
  (:func:`mimo_ofdm_tpu_torch.models.link.make_round_fn`) and returns one
  int32 counter vector ``[clean_err, dist_err...]``, the layout of the
  reference's shared arrays (``reference/mp_model.py:132-134``).
* The **host** accumulates the counters between rounds and applies the
  per-iteration early exit (``reference/mp_model.py:181-187``) at round
  granularity: a counter stops accumulating once it has ``n_err_min``
  errors or ``bits_sent_max`` bits, and a sweep point stops when every
  counter has.

Rounds stay in flight on the CUDA stream: up to ``pipeline_depth`` are
enqueued before the oldest one's counters are fetched, and that ``.cpu()``
fetch of one small int32 vector is the loop's only sync. Each round's
contribution mask is fixed at launch, so at most ``pipeline_depth - 1``
rounds are counted past the stop point, the same staleness as the
reference's workers re-reading the shared counters without the lock.

Keys: a round is ``round_fn(key, idx, snr_db)``, and the round function
seeds its generator from ``round_seed(key, idx)``. A sweep point's key is
``round_seed(seed, i)``, the port's counterpart of ``fold_in(key, i)``.
"""

from __future__ import annotations

import time
from collections import deque
from dataclasses import dataclass, field

import numpy as np
import torch

from mimo_ofdm_tpu_torch.models.link import make_round_fn, round_seed
from mimo_ofdm_tpu_torch.ops.metrics import ebn0_to_snr
from mimo_ofdm_tpu_torch.utils.config import LinkConfig, SweepConfig


def _fetch_counters(counters) -> np.ndarray:
    """One round's counters as a host int64 ``[n_counters]`` vector. A
    flat round is one device-to-host copy, the sync point of the round."""
    if isinstance(counters, torch.Tensor):
        return counters.cpu().numpy().astype(np.int64)
    return np.concatenate([counters.clean_err.reshape(1).cpu().numpy(),
                           counters.dist_err.cpu().numpy()]).astype(np.int64)


@dataclass
class PointResult:
    """Counters for one sweep point (e.g. one Eb/N0 value)."""
    n_err: np.ndarray        # [n_counters] int64
    n_bits: np.ndarray       # [n_counters] int64
    n_rounds: int
    wall_time_s: float

    @property
    def ber(self) -> np.ndarray:
        return self.n_err / np.maximum(self.n_bits, 1)


@dataclass
class SweepResult:
    """BER vs swept parameter, reference CSV row convention
    (row 0 = swept param, following rows = metric per config;
    ``reference/docs/source/usage.rst:40-47``)."""
    param_values: np.ndarray
    points: list[PointResult] = field(default_factory=list)

    @property
    def ber_matrix(self) -> np.ndarray:
        """[n_counters, n_points]"""
        return np.stack([p.ber for p in self.points], axis=1)

    @property
    def frames_per_s(self) -> float:
        tot_t = sum(p.wall_time_s for p in self.points)
        tot_bits = sum(int(p.n_bits.max()) for p in self.points)
        return tot_bits / max(tot_t, 1e-9)


def run_point(round_fn, key: int, snr_db: float, *, n_counters: int,
              n_bits_per_frame: int, batch: int, n_err_min: int,
              bits_sent_max: int, max_rounds: int = 100_000,
              pipeline_depth: int = 3) -> PointResult:
    """Accumulate rounds ``round_fn(key, idx, snr_db)`` until every counter
    hit a stop criterion. Counter 0 is the clean run; counters 1.. are CNC
    passes 0..n_iters. Up to ``pipeline_depth`` rounds are in flight."""
    n_err = np.zeros(n_counters, np.int64)
    n_bits = np.zeros(n_counters, np.int64)
    t0 = time.perf_counter()
    launched = 0
    in_flight: deque = deque()

    def active_mask():
        return (n_err < n_err_min) & (n_bits < bits_sent_max)

    while True:
        while (launched < max_rounds and len(in_flight) < pipeline_depth
               and active_mask().any()):
            in_flight.append((round_fn(key, launched, snr_db), active_mask()))
            launched += 1
        if not in_flight:
            break
        counters, mask = in_flight.popleft()
        errs = _fetch_counters(counters)
        n_err += np.where(mask, errs, 0)
        n_bits += np.where(mask, batch * n_bits_per_frame, 0)
    return PointResult(n_err=n_err, n_bits=n_bits, n_rounds=launched,
                       wall_time_s=time.perf_counter() - t0)


def run_sweep_pipelined(round_fn, key: int, snr_db_values, *, n_counters: int,
                        n_bits_per_frame: int, batch: int, n_err_min: int,
                        bits_sent_max: int, max_rounds: int = 100_000,
                        pipeline_depth: int = 3) -> list[PointResult]:
    """:func:`run_point` over a sequence of sweep points, with the pipeline
    kept full ACROSS points: point ``k+1``'s first rounds are launched
    while point ``k``'s last ones are still being fetched. Point ``i``
    runs under key ``round_seed(key, i)``; its masks and staleness are
    those of :func:`run_point` on that key. Per-point ``wall_time_s`` spans
    first launch to last fetch and may overlap between adjacent points."""
    n_pts = len(snr_db_values)
    point_keys = [round_seed(key, i) for i in range(n_pts)]
    n_err = [np.zeros(n_counters, np.int64) for _ in range(n_pts)]
    n_bits = [np.zeros(n_counters, np.int64) for _ in range(n_pts)]
    launched = np.zeros(n_pts, np.int64)
    t_start = [None] * n_pts
    t_end = [0.0] * n_pts
    in_flight: deque = deque()
    launch_idx = 0

    def active_mask(i):
        return (n_err[i] < n_err_min) & (n_bits[i] < bits_sent_max)

    while True:
        while launch_idx < n_pts and (launched[launch_idx] >= max_rounds
                                      or not active_mask(launch_idx).any()):
            launch_idx += 1
        while len(in_flight) < pipeline_depth and launch_idx < n_pts:
            i = launch_idx
            if t_start[i] is None:
                t_start[i] = time.perf_counter()
            counters = round_fn(point_keys[i], int(launched[i]),
                                float(snr_db_values[i]))
            in_flight.append((i, counters, active_mask(i)))
            launched[i] += 1
            if launched[i] >= max_rounds:
                launch_idx += 1
        if not in_flight:
            break
        i, counters, mask = in_flight.popleft()
        errs = _fetch_counters(counters)
        n_err[i] += np.where(mask, errs, 0)
        n_bits[i] += np.where(mask, batch * n_bits_per_frame, 0)
        t_end[i] = time.perf_counter()
    return [PointResult(n_err=n_err[i], n_bits=n_bits[i],
                        n_rounds=int(launched[i]),
                        wall_time_s=t_end[i] - (t_start[i] or t_end[i]))
            for i in range(n_pts)]


def run_ber_sweep(cfg: LinkConfig, sweep: SweepConfig, n_iters: int,
                  seed: int = 0, snr_db_values: np.ndarray | None = None,
                  round_fn=None, verbose: bool = False,
                  device=None) -> SweepResult:
    """BER vs Eb/N0 sweep, the canonical workload
    (``reference/main_clipping_noise_cancellation/main_miso_cnc_ber_vs_ebn0.py:86-250``),
    on ``device`` (``cuda`` unless ``device="cpu"``)."""
    ebn0 = np.arange(sweep.ebn0_min, sweep.ebn0_max + sweep.ebn0_step / 2,
                     sweep.ebn0_step)
    if snr_db_values is None:
        # the reference's convention: the noise is referenced to the data
        # band only, SNR = Eb/N0 * log2(M)
        # (reference/main_clipping_noise_cancellation/main_miso_cnc_ber_vs_ebn0.py:99)
        snr_db_values = ebn0_to_snr(ebn0, cfg.modem.n_sub_carr,
                                    cfg.modem.n_sub_carr,
                                    cfg.modem.constel_size)
    if round_fn is None:
        round_fn = make_round_fn(cfg, n_iters, sweep.batch_frames,
                                 incl_clean=sweep.incl_clean_run,
                                 reroll=sweep.reroll_channel, flat=True,
                                 device=device)
    result = SweepResult(param_values=ebn0)
    result.points = run_sweep_pipelined(
        round_fn, seed, snr_db_values, n_counters=1 + n_iters + 1,
        n_bits_per_frame=cfg.modem.n_bits_per_ofdm_sym,
        batch=sweep.batch_frames, n_err_min=sweep.n_err_min,
        bits_sent_max=sweep.bits_sent_max)
    if verbose:
        for i, pt in enumerate(result.points):
            print(f"Eb/N0={ebn0[i]:5.1f} dB  rounds={pt.n_rounds:5d}  "
                  f"BER={np.array2string(pt.ber, precision=3)}")
    return result
