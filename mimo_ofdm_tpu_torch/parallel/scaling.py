"""Weak-scaling harness of the sharded Monte-Carlo round (port of
``mimo_ofdm_tpu/parallel/scaling.py``; BASELINE.md's target: over 80%
frames/s scaling efficiency).

Frames/s of the round on growing ``dp`` meshes with a fixed batch per
device; efficiency = throughput(N) / (N * throughput(1)). Every rank draws
the round's global frames (``parallel/sharded.py``), so each rank's draw
work grows with N: the sweep records each rank's draw milliseconds a round
beside the frames/s, so that a falling efficiency can be read.
"""

from __future__ import annotations

import math
import time

import torch
import torch.distributed as dist

from mimo_ofdm_tpu_torch.parallel.collectives import all_reduce_max_int
from mimo_ofdm_tpu_torch.parallel.sharded import make_mesh, make_sharded_round_fn
from mimo_ofdm_tpu_torch.utils.config import LinkConfig
from mimo_ofdm_tpu_torch.utils.device import resolve_device


def measure_round_throughput(round_fn, batch: int, key: int = 0, snr_db: float = 22.0,
                             min_seconds: float = 5.0, group=None) -> float:
    """Frames/s of ``round_fn`` with one host sync a round (the ``.cpu()``
    fetch of its counters, as the Monte-Carlo loop does). The number of
    timed rounds comes from a warm round's time, agreed over ``group``
    (the largest rank's), so that every rank runs the same rounds and
    their collectives pair up."""
    def run(idx: int) -> None:
        round_fn(key, idx, snr_db).cpu()

    run(0)                                  # warm-up: allocator, kernel build
    t0 = time.perf_counter()
    run(1)
    n = all_reduce_max_int(max(1, math.ceil(min_seconds / (time.perf_counter() - t0))),
                           group)
    t0 = time.perf_counter()
    for i in range(n):
        run(2 + i)
    return n * batch / (time.perf_counter() - t0)


def draw_ms(round_fn, dev: torch.device, reps: int = 3) -> float:
    """Milliseconds this rank spends drawing one round's global frames."""
    def sync():
        if dev.type == "cuda":
            torch.cuda.synchronize(dev)

    round_fn.draw(0, 0)
    sync()
    t0 = time.perf_counter()
    for i in range(reps):
        round_fn.draw(0, 1 + i)
    sync()
    return (time.perf_counter() - t0) / reps * 1e3


def weak_scaling_sweep(cfg: LinkConfig, n_iters: int = 8, batch_per_device: int = 128,
                       device_counts: list[int] | None = None, n_tp: int = 1,
                       snr_db: float = 22.0, verbose: bool = True,
                       min_seconds: float = 5.0, device=None) -> dict:
    """Frames/s, efficiency and each rank's draw ms vs the ``dp`` size, on
    the first ``d * n_tp`` ranks of the running job for each ``d`` of
    ``device_counts`` (default: 1, 2, 4, ... up to the job's size; without
    a process group, one process). Every rank of the job calls it: each
    ``d`` builds its mesh from a subgroup that every rank creates in the
    same order, and the ranks outside it wait. Returns ``{d: {...}}`` on
    every rank, as rank 0 measured it."""
    dev = resolve_device(device)
    world = dist.get_world_size() if dist.is_initialized() else 1
    if device_counts is None:
        device_counts = [d for d in (1, 2, 4, 8, 16, 32) if d * n_tp <= world]
    results, base = {}, None
    for d in device_counts:
        mesh = make_mesh(n_dp=d, n_tp=n_tp, ranks=range(d * n_tp))
        if not mesh.member:
            continue
        batch = batch_per_device * d
        rf = make_sharded_round_fn(cfg, n_iters, batch, mesh, device=dev)
        fps = measure_round_throughput(rf, batch, 0, snr_db, min_seconds, mesh.group)
        ms = draw_ms(rf, dev)
        per_rank = [ms]
        if mesh.group is not None:
            per_rank = [None] * dist.get_world_size(mesh.group)
            dist.all_gather_object(per_rank, ms, group=mesh.group)
        if base is None:
            base = fps
        results[d] = {"frames_per_s": fps, "efficiency": fps / (base * d),
                      "draw_ms_per_rank": per_rank}
        if verbose and (not dist.is_initialized() or dist.get_rank() == 0):
            print(f"dp={d:3d} (x{n_tp}tp): {fps:10.1f} frames/s  "
                  f"efficiency={results[d]['efficiency'] * 100:5.1f}%  "
                  f"draw ms/round per rank={per_rank}")
    if dist.is_initialized() and world > 1:
        box = [results]
        dist.broadcast_object_list(box, src=0)
        results = box[0]
    return results
